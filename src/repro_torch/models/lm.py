"""LM backbone of the paged serve path (port of the serve subset of
``repro.models.lm`` for dense ``attn`` blocks).

Params stay stacked ``[n_layers, ...]`` per segment as in JAX; a Python
loop over layers replaces ``_segment_scan_cached``.  Differences from
JAX, on purpose:

- the paged pools are updated IN PLACE (``prefill_chunk`` and
  ``decode_step_paged`` write the caches they are given and return the
  same objects), where JAX returns new arrays;
- ``prefill_chunk`` takes ``start`` and ``last`` as Python ints (no
  trace to keep shape-stable).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from repro_torch.kernels import paged as paged_kernels
from repro_torch.models import attention as attn
from repro_torch.models import nn


@dataclasses.dataclass(frozen=True)
class Segment:
    pattern: Tuple[str, ...]
    n: int


def segments_for(cfg) -> List[Segment]:
    """Dense families only: one segment of ``attn`` blocks."""
    if cfg.family not in ("dense", "vlm"):
        raise ValueError(f"family {cfg.family!r} is not ported")
    return [Segment(("attn",), cfg.n_layers)]


def init_ffn(gen, cfg, device="cuda"):
    d, f = cfg.d_model, cfg.d_ff
    p = {"wi": nn.init_serve_linear(gen, d, f, cfg, device=device)}
    if cfg.act == "swiglu":
        p["wg"] = nn.init_serve_linear(gen, d, f, cfg, device=device)
    p["wo"] = nn.init_serve_linear(gen, f, d, cfg, device=device)
    return p


def ffn_apply(params, x, cfg, apply_fn):
    pair_apply = getattr(apply_fn, "pair_apply", None)
    if (pair_apply is not None and cfg.serve_shared_act_quant
            and "wg" in params):
        h, g = pair_apply(params["wi"], params["wg"], x, cfg)
        h = h * torch.nn.functional.silu(g)
    else:
        h = apply_fn(params["wi"], x, cfg)
        if "wg" in params:
            h = h * torch.nn.functional.silu(apply_fn(params["wg"], x, cfg))
        else:
            h = torch.nn.functional.gelu(h)
    return apply_fn(params["wo"], h, cfg)


def init_block(gen, kind: str, cfg, device="cuda"):
    if kind != "attn":
        raise ValueError(f"block kind {kind!r} is not ported")
    return {
        "norm1": nn.init_rmsnorm(cfg.d_model, device),
        "attn": attn.init_gqa(gen, cfg, device),
        "norm2": nn.init_rmsnorm(cfg.d_model, device),
        "ffn": init_ffn(gen, cfg, device),
    }


def apply_block(kind: str, params, x, cfg, apply_fn, cache, paged_ctx,
                decode: bool):
    """Paged branch of the JAX ``apply_block`` plus its shared tail.
    ``paged_ctx``: ``{'block_table', 'positions'}`` for decode,
    ``{'block_table', 'start'}`` for a prefill chunk."""
    if kind != "attn":
        raise ValueError(f"block kind {kind!r} is not ported")
    h = nn.rmsnorm_apply(params["norm1"], x)
    if decode:
        y, kv = attn.gqa_decode_paged(
            params["attn"], h, cfg, cache, paged_ctx["block_table"],
            paged_ctx["positions"], apply_fn=apply_fn)
    else:
        y, kv = attn.gqa_prefill_chunk(
            params["attn"], h, cfg, cache, paged_ctx["block_table"],
            paged_ctx["start"], apply_fn=apply_fn)
    x = x + y
    hf = nn.rmsnorm_apply(params["norm2"], x)
    return x + ffn_apply(params["ffn"], hf, cfg, apply_fn), kv


def _stack(trees):
    """``jax.vmap``-style stacking of per-layer dicts into [n, ...]."""
    first = trees[0]
    return {k: _stack([t[k] for t in trees]) if isinstance(first[k], dict)
            else torch.stack([t[k] for t in trees]) for k in first}


def init_lm(cfg, gen: torch.Generator, purpose: str = "serve",
            device="cuda") -> nn.ParamTree:
    """Serve params with random TLMAC plans drawn from ``gen`` (a
    generator on ``device``).  Returns a ``ParamTree``."""
    if purpose != "serve":
        raise ValueError("only the serve path is ported")
    p = {"embed": nn.init_embedding(gen, cfg.vocab, cfg.d_model, device)}
    if not cfg.tie_embeddings:
        p["head"] = nn.init_embedding(gen, cfg.vocab, cfg.d_model, device)
    p["final_norm"] = nn.init_rmsnorm(cfg.d_model, device)
    segs = []
    for seg in segments_for(cfg):
        layers = [{f"b{bi}": init_block(gen, kind, cfg, device)
                   for bi, kind in enumerate(seg.pattern)}
                  for _ in range(seg.n)]
        segs.append(_stack(layers))
        del layers
    p["segments"] = segs
    return nn.ParamTree(p)


def init_caches(cfg, paged: paged_kernels.PageSpec, device="cuda"):
    """Stacked paged pools per segment: ``[{'b0': {'k', 'v'[, 'ks',
    'vs']}}]`` with leaves ``[n_layers, n_pages, P, KV, hd]``."""
    qs = paged_kernels.qspec_for(cfg)
    return [{f"b{bi}": paged_kernels.zero_kv_pool(
                paged, cfg.n_kv, cfg.kv_head_dim, qs, n_layers=seg.n,
                device=device)
             for bi, _ in enumerate(seg.pattern)}
            for seg in segments_for(cfg)]


def _run_layers(params, caches, x, cfg, paged_ctx, decode: bool):
    apply_fn = nn.serve_linear_apply
    for si, seg in enumerate(segments_for(cfg)):
        for i, lp in enumerate(params.layers(si)):
            for bi, kind in enumerate(seg.pattern):
                pool = caches[si][f"b{bi}"]
                layer_pool = {name: leaf[i] for name, leaf in pool.items()}
                x, _ = apply_block(kind, lp[f"b{bi}"], x, cfg, apply_fn,
                                   layer_pool, paged_ctx, decode)
    return x


def _head(params):
    return params.head.tree() if hasattr(params, "head") else params.embed.tree()


@torch.no_grad()
def prefill_chunk(params, caches, tokens, start: int, block_table_row, cfg,
                  last: int = 0):
    """One fixed-size prefill chunk: tokens ``[1, C]`` at positions
    ``[start, start + C)`` of the slot whose pages ``block_table_row
    [max_blocks]`` names.  Returns ``(logits [vocab], caches)``: the
    logits of chunk row ``last`` only."""
    x = nn.embed_apply(params.embed.tree(), tokens)
    ctx = {"block_table": block_table_row, "start": start}
    x = _run_layers(params, caches, x, cfg, ctx, decode=False)
    x = x[:, last:last + 1]
    x = nn.rmsnorm_apply(params.final_norm.tree(), x)
    logits = nn.logits_apply(_head(params), x, vocab=cfg.vocab)
    return logits[0, 0, : cfg.vocab], caches


@torch.no_grad()
def decode_step_paged(params, caches, tokens, positions, block_table, cfg):
    """One paged decode step: tokens ``[B, 1]``, ``positions [B]`` int32,
    ``block_table [B, max_blocks]`` int32.  Idle slots carry an all-zero
    block-table row (writes land in the scratch page)."""
    x = nn.embed_apply(params.embed.tree(), tokens)
    ctx = {"block_table": block_table, "positions": positions}
    x = _run_layers(params, caches, x, cfg, ctx, decode=True)
    x = nn.rmsnorm_apply(params.final_norm.tree(), x)
    logits = nn.logits_apply(_head(params), x, vocab=cfg.vocab)
    return logits[:, 0, : cfg.vocab], caches
