"""LM backbone of the paged serve path (port of the serve subset of
``repro.models.lm`` for dense ``attn`` blocks).

Params stay stacked ``[n_layers, ...]`` per segment as in JAX; a Python
loop over layers replaces ``_segment_scan_cached``.  Differences from
JAX, on purpose:

- the paged pools are updated IN PLACE (``prefill_chunk``,
  ``decode_step_paged``, ``verify_step_paged``, ``cache_copy_page`` and
  ``cache_swap_in`` write the caches they are given and return the same
  objects), where JAX returns new arrays: the serve loop's captured
  graphs hold the pools' addresses;
- ``prefill_chunk`` takes ``start`` and ``last`` as 0-d int32 device
  tensors (Python ints are accepted too), so one captured CUDA graph of
  the ``[1, C]`` chunk serves every chunk of every prompt, as one jit
  trace does in JAX; ``verify_step_paged`` takes ``positions`` and
  ``n_writes`` as device tensors for the same reason;
- the ``jax.named_scope`` labels of the three forwards are
  ``torch.profiler.record_function`` ranges (host ranges: inside a
  captured graph they are recorded at capture, not at replay).
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
    """The gated product reaches ``wo`` in f32: XLA fuses it into
    ``wo``'s activation quantiser and drops its rounding to bf16."""
    pair_apply = getattr(apply_fn, "pair_apply", None)
    if (pair_apply is not None and cfg.serve_shared_act_quant
            and "wg" in params):
        h, g = pair_apply(params["wi"], params["wg"], x, cfg)
        h = h.float() * nn.silu(g)
    else:
        h = apply_fn(params["wi"], x, cfg)
        if "wg" in params:
            h = h.float() * nn.silu(apply_fn(params["wg"], x, cfg))
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
    ``paged_ctx``: ``{'block_table', 'positions', 'n_writes'}`` for a
    verify window, ``{'block_table', 'positions', 'impl'}`` for decode,
    ``{'block_table', 'start'}`` for a prefill chunk."""
    if kind != "attn":
        raise ValueError(f"block kind {kind!r} is not ported")
    h = nn.rmsnorm_apply(params["norm1"], x)
    if "n_writes" in paged_ctx:
        y, kv = attn.gqa_verify_paged(
            params["attn"], h, cfg, cache, paged_ctx["block_table"],
            paged_ctx["positions"], paged_ctx["n_writes"],
            apply_fn=apply_fn)
    elif decode:
        y, kv = attn.gqa_decode_paged(
            params["attn"], h, cfg, cache, paged_ctx["block_table"],
            paged_ctx["positions"], apply_fn=apply_fn,
            impl=paged_ctx.get("impl", "auto"))
    else:
        y, kv = attn.gqa_prefill_chunk(
            params["attn"], h, cfg, cache, paged_ctx["block_table"],
            paged_ctx["start"], apply_fn=apply_fn)
    # XLA fuses the residual add into the norm after it: the norm reads
    # the add's f32 sum, unrounded, while the stream keeps its bf16 sum
    s = x.float() + y
    x = s.to(x.dtype)
    hf = nn.rmsnorm_apply(params["norm2"], s, dtype=x.dtype)
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
def prefill_chunk(params, caches, tokens, start, block_table_row, cfg,
                  last=0):
    """One fixed-size prefill chunk: tokens ``[1, C]`` at positions
    ``[start, start + C)`` of the slot whose pages ``block_table_row
    [max_blocks]`` names; ``start`` and ``last`` are 0-d int32 tensors on
    the tokens' device (or ints).  Returns ``(logits [vocab], caches)``:
    the logits of chunk row ``last`` only, picked on the device."""
    with torch.profiler.record_function("repro_torch.lm.prefill_chunk"):
        x = nn.embed_apply(params.embed.tree(), tokens)
        ctx = {"block_table": block_table_row, "start": start}
        x = _run_layers(params, caches, x, cfg, ctx, decode=False)
        last = torch.as_tensor(last, device=x.device)
        x = x.index_select(1, last.reshape(1).long())
        x = nn.rmsnorm_apply(params.final_norm.tree(), x)
        logits = nn.logits_apply(_head(params), x, vocab=cfg.vocab)
    return logits[0, 0, : cfg.vocab], caches


@torch.no_grad()
def cache_copy_page(caches, src: int, dst: int):
    """Copy-on-write: duplicate physical page ``src`` into ``dst`` in
    place across every layer's pool leaf (codes and scale sidecars; the
    leaves are stacked ``[n_layers, n_pages, ...]``).  Returns the
    caches."""
    for seg in caches:
        for pool in seg.values():
            for leaf in pool.values():
                leaf[:, dst] = leaf[:, src]
    return caches


@torch.no_grad()
def cache_swap_out(caches, page_ids):
    """Device side of swap-out: gather the pages ``page_ids [R]`` (a
    fixed-width long tensor on the caches' device) across every layer's
    pool into fresh leaves ``[n_layers, R, P, ...]``, the caches'
    structure (``kernels/paged.swap_out_kv`` per layer)."""
    return [{b: {name: leaf[:, page_ids] for name, leaf in pool.items()}
             for b, pool in seg.items()} for seg in caches]


@torch.no_grad()
def cache_swap_in(caches, staged, page_ids):
    """Device side of swap-in, IN PLACE (the captured forwards hold the
    pools' addresses): scatter ``staged`` leaves ``[n_layers, R, P, ...]``
    (each leaf's bytes, in its dtype or an integer view of the same width)
    into pages ``page_ids [R]`` of every layer's pool.  Padding rows
    target the scratch page.  Returns the caches."""
    for seg, sseg in zip(caches, staged):
        for b, pool in seg.items():
            for name, leaf in pool.items():
                leaf[:, page_ids] = sseg[b][name].view(leaf.dtype)
    return caches


@torch.no_grad()
def decode_step_paged(params, caches, tokens, positions, block_table, cfg):
    """One paged decode step: tokens ``[B, 1]``, ``positions [B]`` int32,
    ``block_table [B, max_blocks]`` int32.  Idle slots carry an all-zero
    block-table row (writes land in the scratch page).  The attention
    reader follows ``cfg.serve_paged_attn_impl``."""
    with torch.profiler.record_function("repro_torch.lm.decode_step_paged"):
        x = nn.embed_apply(params.embed.tree(), tokens)
        ctx = {"block_table": block_table, "positions": positions,
               "impl": cfg.serve_paged_attn_impl}
        x = _run_layers(params, caches, x, cfg, ctx, decode=True)
        x = nn.rmsnorm_apply(params.final_norm.tree(), x)
        logits = nn.logits_apply(_head(params), x, vocab=cfg.vocab)
    return logits[:, 0, : cfg.vocab], caches


@torch.no_grad()
def verify_step_paged(params, caches, tokens, positions, n_writes,
                      block_table, cfg):
    """Speculative verify pass: a fixed ``K1``-token window per slot in
    one forward.  tokens ``[B, K1]`` (each slot's current token and its
    draft; row ``j`` at position ``positions[b] + j``), ``positions [B]``
    and ``n_writes [B]`` (real rows per slot; padding rows write to the
    scratch page) int32, ``block_table [B, max_blocks]`` int32, all
    tensors on the params' device.  Returns ``(logits [B, K1, vocab],
    caches)``: row ``j``'s logits are what a sequential decode step after
    accepting rows ``0..j`` gives.  Verify attention has no reader
    choice: it always runs the gather + masked softmax."""
    with torch.profiler.record_function("repro_torch.lm.verify_step_paged"):
        x = nn.embed_apply(params.embed.tree(), tokens)
        ctx = {"block_table": block_table, "positions": positions,
               "n_writes": n_writes}
        x = _run_layers(params, caches, x, cfg, ctx, decode=True)
        x = nn.rmsnorm_apply(params.final_norm.tree(), x)
        logits = nn.logits_apply(_head(params), x, vocab=cfg.vocab)
    return logits[:, :, : cfg.vocab], caches
