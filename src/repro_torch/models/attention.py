"""GQA attention of the paged serve path (port of the serve subset of
``repro.models.attention``).

Head layout: q ``[B, S, H, hd]``; kv ``[B, S, KV, hd]``.  Decode reads
the paged pool through the hand-written flash-decode kernel (its plain
version for CPU tensors) or, with ``serve_paged_attn_impl='lax'``, the
gathered reader; chunked prefill and the speculative verify window
gather the slot's pages and run the plain masked softmax, as the JAX
package does outside Pallas.  Pool writes happen in place."""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import paged
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.models import nn

NEG_INF = -1e30


def init_gqa(gen, cfg, device="cuda"):
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.kv_head_dim
    lin = nn.init_serve_linear
    return {
        "wq": lin(gen, d, H * hd, cfg, use_bias=cfg.qkv_bias, device=device),
        "wk": lin(gen, d, KV * hd, cfg, use_bias=cfg.qkv_bias, device=device),
        "wv": lin(gen, d, KV * hd, cfg, use_bias=cfg.qkv_bias, device=device),
        "wo": lin(gen, H * hd, d, cfg, device=device),
    }


def _qkv(params, x, cfg, apply_fn):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.kv_head_dim
    q = apply_fn(params["wq"], x, cfg, use_bias=cfg.qkv_bias).reshape(B, S, H, hd)
    k = apply_fn(params["wk"], x, cfg, use_bias=cfg.qkv_bias).reshape(B, S, KV, hd)
    v = apply_fn(params["wv"], x, cfg, use_bias=cfg.qkv_bias).reshape(B, S, KV, hd)
    return q, k, v


def _sdpa_direct(q, k, v, mask, scale):
    """q ``[B, Sq, KV, rep, dk]`` -> ``[B, KV, rep, Sq, dv]`` in f32."""
    scores = torch.einsum("bqkrh,bskh->bkrqs", q.float(), k.float()) * scale
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bkrqs,bskh->bkrqh", w, v.float())


def _sdpa(q, k, v, mask, cfg):
    """Fixed-mask attention: q ``[B, Sq, H, hd]`` -> ``[B, Sq, H, dv]``."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    rep = H // KV
    qg = q.reshape(B, Sq, KV, rep, hd)
    out = _sdpa_direct(qg, k, v, mask, 1.0 / math.sqrt(hd))
    dv = v.shape[-1]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, dv).to(q.dtype)


DECODE_IMPLS = ("auto", "flash", "lax")


def gqa_decode_paged(params, x, cfg, pages, block_table, positions,
                     apply_fn=nn.serve_linear_apply, impl: str = "auto"):
    """Single-token decode against a paged pool (written in place).
    ``positions [B]`` int32 per-slot write positions.  ``impl`` picks the
    reader: ``'auto'`` and ``'flash'`` run flash-decode (full attention
    in four splits: no ported config has a sliding window), ``'lax'`` the
    gather + masked softmax reader (``paged._attend_lax``)."""
    if impl not in DECODE_IMPLS:
        raise ValueError(f"paged attention impl {impl!r} not in "
                         f"{DECODE_IMPLS}")
    B = x.shape[0]
    qs = paged.qspec_for(cfg)
    q, k, v = _qkv(params, x, cfg, apply_fn)
    sin, cos = nn.rotary_embedding(positions[:, None], cfg.kv_head_dim)
    q = nn.apply_rotary(q, sin, cos)
    k = nn.apply_rotary(k, sin, cos)
    kv = paged.write_decode_kv(pages, k, v, block_table, positions, qs)
    if impl == "lax":
        out = paged._attend_lax(q, kv, block_table, positions, None, qs)
        return apply_fn(params["wo"], out, cfg), kv
    ksc, vsc = paged.pool_scales(kv)
    H, hd = cfg.n_heads, cfg.kv_head_dim
    KV = cfg.n_kv
    out = flash_decode(
        q.reshape(B, KV, H // KV, hd), kv["k"], kv["v"], block_table,
        positions + 1, window=None, n_splits=4,
        k_scales=ksc, v_scales=vsc, kv_dtype=qs.dtype,
    )
    out = out.reshape(B, 1, H * hd).to(q.dtype)
    return apply_fn(params["wo"], out, cfg), kv


def gqa_prefill_chunk(params, x, cfg, pages, block_table_row, start,
                      apply_fn=nn.serve_linear_apply):
    """One prefill chunk (B == 1): write the chunk's K/V into the slot's
    pages, then read all of the slot's pages back with a causal mask.
    ``start`` is a 0-d int32 tensor on ``x``'s device (or an int)."""
    B, C, _ = x.shape
    qs = paged.qspec_for(cfg)
    q, k, v = _qkv(params, x, cfg, apply_fn)
    positions = start + torch.arange(C, device=x.device)[None, :]
    sin, cos = nn.rotary_embedding(positions, cfg.kv_head_dim)
    q = nn.apply_rotary(q, sin, cos)
    k = nn.apply_rotary(k, sin, cos)
    kv = paged.write_chunk_kv(pages, k, v, block_table_row, start, qs)
    kc, vc = paged.gather_kv_deq(kv, block_table_row[None], qs)
    S_alloc = kc.shape[1]
    iq = start + torch.arange(C, device=x.device)[:, None]
    ik = torch.arange(S_alloc, device=x.device)[None, :]
    mask = ik <= iq
    out = _sdpa(q, kc, vc, mask, cfg)
    H, hd = cfg.n_heads, cfg.kv_head_dim
    return apply_fn(params["wo"], out.reshape(B, C, H * hd), cfg), kv


def gqa_verify_paged(params, x, cfg, pages, block_table, positions, n_writes,
                     apply_fn=nn.serve_linear_apply):
    """Speculative-verify attention: a fixed ``K1``-token window per slot.
    ``x [B, K1, d]`` holds each slot's current token and its draft; row
    ``j`` sits at position ``positions[b] + j``.  Every row's K/V is
    written first (rows past ``n_writes[b]`` to the scratch page), then
    each row attends through the block table with its own causal mask
    (row ``j`` sees positions ``<= positions[b] + j``), through the same
    gather + masked softmax as the ``'lax'`` decode reader."""
    B, K1, _ = x.shape
    qs = paged.qspec_for(cfg)
    q, k, v = _qkv(params, x, cfg, apply_fn)
    pos = positions[:, None] + torch.arange(K1, device=x.device)[None, :]
    sin, cos = nn.rotary_embedding(pos, cfg.kv_head_dim)
    q = nn.apply_rotary(q, sin, cos)
    k = nn.apply_rotary(k, sin, cos)
    kv = paged.write_spec_kv(pages, k, v, block_table, positions, n_writes,
                             qs)
    kc, vc = paged.gather_kv_deq(kv, block_table, qs)
    S_alloc = kc.shape[1]
    iq = pos[:, :, None]                                      # [B, K1, 1]
    ik = torch.arange(S_alloc, device=x.device)[None, None, :]
    mask = ik <= iq
    out = _sdpa(q, kc, vc, mask[:, None, None], cfg)         # [B,K1,H,hd]
    H, hd = cfg.n_heads, cfg.kv_head_dim
    return apply_fn(params["wo"], out.reshape(B, K1, H * hd), cfg), kv
