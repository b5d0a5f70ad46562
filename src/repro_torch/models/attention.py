"""GQA attention of the serve path (port of the GQA subset of
``repro.models.attention``).

Head layout: q ``[B, S, H, hd]``; kv ``[B, S, KV, hd]``.  Paged decode
reads the pool through the hand-written flash-decode kernel (its plain
version for CPU tensors) or, with ``serve_paged_attn_impl='lax'``, the
gathered reader; chunked prefill and the speculative verify window
gather the slot's pages and run the plain masked softmax, as the JAX
package does outside Pallas.  Pool writes happen in place.  Every paged
entry point takes ``window`` (``attn_local`` blocks): key ``ik`` is
visible from query ``iq`` when ``iq - window < ik <= iq``.

The dense-cache path of the oracle loop (``gqa_train`` for a prefill,
``gqa_decode`` for a step, ``sdpa`` with its blocked ``_flash`` form) is
plain torch, as the reference's is plain ``jnp``."""

from __future__ import annotations

import math
from typing import Optional

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


FLASH_THRESHOLD = 1024 * 1024  # sdpa switches to blocked attention here
FLASH_QB = 512
FLASH_KB = 1024


def _flash(q, k, v, scale, causal: bool, window, qb: int, kb: int):
    """Blocked online-softmax attention (the reference's ``_flash``): q
    ``[B, Sq, KV, rep, dk]``, k ``[B, Sk, KV, dk]``, v ``[B, Sk, KV, dv]``
    -> ``[B, KV, rep, Sq, dv]`` f32; no more than a ``[.., qb, kb]``
    score tile at a time."""
    B, Sq, KV, rep, dk = q.shape
    Sk, dv = k.shape[1], v.shape[-1]
    dev = q.device
    offset = Sk - Sq    # causal alignment: query i sees keys <= i + offset
    outs = []
    for q0 in range(0, Sq, qb):
        qblk = q[:, q0:q0 + qb].float()
        n = qblk.shape[1]
        if n < qb:                         # the reference pads with zeros
            qblk = torch.cat([qblk, qblk.new_zeros(
                (B, qb - n, KV, rep, dk))], dim=1)
        m = torch.full((B, KV, rep, qb), -math.inf, device=dev)
        den = torch.zeros((B, KV, rep, qb), device=dev)
        acc = torch.zeros((B, KV, rep, qb, dv), device=dev)
        iq = q0 + torch.arange(qb, device=dev)[:, None] + offset
        for k0 in range(0, Sk, kb):
            kblk, vblk = k[:, k0:k0 + kb].float(), v[:, k0:k0 + kb].float()
            if kblk.shape[1] < kb:
                pad = kb - kblk.shape[1]
                kblk = torch.cat([kblk, kblk.new_zeros(
                    (B, pad, KV, dk))], dim=1)
                vblk = torch.cat([vblk, vblk.new_zeros(
                    (B, pad, KV, dv))], dim=1)
            s = torch.einsum("bqkrh,bskh->bkrqs", qblk, kblk) * scale
            ik = k0 + torch.arange(kb, device=dev)[None, :]
            msk = ik < Sk
            if causal:
                msk = msk & (ik <= iq)
            if window is not None:
                msk = msk & (ik > iq - window)
            s = torch.where(msk, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            den = den * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkrqs,bskh->bkrqh", p, vblk)
            m = m_new
        out = acc / torch.clamp(den, min=1e-30)[..., None]
        outs.append(out[..., :n, :])
    return torch.cat(outs, dim=3)


def causal_mask(Sq: int, Sk: int, window: Optional[int] = None,
                device="cpu"):
    """``[Sq, Sk]`` bool: query ``i`` (at key position ``i + Sk - Sq``)
    sees key ``j <= i + Sk - Sq``, and ``j > i + Sk - Sq - window``."""
    i = torch.arange(Sq, device=device)[:, None] + (Sk - Sq)
    j = torch.arange(Sk, device=device)[None, :]
    m = j <= i
    if window is not None:
        m &= j > i - window
    return m


def sdpa(q, k, v, cfg, causal: bool = True, window: Optional[int] = None,
         mask=None):
    """Dispatching attention: q ``[B, Sq, H, dk]``, k ``[B, Sk, KV, dk]``
    -> ``[B, Sq, H * dv]`` in q's dtype.  At ``Sq * Sk >=
    FLASH_THRESHOLD`` without an explicit mask it runs the blocked
    ``_flash``; below, the direct masked softmax."""
    B, Sq, H, dk = q.shape
    KV, Sk, dv = k.shape[2], k.shape[1], v.shape[-1]
    qg = q.reshape(B, Sq, KV, H // KV, dk)
    scale = 1.0 / math.sqrt(dk)
    if Sq * Sk >= FLASH_THRESHOLD and mask is None:
        out = _flash(qg, k, v, scale, causal, window, FLASH_QB, FLASH_KB)
    else:
        if mask is None:
            mask = (causal_mask(Sq, Sk, window, q.device) if causal else
                    torch.ones((Sq, Sk), dtype=torch.bool, device=q.device))
        out = _sdpa_direct(qg, k, v, mask, scale)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H * dv).to(q.dtype)


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
                     window: Optional[int] = None,
                     apply_fn=nn.serve_linear_apply, impl: str = "auto"):
    """Single-token decode against a paged pool (written in place).
    ``positions [B]`` int32 per-slot write positions.  ``impl`` picks the
    reader: ``'auto'`` and ``'flash'`` run flash-decode in four splits
    (with ``window``, each slot reads only its last ``window`` keys),
    ``'lax'`` the gather + masked softmax reader (``paged._attend_lax``)."""
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
        out = paged._attend_lax(q, kv, block_table, positions, window, qs)
        return apply_fn(params["wo"], out, cfg), kv
    ksc, vsc = paged.pool_scales(kv)
    H, hd = cfg.n_heads, cfg.kv_head_dim
    KV = cfg.n_kv
    out = flash_decode(
        q.reshape(B, KV, H // KV, hd), kv["k"], kv["v"], block_table,
        positions + 1, window=window, n_splits=4,
        k_scales=ksc, v_scales=vsc, kv_dtype=qs.dtype,
    )
    out = out.reshape(B, 1, H * hd).to(q.dtype)
    return apply_fn(params["wo"], out, cfg), kv


def gqa_prefill_chunk(params, x, cfg, pages, block_table_row, start,
                      window: Optional[int] = None,
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
    if window is not None:
        mask &= ik > iq - window
    out = _sdpa(q, kc, vc, mask, cfg)
    H, hd = cfg.n_heads, cfg.kv_head_dim
    return apply_fn(params["wo"], out.reshape(B, C, H * hd), cfg), kv


def gqa_verify_paged(params, x, cfg, pages, block_table, positions, n_writes,
                     window: Optional[int] = None,
                     apply_fn=nn.serve_linear_apply):
    """Speculative-verify attention: a fixed ``K1``-token window per slot.
    ``x [B, K1, d]`` holds each slot's current token and its draft; row
    ``j`` sits at position ``positions[b] + j``.  Every row's K/V is
    written first (rows past ``n_writes[b]`` to the scratch page), then
    each row attends through the block table with its own causal (and
    window) mask (row ``j`` sees positions ``<= positions[b] + j``),
    through the same
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
    if window is not None:
        mask &= ik > iq - window
    out = _sdpa(q, kc, vc, mask[:, None, None], cfg)         # [B,K1,H,hd]
    H, hd = cfg.n_heads, cfg.kv_head_dim
    return apply_fn(params["wo"], out.reshape(B, K1, H * hd), cfg), kv


# ---------------------------------------------------------------------------
# dense caches: the oracle loop's prefill and decode
# ---------------------------------------------------------------------------


def gqa_train(params, x, cfg, window: Optional[int] = None,
              apply_fn=nn.serve_linear_apply, kv_quant_rt: bool = False):
    """Full-sequence causal attention from position 0 (the dense loop's
    prefill).  ``kv_quant_rt`` (a cache is being built) round-trips K/V
    through ``cfg.serve_kv_dtype`` before the attention, so the prefill
    attends over exactly what its cache will hold.  Returns ``(y, (k,
    v))``."""
    B, S, _ = x.shape
    q, k, v = _qkv(params, x, cfg, apply_fn)
    positions = torch.arange(S, device=x.device)[None, :]
    sin, cos = nn.rotary_embedding(positions, cfg.kv_head_dim)
    q = nn.apply_rotary(q, sin, cos)
    k = nn.apply_rotary(k, sin, cos)
    if kv_quant_rt:
        qs = paged.qspec_for(cfg)
        if qs.quantised:
            k = paged.kv_roundtrip(k, qs)
            v = paged.kv_roundtrip(v, qs)
    out = sdpa(q, k, v, cfg, causal=True, window=window)
    return apply_fn(params["wo"], out, cfg), (k, v)


def gqa_decode(params, x, cfg, cache, pos: int,
               window: Optional[int] = None,
               apply_fn=nn.serve_linear_apply):
    """Single-token decode against a dense cache ``(k, v)`` ``[B, S_max,
    KV, hd]`` at the shared position ``pos`` (an int): writes the step's
    K/V there in place (round-tripped through ``cfg.serve_kv_dtype``
    into an f32 cache when it is quantised), then attends over the
    positions ``<= pos``.  Returns ``(y, (kc, vc))``, the same tensors."""
    B = x.shape[0]
    q, k, v = _qkv(params, x, cfg, apply_fn)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    sin, cos = nn.rotary_embedding(positions, cfg.kv_head_dim)
    q = nn.apply_rotary(q, sin, cos)
    k = nn.apply_rotary(k, sin, cos)
    qs = paged.qspec_for(cfg)
    if qs.quantised:
        k = paged.kv_roundtrip(k, qs)
        v = paged.kv_roundtrip(v, qs)
    kc, vc = cache
    kc[:, pos:pos + 1] = k.to(kc.dtype)
    vc[:, pos:pos + 1] = v.to(vc.dtype)
    j = torch.arange(kc.shape[1], device=x.device)[None, :]
    mask = j <= pos
    if window is not None:
        mask &= j > pos - window
    out = _sdpa(q, kc, vc, mask, cfg)
    H, hd = cfg.n_heads, cfg.kv_head_dim
    return apply_fn(params["wo"], out.reshape(B, 1, H * hd), cfg), (kc, vc)
