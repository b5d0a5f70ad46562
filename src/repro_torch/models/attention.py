"""Attention of the serve path (port of the GQA and MLA serve subset of
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
``gqa_decode`` for a step, either one as cross-attention over an
encoder's K/V with ``cross_kv``, ``sdpa`` with its blocked ``_flash``
form) is plain torch, as the reference's is plain ``jnp``; so is MLA
(``init_mla``, ``mla_train``, ``mla_decode``), served on dense latent
caches only, as the reference serves it.  The train forward runs
``gqa_train`` (windowed for ``attn_local``, cross-attention for
``dec_cross``) and ``mla_train`` with ``apply_fn=nn.linear_apply`` under
autograd: these functions make no in-place update of a tensor the graph
reads.  Under a mesh the dense prefill and decode of a GQA block are
``tp_gqa_prefill`` and ``tp_gqa_decode``, on this rank's heads or cache
positions, and its train forward ``tp_gqa_train`` (causal, windowed or
bidirectional) and ``tp_cross_train``; an MLA block's are
``tp_mla_prefill`` and ``tp_mla_decode``, on this rank's heads and its
positions of the latent cache."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import paged
from repro_torch.models import nn
from repro_torch.parallel import collectives as coll

NEG_INF = -1e30


def init_gqa(gen, cfg, device="cuda", linear_init=nn.init_serve_linear):
    """wq/wk/wv/wo of ``linear_init``: the serve linears, or the train
    path's ``nn.init_linear``."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.kv_head_dim
    lin = linear_init
    return {
        "wq": lin(gen, d, H * hd, cfg, use_bias=cfg.qkv_bias, device=device),
        "wk": lin(gen, d, KV * hd, cfg, use_bias=cfg.qkv_bias, device=device),
        "wv": lin(gen, d, KV * hd, cfg, use_bias=cfg.qkv_bias, device=device),
        "wo": lin(gen, H * hd, d, cfg, device=device, shard=("model", None)),
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
    reader: ``'flash'`` runs flash-decode in four splits (with
    ``window``, each slot reads only its last ``window`` keys), ``'lax'``
    the gather + masked softmax reader (``paged._attend_lax``), and
    ``'auto'`` the autotune cache's winner for the decode shape
    (``paged.paged_attention``: a host-side read, flash at four splits on
    a miss)."""
    if impl not in DECODE_IMPLS:
        raise ValueError(f"paged attention impl {impl!r} not in "
                         f"{DECODE_IMPLS}")
    qs = paged.qspec_for(cfg)
    q, k, v = _qkv(params, x, cfg, apply_fn)
    sin, cos = nn.rotary_embedding(positions[:, None], cfg.kv_head_dim)
    q = nn.apply_rotary(q, sin, cos)
    k = nn.apply_rotary(k, sin, cos)
    kv = paged.write_decode_kv(pages, k, v, block_table, positions, qs)
    ksc, vsc = paged.pool_scales(kv)
    out = paged.paged_attention(
        q, kv["k"], kv["v"], block_table, positions, window=window,
        impl=impl, k_scales=ksc, v_scales=vsc, qspec=qs)
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
              apply_fn=nn.serve_linear_apply, kv_quant_rt: bool = False,
              cross_kv=None):
    """Full-sequence causal attention from position 0 (the dense loop's
    prefill).  ``kv_quant_rt`` (a cache is being built) round-trips K/V
    through ``cfg.serve_kv_dtype`` before the attention, so the prefill
    attends over exactly what its cache will hold.  ``cross_kv=(k, v)``
    (``[B, Se, KV, hd]``, an encoder's) makes it cross-attention: no
    rotary, no mask, no round trip; the block's own ``wk``/``wv`` still
    run and their output is dropped, as in the reference.  Returns ``(y,
    (k, v))``."""
    B, S, _ = x.shape
    q, k, v = _qkv(params, x, cfg, apply_fn)
    if cross_kv is not None:
        k, v = cross_kv
        out = sdpa(q, k, v, cfg, causal=False, window=window)
        return apply_fn(params["wo"], out, cfg), (k, v)
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
               apply_fn=nn.serve_linear_apply, cross_kv=None):
    """Single-token decode against a dense cache ``(k, v)`` ``[B, S_max,
    KV, hd]`` at the shared position ``pos`` (an int): writes the step's
    K/V there in place (round-tripped through ``cfg.serve_kv_dtype``
    into an f32 cache when it is quantised), then attends over the
    positions ``<= pos``.  Returns ``(y, (kc, vc))``, the same tensors.
    ``cross_kv=(xk, xv)`` attends over every encoder position instead,
    unrotated, and writes nothing (``cache`` is returned as given); the
    step's ``wk``/``wv`` still run, as in the reference."""
    B = x.shape[0]
    q, k, v = _qkv(params, x, cfg, apply_fn)
    H, hd = cfg.n_heads, cfg.kv_head_dim
    if cross_kv is not None:
        kc, vc = cross_kv
        mask = torch.ones((1, kc.shape[1]), dtype=torch.bool,
                          device=x.device)
        out = _sdpa(q, kc, vc, mask, cfg)
        return apply_fn(params["wo"], out.reshape(B, 1, H * hd), cfg), cache
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
    return apply_fn(params["wo"], out.reshape(B, 1, H * hd), cfg), (kc, vc)


# ---------------------------------------------------------------------------
# dense caches under a mesh: heads and cache positions over 'model'
# ---------------------------------------------------------------------------


def kv_heads_sharded(cfg) -> bool:
    """The caches' layout under a mesh (``lm.cache_axes``, dense and
    paged): KV heads on 'model' where they divide the production axis
    (16), else the sequence (the pages of a paged pool)."""
    return cfg.n_kv % nn.MODEL_AXIS == 0


def _tp_qkv(params, x, cfg):
    """q, k, v of this rank, each ``(tensor [B, S, cols], split)``."""
    return [nn.tp_linear_apply(params[n], x, cfg, use_bias=cfg.qkv_bias)
            for n in ("wq", "wk", "wv")]


def _heads(t, split: bool, n: int, cfg, local: bool, hd: int = 0):
    """``t [B, S, n * hd]`` (split or whole) as heads of ``hd`` (the KV
    head dim by default): all ``n`` of them, or (``local``) this rank's
    block of ``n / m`` (whole heads when the split columns hold them; else
    cut from the gathered whole).  A split is ``n * hd / m`` columns, so
    it falls on head boundaries wherever ``n`` divides over 'model'."""
    B, S, _ = t.shape
    hd = hd or cfg.kv_head_dim
    if not local:
        return nn.gather_cols(t, split).reshape(B, S, n, hd)
    nl = n // coll.size("model")
    if not split:
        t = t.narrow(-1, coll.index("model") * nl * hd, nl * hd)
    return t.reshape(B, S, nl, hd)


def _local_groups(k, cfg):
    """The KV heads ``[B, S, KV_l, hd]`` that this rank's block of query
    heads reads, from all of them ``k [B, S, KV, hd]``."""
    H, KV, m = cfg.n_heads, cfg.n_kv, coll.size("model")
    Hl, rep = H // m, H // KV
    h0 = coll.index("model") * Hl
    if Hl % rep == 0:
        g0, ng = h0 // rep, Hl // rep
    elif rep % Hl == 0:
        g0, ng = h0 // rep, 1
    else:
        raise NotImplementedError(f"{Hl} query heads a rank straddle KV "
                                  f"groups of {rep}")
    return k[:, :, g0:g0 + ng]


def _rope_rt(q, k, v, positions, cfg, roundtrip: bool):
    sin, cos = nn.rotary_embedding(positions, cfg.kv_head_dim)
    q, k = nn.apply_rotary(q, sin, cos), nn.apply_rotary(k, sin, cos)
    qs = paged.qspec_for(cfg)
    if roundtrip and qs.quantised:
        k, v = paged.kv_roundtrip(k, qs), paged.kv_roundtrip(v, qs)
    return q, k, v


def _store_positions(cache, new, start: int) -> None:
    """Write ``new [B, S_new, ...]`` (positions ``[start, start +
    S_new)``) into this rank's block of a sequence-sharded cache ``[B,
    S_l, ...]`` (positions ``[index * S_l, ...)``), in place: the overlap
    only."""
    n = cache.shape[1]
    lo = coll.index("model") * n
    a, b = max(lo, start), min(lo + n, start + new.shape[1])
    if b > a:
        cache[:, a - lo:b - lo] = new[:, a - start:b - start].to(cache.dtype)


def _tp_heads(qkv, cfg):
    """``qkv`` (``_tp_qkv``'s three ``(tensor, split)``) as this rank's
    query heads (all of them where the heads do not divide over 'model')
    and its K/V heads (its block where they shard, ``kv_heads_sharded``,
    else all of them): ``(q, k, v, local)``."""
    (q, qs), (k, ks), (v, vs) = qkv
    H, KV = cfg.n_heads, cfg.n_kv
    on_heads = kv_heads_sharded(cfg)    # KV % 16 == 0: H divides too
    local = H % coll.size("model") == 0
    return (_heads(q, qs, H, cfg, local), _heads(k, ks, KV, cfg, on_heads),
            _heads(v, vs, KV, cfg, on_heads), local)


def _read_groups(k, v, cfg, local: bool):
    """The K/V groups this rank's query heads read."""
    if local and not kv_heads_sharded(cfg):
        return _local_groups(k, cfg), _local_groups(v, cfg)
    return k, v


def tp_gqa_prefill(params, x, cfg, cache=None, window: Optional[int] = None,
                   bidir: bool = False):
    """``gqa_train`` as the dense prefill under the mesh: the causal
    attention of this rank's block of query heads (every head where the
    heads do not divide over 'model'), the K/V of this rank's cache block
    stored in place (``cache`` ``{'k', 'v'}``: its KV heads, or its
    positions of every head), then ``wo``.  Returns ``(y, split)``.

    ``window`` (``attn_local``): the windowed causal attention, and the
    cache is the ring of the last ``W`` keys at indices ``0..`` (zeros
    after them when ``S < W``; ``lm._store_prefill``'s), this rank's slots
    of it.  ``bidir`` (``enc_attn``, the encoder's ``lm._bidir_attn``):
    every key visible through the direct masked softmax, no cache."""
    B, S, _ = x.shape
    q, k, v, local = _tp_heads(_tp_qkv(params, x, cfg), cfg)
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _rope_rt(q, k, v, positions, cfg, cache is not None)
    kl, vl = _read_groups(k, v, cfg, local)
    if bidir:
        mask = torch.ones((S, S), dtype=torch.bool, device=x.device)
        out = _sdpa(q, kl, vl, mask, cfg).reshape(B, S, -1)
    else:
        out = sdpa(q, kl, vl, cfg, causal=True, window=window)
    if cache is not None:
        kc, vc = cache["k"], cache["v"]
        on_heads = kv_heads_sharded(cfg)
        if window is not None:      # the ring: the last W keys from 0
            W = kc.shape[1] * (1 if on_heads else coll.size("model"))
            k, v = k[:, -W:], v[:, -W:]
            kc.zero_()
            vc.zero_()
        if on_heads:
            kc[:, :k.shape[1]] = k.to(kc.dtype)
            vc[:, :v.shape[1]] = v.to(vc.dtype)
        else:           # this rank's positions of every head
            _store_positions(kc, k, 0)
            _store_positions(vc, v, 0)
    return nn.tp_linear_apply(params["wo"], out, cfg, split=local)


def _train_heads(q, k, v, cfg):
    """The column-parallel wq/wk/wv's outputs on this rank (``[B, S,
    cols]``, ``[B, Sk, cols]``) as the heads its attention runs: its block
    of query heads and the KV groups they read, where the heads divide
    over 'model' (k and v gathered over 'model' where its columns are not
    whole KV groups: fewer KV heads than ranks, or half a head); else
    every head, q, k and v gathered whole (the serve path's
    ``_tp_heads``).  A gather's backward reduce-scatters the gradient,
    each rank's a partial sum.  Returns ``(q, k, v, local)``."""
    H, KV, hd, m = cfg.n_heads, cfg.n_kv, cfg.kv_head_dim, coll.size("model")
    heads = lambda t, n: t.reshape(*t.shape[:2], n, hd)
    local = H % m == 0
    if not local:
        return (*(heads(coll.all_gather_ad(t, "model"), n)
                  for t, n in ((q, H), (k, KV), (v, KV))), False)
    q = heads(q, H // m)
    if KV % m == 0:
        return q, heads(k, KV // m), heads(v, KV // m), True
    k, v = (_local_groups(heads(coll.all_gather_ad(t, "model"), KV), cfg)
            for t in (k, v))
    return q, k, v, True


def _train_wo(params, out, cfg, local: bool):
    """The row-parallel ``wo`` on this rank's rows: ``out`` its heads'
    columns, or (``local`` False: every head ran on every rank) its block
    of them cut from the whole (the other blocks' gradient is the other
    ranks')."""
    if not local:
        out = coll.split(out, "model")
    return nn.linear_apply(params["wo"], out, cfg)


def tp_gqa_train(params, x, cfg, window: Optional[int] = None,
                 bidir: bool = False):
    """``gqa_train`` of the sharded train step under tensor parallelism
    (causal self-attention from position 0, with gradients): ``x [B, S,
    d]`` the whole sequence of this rank's batch rows (gathered by the
    block, ``models.lm._tp_train_block``).  The column-parallel wq/wk/wv
    (``nn.linear_apply`` on this rank's columns) give its heads
    (``_train_heads``: its block of query heads and their KV groups, or
    every head where the heads do not divide over 'model').  ``window``
    (``attn_local``): the windowed causal attention; ``bidir``
    (``enc_attn``, the encoder's ``lm._bidir_attn``): every key visible
    through the direct masked softmax.  Returns the row-parallel ``wo``'s
    partial sum ``[B, S, d]`` over this rank's heads or rows (the block
    reduce-scatters it over 'model')."""
    B, S, _ = x.shape
    lin = nn.linear_apply
    q, k, v, local = _train_heads(
        *(lin(params[n], x, cfg, use_bias=cfg.qkv_bias)
          for n in ("wq", "wk", "wv")), cfg)
    positions = torch.arange(S, device=x.device)[None, :]
    sin, cos = nn.rotary_embedding(positions, cfg.kv_head_dim)
    q = nn.apply_rotary(q, sin, cos)
    k = nn.apply_rotary(k, sin, cos)
    if bidir:
        mask = torch.ones((S, S), dtype=torch.bool, device=x.device)
        out = _sdpa(q, k, v, mask, cfg).reshape(B, S, -1)
    else:
        out = sdpa(q, k, v, cfg, causal=True, window=window)
    return _train_wo(params, out, cfg, local)


def tp_cross_train(params, x, enc_out, cfg):
    """``gqa_train`` with ``cross_kv`` (a ``dec_cross`` block's
    cross-attention) in the sharded train step: ``x [B, S, d]`` the whole
    decoder sequence of this rank's rows, ``enc_out [B, Se, d]`` the
    encoder's output gathered whole (once a forward, ``lm._encode_train``).
    q from ``x`` and the cross K/V from ``enc_out`` through the
    column-parallel wq/wk/wv (``lm._cross_kv`` on this rank's columns),
    arranged as ``tp_gqa_train`` arranges them; no rotary, no mask.  The
    block's own ``wk``/``wv`` of ``x``, whose output the reference drops,
    are not run (the serve path's ``tp_cross_prefill``).  Returns the
    row-parallel ``wo``'s partial sum ``[B, S, d]``."""
    lin = nn.linear_apply
    q, k, v, local = _train_heads(
        *(lin(params[n], t, cfg, use_bias=cfg.qkv_bias)
          for n, t in (("wq", x), ("wk", enc_out), ("wv", enc_out))), cfg)
    return _train_wo(params, sdpa(q, k, v, cfg, causal=False), cfg, local)


def _sdpa_seq_sharded(q, kc, vc, start: int, pos: Optional[int]):
    """One query row against this rank's block of cache positions
    ``[start, start + S_l)``, the softmax distributed over 'model' as the
    reference's partitioned graph runs it (read in its compiled HLO): the
    local max, its max over 'model'; ``exp``; the local sum, its sum over
    'model'; the weights ``exp / sum``; the local weighted V, its sum over
    'model'; all in f32.  q ``[B, 1, H, hd]`` -> ``[B, 1, H, hd]``.
    Positions past ``pos`` are masked (None: every position is read, a
    cross-attention's encoder positions)."""
    B, Sq, H, hd = q.shape
    KV = kc.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    s = torch.einsum("bqkrh,bskh->bkrqs", qg.float(), kc.float()) * (
        1.0 / math.sqrt(hd))
    if pos is not None:
        j = start + torch.arange(kc.shape[1], device=q.device)
        s = torch.where(j <= pos, s, torch.full_like(s, NEG_INF))
    mx = coll.all_reduce(s.amax(dim=-1), "model", "max")
    e = torch.exp(s - mx[..., None])
    den = coll.all_reduce(e.sum(dim=-1), "model")
    w = e / den[..., None]
    o = coll.all_reduce(torch.einsum("bkrqs,bskh->bkrqh", w, vc.float()),
                        "model")
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, -1).to(q.dtype)


def tp_gqa_decode(params, x, cfg, cache, pos: int, slot: Optional[int] = None):
    """``gqa_decode`` under the mesh: the step's K/V written in place into
    the rank that holds them (its KV heads, or the rank whose cache block
    holds position ``pos``), then the attention: this rank's heads over
    its heads' cache, or every head over the sequence-sharded cache (the
    softmax over 'model', ``_sdpa_seq_sharded``); then ``wo``.  Returns
    ``(y, split)``.  ``slot`` (an ``attn_local`` ring, ``lm._local_decode``):
    the K/V go to that index instead, and every index ``<= pos`` is read."""
    B = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.kv_head_dim
    (q, qs), (k, ks), (v, vs) = _tp_qkv(params, x, cfg)
    kc, vc = cache
    at = pos if slot is None else slot
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    on_heads = kv_heads_sharded(cfg)
    q = _heads(q, qs, H, cfg, on_heads)
    k, v = _heads(k, ks, KV, cfg, on_heads), _heads(v, vs, KV, cfg, on_heads)
    q, k, v = _rope_rt(q, k, v, positions, cfg, True)
    if on_heads:
        kc[:, at:at + 1] = k.to(kc.dtype)
        vc[:, at:at + 1] = v.to(vc.dtype)
        j = torch.arange(kc.shape[1], device=x.device)[None, :]
        out = _sdpa(q, kc, vc, j <= pos, cfg)
        return nn.tp_linear_apply(params["wo"], out.reshape(B, 1, -1), cfg,
                                  split=True)
    _store_positions(kc, k, at)
    _store_positions(vc, v, at)
    out = _sdpa_seq_sharded(q, kc, vc, coll.index("model") * kc.shape[1],
                            pos)
    return nn.tp_linear_apply(params["wo"], out.reshape(B, 1, H * hd), cfg)


def tp_cross_prefill(params, x, enc_out, cfg, cache=None):
    """``gqa_train`` with ``cross_kv`` (a ``dec_cross`` block's prefill)
    under the mesh: the cross K/V of the encoder's output (``lm._cross_kv``,
    column-parallel ``wk``/``wv``) on this rank's KV heads or all of them,
    stored in place as this rank's block of ``xk``/``xv`` (its KV heads, or
    its encoder positions of every head); the unmasked attention of this
    rank's query heads; then ``wo``.  The block's own ``wk``/``wv`` of
    ``x``, whose output the reference drops, are not run (its compiled
    graph has none).  Returns ``(y, split)``."""
    qkv = [nn.tp_linear_apply(params[n], t, cfg, use_bias=cfg.qkv_bias)
           for n, t in (("wq", x), ("wk", enc_out), ("wv", enc_out))]
    q, k, v, local = _tp_heads(qkv, cfg)
    kl, vl = _read_groups(k, v, cfg, local)
    out = sdpa(q, kl, vl, cfg, causal=False)
    if cache is not None:
        for name, t in (("xk", k), ("xv", v)):
            if kv_heads_sharded(cfg):
                cache[name].copy_(t)
            else:
                _store_positions(cache[name], t, 0)
    return nn.tp_linear_apply(params["wo"], out, cfg, split=local)


def tp_cross_decode(params, x, cfg, cache):
    """``gqa_decode`` with ``cross_kv`` under the mesh: this rank's query
    heads over its KV heads' ``xk``/``xv`` (every encoder position), or
    every head over its block of encoder positions (the softmax over
    'model', ``_sdpa_seq_sharded``); then ``wo``.  The step's ``wk``/``wv``
    are not run (dropped in the reference's compiled graph).  Returns
    ``(y, split)``."""
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.kv_head_dim
    xk, xv = cache
    q, qs = nn.tp_linear_apply(params["wq"], x, cfg, use_bias=cfg.qkv_bias)
    if kv_heads_sharded(cfg):
        q = _heads(q, qs, H, cfg, True)
        mask = torch.ones((1, xk.shape[1]), dtype=torch.bool,
                          device=x.device)
        out = _sdpa(q, xk, xv, mask, cfg)
        return nn.tp_linear_apply(params["wo"], out.reshape(B, 1, -1), cfg,
                                  split=True)
    q = _heads(q, qs, H, cfg, False)
    out = _sdpa_seq_sharded(q, xk, xv, coll.index("model") * xk.shape[1],
                            None)
    return nn.tp_linear_apply(params["wo"], out.reshape(B, 1, H * hd), cfg)


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention (deepseek-v3, kimi-k2), dense caches
# ---------------------------------------------------------------------------


def init_mla(gen, cfg, device="cuda", linear_init=nn.init_serve_linear):
    """MLA params of ``linear_init`` (serve linears, or the train path's
    ``nn.init_linear``): ``wq_a`` d -> q_lora, ``q_norm``, ``wq_b`` q_lora
    -> H (nope + rope), ``wkv_a`` d -> kv_lora + rope, ``kv_norm``,
    ``wkv_b`` kv_lora -> H (nope + v) and ``wo`` H v -> d.  ``wkv_b`` is
    drawn under ``serve_impl='dense'``: a dense bf16 serve linear whatever
    ``cfg.serve_impl``, as the reference builds it (decode absorbs its raw
    matrix into the latent attention)."""
    d, H = cfg.d_model, cfg.n_heads
    ql, kvl = cfg.mla_q_lora, cfg.mla_kv_lora
    nod, rod, vd = cfg.mla_nope_dim, cfg.mla_rope_dim, cfg.mla_v_dim
    lin = linear_init
    cfg_dense = dataclasses.replace(cfg, serve_impl="dense")
    return {
        "wq_a": lin(gen, d, ql, cfg, device=device, shard=(None, None)),
        "q_norm": nn.init_rmsnorm(ql, device),
        "wq_b": lin(gen, ql, H * (nod + rod), cfg, device=device),
        "wkv_a": lin(gen, d, kvl + rod, cfg, device=device,
                     shard=(None, None)),
        "kv_norm": nn.init_rmsnorm(kvl, device),
        "wkv_b": lin(gen, kvl, H * (nod + vd), cfg_dense, device=device),
        "wo": lin(gen, H * vd, d, cfg, device=device, shard=("model", None)),
    }


def _mla_q(params, x, cfg, apply_fn):
    """``(q_nope, q_rope)`` ``[B, S, H, nope | rope]`` before rotary."""
    B, S, _ = x.shape
    nod, rod = cfg.mla_nope_dim, cfg.mla_rope_dim
    q = apply_fn(params["wq_b"],
                 nn.rmsnorm_apply(params["q_norm"],
                                  apply_fn(params["wq_a"], x, cfg)), cfg)
    q = q.reshape(B, S, -1, nod + rod)     # this rank's heads under a mesh
    return q[..., :nod], q[..., nod:]


def _mla_latent(params, x, cfg, apply_fn):
    """``(c_kv [B, S, kv_lora] normed, k_rope [B, S, rope])``."""
    kvl = cfg.mla_kv_lora
    kv = apply_fn(params["wkv_a"], x, cfg)
    return nn.rmsnorm_apply(params["kv_norm"], kv[..., :kvl]), kv[..., kvl:]


def mla_train(params, x, cfg, apply_fn=nn.serve_linear_apply, **_):
    """Full-sequence causal MLA from position 0 (the dense loop's
    prefill): K/V expanded from the latents through ``wkv_b``, the rope
    key shared by every head.  Returns ``(y, (c_kv [B, S, kv_lora], k_rope
    [B, S, rope]))``: the compressed latents are the cache.  The MLA cache
    is bf16 whatever ``serve_kv_dtype`` (the reference's), so the
    ``window`` and ``kv_quant_rt`` keywords of ``gqa_train`` are taken
    and ignored."""
    B, S, _ = x.shape
    nod, rod, vd = cfg.mla_nope_dim, cfg.mla_rope_dim, cfg.mla_v_dim
    positions = torch.arange(S, device=x.device)[None, :]
    q_nope, q_rope = _mla_q(params, x, cfg, apply_fn)
    H = q_nope.shape[2]
    c_kv, k_rope = _mla_latent(params, x, cfg, apply_fn)
    kvu = apply_fn(params["wkv_b"], c_kv, cfg).reshape(B, S, H, nod + vd)
    k_nope, v = kvu[..., :nod], kvu[..., nod:]
    sin, cos = nn.rotary_embedding(positions, rod)
    q_rope = nn.apply_rotary(q_rope, sin, cos)
    k_rope = nn.apply_rotary(k_rope[:, :, None, :], sin, cos)   # shared head
    qf = torch.cat([q_nope, q_rope], dim=-1)
    kf = torch.cat([k_nope, k_rope.expand(B, S, H, rod)], dim=-1)
    out = sdpa(qf, kf, v, cfg, causal=True)              # KV == H (rep = 1)
    return apply_fn(params["wo"], out, cfg), (c_kv, k_rope[:, :, 0, :])


def mla_decode(params, x, cfg, cache, pos: int,
               apply_fn=nn.serve_linear_apply):
    """Absorbed-matmul MLA decode at the shared position ``pos`` (an int):
    the step's latents go into the dense caches ``(ckv [B, S_max,
    kv_lora], kr [B, S_max, rope])`` in place, and attention runs in the
    latent space (``W_uk`` absorbed into the query, ``W_uv`` applied to
    the attended latents), in f32 einsums as the reference's plain
    ``jnp``: a step costs O(S * kv_lora), never the full K/V.  Returns
    ``(y, (ckv, kr))``, the same tensors."""
    B = x.shape[0]
    H = cfg.n_heads
    nod, rod, vd = cfg.mla_nope_dim, cfg.mla_rope_dim, cfg.mla_v_dim
    kvl = cfg.mla_kv_lora
    q_nope, q_rope = _mla_q(params, x, cfg, apply_fn)
    c_new, kr_new = _mla_latent(params, x, cfg, apply_fn)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    sin, cos = nn.rotary_embedding(positions, rod)
    q_rope = nn.apply_rotary(q_rope, sin, cos)
    kr_new = nn.apply_rotary(kr_new[:, :, None, :], sin, cos)[:, :, 0, :]
    c_cache, kr_cache = cache
    c_cache[:, pos:pos + 1] = c_new.to(c_cache.dtype)
    kr_cache[:, pos:pos + 1] = kr_new.to(kr_cache.dtype)
    S_max = c_cache.shape[1]
    w_kv_b = params["wkv_b"]["w"].reshape(kvl, H, nod + vd)
    w_uk = w_kv_b[..., :nod].float()                     # [kvl, H, nod]
    w_uv = w_kv_b[..., nod:].float()                     # [kvl, H, vd]
    cf = c_cache.float()
    q_eff = torch.einsum("bqhn,chn->bqhc", q_nope.float(), w_uk)
    scores = (torch.einsum("bqhc,bsc->bhqs", q_eff, cf)
              + torch.einsum("bqhr,bsr->bhqs", q_rope.float(),
                             kr_cache.float())) / _sqrt_f32(nod + rod)
    mask = (torch.arange(S_max, device=x.device) <= pos)[None, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    out_c = torch.einsum("bhqs,bsc->bqhc", w, cf)
    out = torch.einsum("bqhc,chv->bqhv", out_c, w_uv)
    y = apply_fn(params["wo"], out.reshape(B, 1, H * vd).to(x.dtype), cfg)
    return y, (c_cache, kr_cache)


def _sqrt_f32(dk: int) -> float:
    """``jnp.sqrt(dk)`` of an int: the f32 square root."""
    return float(np.float32(np.sqrt(np.float32(dk))))


# ---------------------------------------------------------------------------
# MLA under a mesh: heads on 'model', the latent cache's positions on 'model'
# ---------------------------------------------------------------------------


def _tp_mla_heads(cfg) -> int:
    """This rank's number of heads; the heads must divide over 'model'."""
    H, m = cfg.n_heads, coll.size("model")
    if H % m:
        raise NotImplementedError(f"MLA under a mesh: {H} heads do not "
                                  f"divide over 'model' ({m} ranks)")
    return H // m


def _tp_mla_qkv(params, x, cfg):
    """``(q_nope, q_rope)`` of this rank's heads ``[B, S, H_l, nope |
    rope]`` before rotary, and the whole latents ``(c_kv [B, S, kv_lora]
    normed, k_rope [B, S, rope])``: ``wq_a`` and ``wkv_a`` replicated,
    ``wq_b`` on this rank's output tiles (its heads)."""
    nod, rod, kvl = cfg.mla_nope_dim, cfg.mla_rope_dim, cfg.mla_kv_lora
    qa = nn.gather_cols(*nn.tp_linear_apply(params["wq_a"], x, cfg))
    q, qs = nn.tp_linear_apply(params["wq_b"],
                               nn.rmsnorm_apply(params["q_norm"], qa), cfg)
    q = _heads(q, qs, cfg.n_heads, cfg, True, hd=nod + rod)
    kv = nn.gather_cols(*nn.tp_linear_apply(params["wkv_a"], x, cfg))
    c_kv = nn.rmsnorm_apply(params["kv_norm"], kv[..., :kvl])
    return q[..., :nod], q[..., nod:], c_kv, kv[..., kvl:]


def tp_mla_train(params, x, cfg):
    """``mla_train`` of the sharded train step under tensor parallelism:
    ``x [B, S, d]`` the whole sequence of this rank's batch rows (gathered
    by the block, ``models.lm._tp_train_block``).  ``wq_a``, ``wkv_a`` and
    their norms (``shard=(None, None)``) run whole on every rank, their
    gradients partial sums over its heads (``train.trainer.grad_axes``
    sums them over 'model'); the column-parallel ``wq_b`` and ``wkv_b``
    (``nn.linear_apply`` on this rank's columns, which fall on head
    boundaries when the heads divide over 'model') give its heads' queries,
    keys and values; the attention runs on those heads with the rotary key
    every head shares.  Returns the row-parallel ``wo``'s f32 partial sum
    ``[B, S, d]`` over this rank's heads (the block reduce-scatters it)."""
    _tp_mla_heads(cfg)
    return mla_train(params, x, cfg, apply_fn=nn.linear_apply)[0]


def tp_mla_prefill(params, x, cfg, cache=None):
    """``mla_train`` as the dense prefill under the mesh: the causal
    attention of this rank's heads (``wq_b`` and the dense ``wkv_b`` on
    its columns), its positions of the latents stored in place into the
    sequence-sharded cache ``{'ckv', 'kr'}``, then ``wo`` on its heads'
    rows.  Returns ``(y, split)``."""
    B, S, _ = x.shape
    Hl = _tp_mla_heads(cfg)
    nod, rod, vd = cfg.mla_nope_dim, cfg.mla_rope_dim, cfg.mla_v_dim
    q_nope, q_rope, c_kv, k_rope = _tp_mla_qkv(params, x, cfg)
    kvu, ks = nn.tp_linear_apply(params["wkv_b"], c_kv, cfg)
    kvu = _heads(kvu, ks, cfg.n_heads, cfg, True, hd=nod + vd)
    k_nope, v = kvu[..., :nod], kvu[..., nod:]
    positions = torch.arange(S, device=x.device)[None, :]
    sin, cos = nn.rotary_embedding(positions, rod)
    q_rope = nn.apply_rotary(q_rope, sin, cos)
    k_rope = nn.apply_rotary(k_rope[:, :, None, :], sin, cos)   # shared head
    qf = torch.cat([q_nope, q_rope], dim=-1)
    kf = torch.cat([k_nope, k_rope.expand(B, S, Hl, rod)], dim=-1)
    out = sdpa(qf, kf, v, cfg, causal=True)
    if cache is not None:
        _store_positions(cache["ckv"], c_kv, 0)
        _store_positions(cache["kr"], k_rope[:, :, 0, :], 0)
    return nn.tp_linear_apply(params["wo"], out, cfg, split=True)


def tp_mla_decode(params, x, cfg, cache, pos: int):
    """``mla_decode`` under the mesh, as the reference's partitioned graph
    runs it (read in its compiled HLO): the step's latents written in
    place into the rank whose cache block holds ``pos``; ``q_eff`` (``W_uk``
    absorbed) of this rank's heads, then ``q_eff`` and ``q_rope`` gathered
    over 'model'; every head's scores over this rank's positions, the
    softmax over 'model' (the max, the denominator and the weighted
    latents ``out_c`` each summed over 'model' in f32); ``W_uv`` on this
    rank's heads, then ``wo`` on their rows.  Returns ``(y, split)``."""
    B = x.shape[0]
    Hl = _tp_mla_heads(cfg)
    nod, rod, vd = cfg.mla_nope_dim, cfg.mla_rope_dim, cfg.mla_v_dim
    kvl = cfg.mla_kv_lora
    q_nope, q_rope, c_new, kr_new = _tp_mla_qkv(params, x, cfg)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    sin, cos = nn.rotary_embedding(positions, rod)
    q_rope = nn.apply_rotary(q_rope, sin, cos)
    kr_new = nn.apply_rotary(kr_new[:, :, None, :], sin, cos)[:, :, 0, :]
    c_cache, kr_cache = cache
    _store_positions(c_cache, c_new, pos)
    _store_positions(kr_cache, kr_new, pos)
    w_kv_b = params["wkv_b"]["w"].reshape(kvl, Hl, nod + vd)
    q_eff = torch.einsum("bqhn,chn->bqhc", q_nope.float(),
                         w_kv_b[..., :nod].float())
    q_eff = coll.all_gather(q_eff, "model", dim=2)        # every head
    q_rope = coll.all_gather(q_rope, "model", dim=2)
    cf = c_cache.float()
    scores = (torch.einsum("bqhc,bsc->bhqs", q_eff, cf)
              + torch.einsum("bqhr,bsr->bhqs", q_rope.float(),
                             kr_cache.float())) / _sqrt_f32(nod + rod)
    S_l = c_cache.shape[1]
    j = coll.index("model") * S_l + torch.arange(S_l, device=x.device)
    scores = torch.where(j <= pos, scores, torch.full_like(scores, NEG_INF))
    mx = coll.all_reduce(scores.amax(dim=-1), "model", "max")
    e = torch.exp(scores - mx[..., None])
    w = e / coll.all_reduce(e.sum(dim=-1), "model")[..., None]
    out_c = coll.all_reduce(torch.einsum("bhqs,bsc->bqhc", w, cf), "model")
    h0 = coll.index("model") * Hl
    out = torch.einsum("bqhc,chv->bqhv", out_c[:, :, h0:h0 + Hl],
                       w_kv_b[..., nod:].float())
    return nn.tp_linear_apply(params["wo"], out.reshape(B, 1, Hl * vd).to(
        x.dtype), cfg, split=True)
