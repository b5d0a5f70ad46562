"""Paged KV cache primitives (port of ``repro.kernels.paged``).

Every attention layer stores K/V in fixed-size pages of a physical pool
``[n_pages, page_size, KV, hd]``; a per-slot block table ``[B,
max_blocks] int32`` maps logical block ``j`` of slot ``b`` to a page.
Page 0 is a scratch page: idle slots' writes land there.

Unlike JAX, the pools here are updated IN PLACE (the write functions
mutate and return the same dict), so a serve loop holds exactly one copy
of the pool.  Scatters never accumulate: duplicate targets only ever
occur on the scratch page, whose content nobody reads unmasked.

Quantised pools (``KVQuantSpec`` int8 / int4) store absmax scales per
(page slot, kv head) as bf16 sidecars ``[n_pages, page_size, KV]``;
int4 packs two codes per byte, low nibble = even element.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

NEG_INF = -1e30
SCALE_DTYPE = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class PageSpec:
    """Static geometry of a paged KV pool."""

    page_size: int     # tokens per page
    n_pages: int       # physical pages per layer pool (page 0 = scratch)
    max_blocks: int    # block-table width == ceil(S_max / page_size)

    @property
    def s_alloc(self) -> int:
        return self.max_blocks * self.page_size


def spec_for(S_max: int, batch_slots: int, page_size: int = 16,
             n_pages: Optional[int] = None) -> PageSpec:
    """Pool geometry: by default every slot can grow to S_max, plus the
    scratch page."""
    max_blocks = -(-S_max // page_size)
    if n_pages is None:
        n_pages = batch_slots * max_blocks + 1
    return PageSpec(page_size=page_size, n_pages=n_pages,
                    max_blocks=max_blocks)


@dataclasses.dataclass(frozen=True)
class KVQuantSpec:
    """Quantised paged-KV layout: ``fp`` (bf16 pool, no scales), ``int8``
    (symmetric +-127, scale amax/127) or ``int4`` (codes in [-8, 7],
    scale amax/7.5, two codes per byte)."""

    dtype: str = "fp"

    def __post_init__(self):
        if self.dtype not in ("fp", "int8", "int4"):
            raise ValueError(
                f"serve_kv_dtype must be fp | int8 | int4, got {self.dtype!r}"
            )

    @property
    def quantised(self) -> bool:
        return self.dtype != "fp"

    @property
    def qmax(self) -> int:
        return {"int8": 127, "int4": 7}[self.dtype]

    @property
    def qlo(self) -> int:
        return {"int8": -127, "int4": -8}[self.dtype]

    @property
    def qdiv(self) -> float:
        return {"int8": 127.0, "int4": 7.5}[self.dtype]

    @property
    def packed(self) -> bool:
        return self.dtype == "int4"

    def code_width(self, hd: int) -> int:
        if self.packed:
            if hd % 2:
                raise ValueError(f"int4 packing needs an even head dim, "
                                 f"got {hd}")
            return hd // 2
        return hd


def qspec_for(cfg) -> KVQuantSpec:
    return KVQuantSpec(getattr(cfg, "serve_kv_dtype", "fp"))


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """Pack int8 codes in [-8, 7] two per byte (low nibble = even
    element of the last axis)."""
    if codes.shape[-1] % 2:
        raise ValueError(f"int4 packing needs an even head dim, "
                         f"got {codes.shape[-1]}")
    lo = codes[..., 0::2].to(torch.int32)
    hi = codes[..., 1::2].to(torch.int32)
    # (lo & 0xF) | (hi << 4) wraps to int8 exactly like JAX's astype
    return (((lo & 0x0F) | (hi << 4)) & 0xFF).to(torch.uint8).view(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """int8 ``[..., w]`` -> sign-extended codes ``[..., 2w]`` int8."""
    p = packed.to(torch.int32)
    lo = (p << 28) >> 28
    hi = (p << 24) >> 28
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*packed.shape[:-1], 2 * packed.shape[-1]).to(torch.int8)


def quantise_kv(x: torch.Tensor, qspec: KVQuantSpec):
    """Per-token symmetric absmax quantisation over the head dim:
    ``x [..., hd]`` -> ``(codes [..., code_width] int8, scales [...] bf16)``.
    Rounds half to even; an all-zero vector gets scale 1."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / qspec.qdiv,
                        torch.ones_like(amax)).to(SCALE_DTYPE)
    codes = torch.clamp(
        torch.round(xf / scale.to(torch.float32)[..., None]),
        qspec.qlo, qspec.qmax,
    ).to(torch.int8)
    if qspec.packed:
        codes = pack_int4(codes)
    return codes, scale


def dequantise_kv(codes: torch.Tensor, scales: torch.Tensor,
                  qspec: KVQuantSpec) -> torch.Tensor:
    """codes + scales -> f32 ``[..., hd]`` (f32 code x f32-cast scale)."""
    if qspec.packed:
        codes = unpack_int4(codes)
    return codes.to(torch.float32) * scales.to(torch.float32)[..., None]


def kv_roundtrip(x: torch.Tensor, qspec: KVQuantSpec) -> torch.Tensor:
    """quantise -> dequantise (f32): what the dense oracle writes into its
    cache, so that it attends over the values a quantised pool's readers
    see."""
    codes, scales = quantise_kv(x, qspec)
    return dequantise_kv(codes, scales, qspec)


def zero_kv_pool(spec: PageSpec, KV: int, hd: int,
                 qspec: Optional[KVQuantSpec] = None, n_layers: int = 0,
                 device="cuda") -> dict:
    """Zeroed pool for one layer, or for ``n_layers`` stacked layers
    (leading axis) when ``n_layers > 0``."""
    qspec = qspec or KVQuantSpec()
    lead = (n_layers,) if n_layers else ()
    shape = (*lead, spec.n_pages, spec.page_size, KV)
    if not qspec.quantised:
        return {"k": torch.zeros((*shape, hd), dtype=torch.bfloat16,
                                 device=device),
                "v": torch.zeros((*shape, hd), dtype=torch.bfloat16,
                                 device=device)}
    cw = qspec.code_width(hd)
    return {"k": torch.zeros((*shape, cw), dtype=torch.int8, device=device),
            "v": torch.zeros((*shape, cw), dtype=torch.int8, device=device),
            "ks": torch.ones(shape, dtype=SCALE_DTYPE, device=device),
            "vs": torch.ones(shape, dtype=SCALE_DTYPE, device=device)}


# ---------------------------------------------------------------------------
# page writes / reads
# ---------------------------------------------------------------------------


def _write_kv(kv: dict, pid, off, k, v, qspec: Optional[KVQuantSpec]):
    """Shared in-place scatter of every write path (quantise-on-write for
    quantised pools: codes and scales land at the same page slots)."""
    qspec = qspec or KVQuantSpec()
    pid, off = pid.long(), off.long()
    if not qspec.quantised:
        kv["k"][pid, off] = k.to(kv["k"].dtype)
        kv["v"][pid, off] = v.to(kv["v"].dtype)
        return kv
    kq, ks = quantise_kv(k, qspec)
    vq, vs = quantise_kv(v, qspec)
    kv["k"][pid, off] = kq
    kv["v"][pid, off] = vq
    kv["ks"][pid, off] = ks
    kv["vs"][pid, off] = vs
    return kv


def write_decode_kv(kv: dict, k, v, block_table, positions,
                    qspec: Optional[KVQuantSpec] = None) -> dict:
    """Write one decode token per slot: k/v ``[B, 1, KV, hd]`` at
    ``positions [B]``.  Idle slots' all-zero block-table rows send their
    writes to the scratch page."""
    P = kv["k"].shape[1]
    blk = (positions // P).long()
    pid = torch.gather(block_table, 1, blk[:, None])[:, 0]
    off = positions % P
    return _write_kv(kv, pid, off, k[:, 0], v[:, 0], qspec)


def write_chunk_kv(kv: dict, k, v, block_table_row, start,
                   qspec: Optional[KVQuantSpec] = None) -> dict:
    """Write one prefill chunk k/v ``[1, C, KV, hd]`` starting at
    absolute position ``start`` (a 0-d int32 tensor on the pool's device,
    or an int) into a slot's pages.  The padded tail lands inside the
    slot's own pages beyond its length (masked on read, overwritten by
    decode)."""
    C = k.shape[1]
    P = kv["k"].shape[1]
    pos = start + torch.arange(C, device=k.device)
    pid = block_table_row[pos // P]
    off = pos % P
    return _write_kv(kv, pid, off, k[0], v[0], qspec)


def write_spec_kv(kv: dict, k, v, block_table, positions, n_writes,
                  qspec: Optional[KVQuantSpec] = None) -> dict:
    """Write a fixed-width speculative verify window per slot: k/v ``[B,
    K1, KV, hd]``, row ``j`` of slot ``b`` at absolute position
    ``positions[b] + j``.  Only the first ``n_writes[b]`` rows are real
    (the current token plus the live draft); the window's padding rows go
    to the scratch page (page 0), codes and scales alike, as an idle
    slot's decode write does.  The block index is clamped into the
    table's range before the gather: a padding row of a slot near
    capacity may compute ``pos // P`` one past the last block."""
    K1 = k.shape[1]
    P = kv["k"].shape[1]
    ar = torch.arange(K1, device=k.device)
    pos = positions[:, None] + ar[None, :]                    # [B, K1]
    blk = torch.clamp(pos // P, max=block_table.shape[1] - 1).long()
    pid = torch.gather(block_table, 1, blk)                   # [B, K1]
    valid = ar[None, :] < n_writes[:, None]
    pid = torch.where(valid, pid, torch.zeros_like(pid))      # pad -> scratch
    off = pos % P
    return _write_kv(kv, pid, off, k, v, qspec)


def copy_page_kv(kv: dict, src: int, dst: int) -> dict:
    """Copy-on-write: duplicate physical page ``src`` into ``dst`` in
    place across every leaf of one layer's pool, codes AND scale sidecars
    (a CoW'd quantised page must dequantise as its source does).  Stacked
    layers go through ``models/lm.cache_copy_page``.  Returns ``kv``."""
    for leaf in kv.values():
        leaf[dst] = leaf[src]
    return kv


def swap_out_kv(kv: dict, page_ids) -> dict:
    """Gather the whole pages ``page_ids [R]`` (a fixed-width long
    tensor on the pool's device; short transactions pad with the scratch
    page) of one layer's pool into fresh ``[R, page_size, ...]`` tensors,
    codes and scale sidecars alike, for a device-to-host swap."""
    return {name: leaf[page_ids] for name, leaf in kv.items()}


def swap_in_kv(kv: dict, staged: dict, page_ids) -> dict:
    """Inverse of ``swap_out_kv``, in place: scatter ``staged`` leaves
    ``[R, page_size, ...]`` into pages ``page_ids``.  A staged leaf holds
    the pool leaf's bytes, in its dtype or as an integer view of the same
    width (bf16 as int16), and is written bit for bit; padding rows carry
    page id 0 and land in the scratch page.  Returns ``kv``."""
    for name, leaf in kv.items():
        leaf[page_ids] = staged[name].view(leaf.dtype)
    return kv


def gather_kv(k_pages, v_pages, block_table):
    """Per-slot K/V ``[B, MB*P, KV, hd]`` through the block table."""
    B, MB = block_table.shape
    _, P, KV, hd = k_pages.shape
    bt = block_table.long()
    return (k_pages[bt].reshape(B, MB * P, KV, hd),
            v_pages[bt].reshape(B, MB * P, KV, hd))


def gather_kv_deq(kv: dict, block_table, qspec: Optional[KVQuantSpec] = None):
    """``gather_kv`` over a (possibly quantised) pool dict: fp pools
    return bf16 pages, quantised pools the dequantised f32 values."""
    qspec = qspec or KVQuantSpec()
    if not qspec.quantised:
        return gather_kv(kv["k"], kv["v"], block_table)
    B, MB = block_table.shape
    P = kv["k"].shape[1]
    KV = kv["k"].shape[2]
    bt = block_table.long()
    kc = dequantise_kv(kv["k"][bt], kv["ks"][bt], qspec)
    vc = dequantise_kv(kv["v"][bt], kv["vs"][bt], qspec)
    return (kc.reshape(B, MB * P, KV, -1), vc.reshape(B, MB * P, KV, -1))


def _attend_lax(q, kv, block_table, positions, window: Optional[int],
                qspec: Optional[KVQuantSpec]):
    """Gather + masked softmax (the JAX package's decode oracle).
    q ``[B, Sq, H, hd]`` -> ``[B, Sq, H*hd]`` in q's dtype."""
    B, Sq, H, dk = q.shape
    KV = kv["k"].shape[2]
    rep = H // KV
    kc, vc = gather_kv_deq(kv, block_table, qspec)
    S = kc.shape[1]
    j = torch.arange(S, device=q.device)[None, :]
    mask = j <= positions[:, None]
    if window is not None:
        mask &= j > positions[:, None] - window
    mask = mask[:, None, None, None, :]
    qg = q.reshape(B, Sq, KV, rep, dk)
    scale = 1.0 / math.sqrt(dk)
    scores = torch.einsum("bqkrh,bskh->bkrqs", qg.float(), kc.float()) * scale
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkrqs,bskh->bkrqh", w, vc.float())
    dv = vc.shape[-1]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H * dv).to(q.dtype)


def pool_scales(kv: dict):
    """(k_scales, v_scales) of a pool dict, or (None, None) for fp."""
    return kv.get("ks"), kv.get("vs")


def dispatch_attention(config, q, k_pages, v_pages, block_table, positions,
                       *, window: Optional[int] = None, k_scales=None,
                       v_scales=None, qspec: Optional[KVQuantSpec] = None):
    """Run one paged-attention candidate config.  q ``[B, 1, H, hd]``;
    returns ``[B, 1, H*hd]`` in q's dtype.  ``'lax'`` is the gather +
    masked softmax reader, ``'flash'`` the flash-decode kernel (kernel 2)
    at ``n_splits`` (4 by default); quantised pools pass their scale
    sidecars, which every impl dequantises in its read loop."""
    impl = config["impl"]
    qspec = qspec or KVQuantSpec()
    if impl == "lax":
        kv = {"k": k_pages, "v": v_pages}
        if qspec.quantised:
            kv.update(ks=k_scales, vs=v_scales)
        return _attend_lax(q, kv, block_table, positions, window, qspec)
    if impl == "flash":
        from repro_torch.kernels.flash_decode import flash_decode

        B, _, H, hd = q.shape
        KV = k_pages.shape[2]
        out = flash_decode(
            q.reshape(B, KV, H // KV, hd), k_pages, v_pages, block_table,
            positions + 1, window=window,
            n_splits=config.get("n_splits", 4), k_scales=k_scales,
            v_scales=v_scales, kv_dtype=qspec.dtype)
        return out.reshape(B, 1, H * hd).to(q.dtype)
    raise ValueError(f"unknown paged attention impl {impl!r}")


def paged_attention(q, k_pages, v_pages, block_table, positions, *,
                    window: Optional[int] = None, impl: str = "auto",
                    tune_on_miss: bool = False, k_scales=None, v_scales=None,
                    qspec: Optional[KVQuantSpec] = None):
    """Paged decode attention with autotuned dispatch.  ``impl='auto'``
    resolves through the shape-keyed cache (``kernels/autotune.py``,
    keyed with the kv dtype as well); a miss dispatches flash-decode at 4
    splits, or tunes when ``tune_on_miss`` and no CUDA graph is being
    captured (serving never sweeps inline)."""
    from repro_torch.kernels import autotune

    if impl != "auto":
        config = {"impl": impl}
    else:
        B, _, H, hd = q.shape
        key = autotune.attn_shape_key(
            B, k_pages.shape[2], H // k_pages.shape[2], hd,
            block_table.shape[1], k_pages.shape[1], window,
            kv_dtype=(qspec or KVQuantSpec()).dtype, device=q.device)
        config = autotune.lookup(key)
        capturing = q.is_cuda and torch.cuda.is_current_stream_capturing()
        if config is None and tune_on_miss and not capturing:
            config = autotune.tune_attention(
                q, k_pages, v_pages, block_table, positions, window=window,
                k_scales=k_scales, v_scales=v_scales, qspec=qspec)
        config = config or dict(autotune.ATTN_DEFAULT)
    return dispatch_attention(config, q, k_pages, v_pages, block_table,
                              positions, window=window, k_scales=k_scales,
                              v_scales=v_scales, qspec=qspec)
