"""Split-K paged flash-decode (port of ``repro.kernels.flash_decode``).

``flash_decode`` launches the CUDA kernel of ``csrc/flash_decode.cu``
for CUDA tensors and runs ``flash_decode_partials_plain`` (the same
split-K online softmax in plain torch) for CPU tensors only.  The plain
version produces per-split partials ``(acc [B, KV, S, rep, hd], m, l
[B, KV, S, rep])`` that ``combine_splits`` reduces in plain torch, as
the JAX package does outside its kernel; the kernel combines its splits
itself and returns the final output from one launch.  Its ``n_splits``
splits cut each slot's own visible keys into equal shares (the plain
version splits the block-table range).  ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged import NEG_INF, KVQuantSpec, dequantise_kv

launches = 0

_KIND = {"fp": 0, "int8": 1, "int4": 2}
_lib = None
# per device: int32 split tickets, zero between launches (each launch's
# last block resets its own); grown, never shrunk
_tickets = {}


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("flash_decode")
        lib.flash_decode_launch.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_decode_launch.restype = ctypes.c_int
        lib.flash_decode_rep_tile.argtypes = [ctypes.c_int]
        lib.flash_decode_rep_tile.restype = ctypes.c_int
        _lib = lib
    return _lib


def _tickets_for(device, n: int) -> torch.Tensor:
    t = _tickets.get(device)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _tickets[device] = t
    return t


def flash_decode_partials_plain(q, k_pages, v_pages, block_table, lengths, *,
                                window: Optional[int] = None,
                                n_splits: int = 4, k_scales=None,
                                v_scales=None, kv_dtype: str = "fp"):
    """Plain torch version of the kernel: the per-split partials
    ``(acc, m, l)``.  Visits block ``blk = s*bps + i`` of every split at
    once; invalid blocks read page 0 and are fully masked, which leaves
    the online-softmax state unchanged exactly as a skipped visit."""
    B, KV, rep, hd = q.shape
    MB = block_table.shape[1]
    S = max(1, min(n_splits, MB))
    bps = -(-MB // S)
    P = k_pages.shape[1]
    qspec = KVQuantSpec(kv_dtype)
    dev = q.device
    qf = q.float()
    scale = 1.0 / math.sqrt(hd)
    L = lengths.long()[:, None, None]                       # [B, 1, 1]
    m = torch.full((B, KV, S, rep), NEG_INF, device=dev)
    l = torch.zeros((B, KV, S, rep), device=dev)
    acc = torch.zeros((B, KV, S, rep, hd), device=dev)
    splits = torch.arange(S, device=dev)
    for i in range(bps):
        blk = splits * bps + i                              # [S]
        valid = blk[None, :] * P < lengths.long()[:, None]  # [B, S]
        pid = block_table.long()[:, blk.clamp(max=MB - 1)]  # [B, S]
        pid = torch.where(valid, pid, torch.zeros_like(pid))
        if qspec.quantised:
            kb = dequantise_kv(k_pages[pid], k_scales[pid], qspec)
            vb = dequantise_kv(v_pages[pid], v_scales[pid], qspec)
        else:
            kb = k_pages[pid].float()                       # [B,S,P,KV,hd]
            vb = v_pages[pid].float()
        s = torch.einsum("bgrh,bsjgh->bgsrj", qf, kb) * scale
        jpos = (blk[:, None] * P + torch.arange(P, device=dev))[None]  # [1,S,P]
        msk = jpos < L
        if window is not None:
            msk &= jpos > L - 1 - window
        msk = msk[:, None, :, None, :]                      # [B,1,S,1,P]
        row_max = torch.where(msk, s, torch.full_like(s, NEG_INF)).amax(-1)
        m_new = torch.maximum(m, row_max)
        p = torch.where(msk, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bgsrj,bsjgh->bgsrh", p, vb)
        m = m_new
    return acc, m, l


def combine_splits(acc, m, l):
    """FlashDecoding reduction of split partials -> f32 ``[B, KV, rep,
    hd]``; empty splits carry (0, -1e30, 0) and contribute exact zeros."""
    m_tot = m.amax(dim=2)                                   # [B,KV,rep]
    w = torch.exp(m - m_tot[:, :, None])
    l_tot = (l * w).sum(dim=2)
    o = (acc * w[..., None]).sum(dim=2)
    return o / torch.clamp(l_tot, min=1e-30)[..., None]


def _check_args(q, k_pages, v_pages, block_table, lengths, k_scales,
                v_scales, kv_dtype):
    if kv_dtype not in _KIND:
        raise ValueError(f"kv_dtype must be fp | int8 | int4, got {kv_dtype!r}")
    if q.dim() != 4:
        raise ValueError(f"q must be [B, KV, rep, hd], got {tuple(q.shape)}")
    B, KV, rep, hd = q.shape
    if kv_dtype == "int4" and hd % 2:
        raise ValueError(f"int4 pools pack two codes a byte: the head dim "
                         f"must be even, got {hd}")
    hdc = hd // 2 if kv_dtype == "int4" else hd
    if (k_pages.dim() != 4 or k_pages.shape[2:] != (KV, hdc)
            or v_pages.shape != k_pages.shape):
        raise ValueError(f"k/v pages must be [n_pages, P, {KV}, {hdc}], got "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    want = torch.bfloat16 if kv_dtype == "fp" else torch.int8
    if k_pages.dtype != want or v_pages.dtype != want:
        raise ValueError(f"{kv_dtype} pools must be {want}, got "
                         f"{k_pages.dtype}/{v_pages.dtype}")
    if kv_dtype != "fp":
        if k_scales is None or v_scales is None:
            raise ValueError(f"kv_dtype {kv_dtype!r} needs k_scales/v_scales")
        for sc in (k_scales, v_scales):
            if sc.shape != k_pages.shape[:3] or sc.dtype != torch.bfloat16:
                raise ValueError(f"scales must be bf16 "
                                 f"{tuple(k_pages.shape[:3])}, got "
                                 f"{sc.dtype} {tuple(sc.shape)}")
    if block_table.dim() != 2 or block_table.shape[0] != B:
        raise ValueError(f"block_table must be [{B}, MB], got "
                         f"{tuple(block_table.shape)}")
    if lengths.shape != (B,):
        raise ValueError(f"lengths must be [{B}], got {tuple(lengths.shape)}")


def check_kernel_operands(q, k_pages, v_pages, block_table, lengths,
                          k_scales=None, v_scales=None, kv_dtype="fp"):
    """What the kernel takes beyond the function's domain (``_check_args``):
    a bf16 query, any head dim in 1..256 (multiples of 8 read 16/8/4-byte
    pieces from 16-byte aligned rows, others byte by byte), int32 block
    table and lengths, contiguous operands on one device.  Raises
    ValueError otherwise."""
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the kernel takes a bf16 query, got {q.dtype}")
    if not 1 <= q.shape[-1] <= 256:
        raise ValueError(f"the kernel takes head dims 1..256, got "
                         f"{q.shape[-1]}")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("block_table and lengths must be int32")
    ops = [q, k_pages, v_pages, block_table, lengths]
    if kv_dtype != "fp":
        ops += [k_scales, v_scales]
    for t in ops:
        if not t.is_contiguous():
            raise ValueError("flash_decode operands must be contiguous")
        if t.device != q.device:
            raise ValueError(f"operands on several devices: {t.device}")
    if q.shape[-1] % 8 == 0:     # ragged head dims are read byte by byte
        for t in (q, k_pages, v_pages):
            if t.data_ptr() % 16:
                raise ValueError("q and the pools must start 16-byte aligned")


def flash_decode(q, k_pages, v_pages, block_table, lengths, *,
                 window: Optional[int] = None, n_splits: int = 4,
                 k_scales=None, v_scales=None,
                 kv_dtype: str = "fp") -> torch.Tensor:
    """Split-K paged flash decode; q ``[B, KV, rep, hd]``, pages ``[n_pages,
    P, KV, hd | hd/2]``, ``lengths = positions + 1``.  Returns f32 ``[B,
    KV, rep, hd]``."""
    global launches
    _check_args(q, k_pages, v_pages, block_table, lengths, k_scales,
                v_scales, kv_dtype)
    if q.device.type == "cpu":
        parts = flash_decode_partials_plain(
            q, k_pages, v_pages, block_table, lengths, window=window,
            n_splits=n_splits, k_scales=k_scales, v_scales=v_scales,
            kv_dtype=kv_dtype)
        return combine_splits(*parts)
    if not q.is_cuda:
        raise ValueError(f"unsupported device {q.device}")
    check_kernel_operands(q, k_pages, v_pages, block_table, lengths,
                          k_scales, v_scales, kv_dtype)
    B, KV, rep, hd = q.shape
    P, MB = k_pages.shape[1], block_table.shape[1]
    S = max(1, int(n_splits))
    lib = _library()
    rept = lib.flash_decode_rep_tile(rep)        # query heads per block
    n_rc = -(-rep // rept)
    dev = q.device
    out = torch.empty((B, KV, rep, hd), dtype=torch.float32, device=dev)
    ws_acc = ws_ml = tickets = None
    if S > 1:
        n_bg = B * KV * n_rc
        ws_acc = torch.empty(n_bg * S * rept * hd, dtype=torch.float32,
                             device=dev)
        ws_ml = torch.empty(n_bg * S * rept * 2, dtype=torch.float32,
                            device=dev)
        tickets = _tickets_for(dev, n_bg)
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.flash_decode_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), ptr(k_scales),
        ptr(v_scales), block_table.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), ptr(ws_acc), ptr(ws_ml), ptr(tickets),
        B, KV, rep, hd, P, MB, S, -1 if window is None else int(window),
        _KIND[kv_dtype], 1.0 / math.sqrt(hd), stream)
    _build.check(err, "flash_decode")
    launches += 1
    return out
