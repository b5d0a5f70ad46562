"""Activation bit-plane packing, paper Eq. 3 (port of
``repro.kernels.bitplanes.pack_bitplanes_pallas``).

``pack_bitplanes`` launches the CUDA kernel of ``csrc/bitplanes.cu`` for
CUDA tensors and runs ``pack_bitplanes_plain`` (``ref.pack_bitplanes_ref``)
for CPU tensors only.  Both return int8 ``[B_a, M, K/G]`` (values
< 2^G <= 64; the Pallas kernel returns the same values as int32).
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import pack_bitplanes_ref

launches = 0

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.load("bitplanes").pack_bitplanes_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def pack_bitplanes_plain(a_codes: torch.Tensor, *, B_a: int,
                         G: int) -> torch.Tensor:
    """Plain torch version of the kernel: int8 ``[B_a, M, K/G]``."""
    return pack_bitplanes_ref(a_codes, B_a, G)


def pack_bitplanes(a_codes: torch.Tensor, *, B_a: int, G: int) -> torch.Tensor:
    """B_a-bit activation codes ``a_codes [M, K]`` int8 -> per-plane G-bit
    group codes int8 ``[B_a, M, K/G]``."""
    global launches
    if a_codes.dim() != 2 or a_codes.dtype != torch.int8:
        raise ValueError(f"a_codes must be int8 [M, K], got {a_codes.dtype} "
                         f"{tuple(a_codes.shape)}")
    M, K = a_codes.shape
    if not 1 <= B_a <= 8 or not 1 <= G <= 6 or K % G:
        raise ValueError(f"B_a={B_a} must be in [1, 8], G={G} in [1, 6] and "
                         f"divide K={K}")
    if a_codes.device.type == "cpu":
        return pack_bitplanes_plain(a_codes, B_a=B_a, G=G)
    if not a_codes.is_cuda:
        raise ValueError(f"unsupported device {a_codes.device}")
    if not a_codes.is_contiguous():
        raise ValueError("a_codes must be contiguous")
    out = torch.empty((B_a, M, K // G), dtype=torch.int8,
                      device=a_codes.device)
    if M == 0:
        return out
    stream = torch.cuda.current_stream(a_codes.device).cuda_stream
    err = _launcher()(a_codes.data_ptr(), out.data_ptr(), M, K, B_a, G,
                      stream)
    _build.check(err, "pack_bitplanes")
    launches += 1
    return out
