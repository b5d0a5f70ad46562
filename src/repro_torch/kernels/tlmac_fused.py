"""Fused bit-plane pack + table-lookup GEMM (port of
``repro.kernels.tlmac_fused.tlmac_gemm_fused``).

``tlmac_gemm_fused`` launches the CUDA kernel of ``csrc/tlmac_fused.cu``
for CUDA tensors and runs ``tlmac_gemm_fused_plain`` (the plain torch
version, ported from ``ref.tlmac_matmul_ref``) for CPU tensors only.
Both return the same exact int32.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import tlmac_matmul_ref

launches = 0

_IDX_BYTES = {torch.uint8: 1, torch.int16: 2}
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.load("tlmac_fused").tlmac_fused_launch
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check_args(a_codes, exec_idx, step_cluster, table, B_a, G):
    if a_codes.dim() != 2 or a_codes.dtype != torch.int8:
        raise ValueError(f"a_codes must be int8 [M, K], got "
                         f"{a_codes.dtype} {tuple(a_codes.shape)}")
    if exec_idx.dim() != 3 or exec_idx.dtype not in _IDX_BYTES:
        raise ValueError(f"exec_idx must be uint8/int16 [n_tiles, kg, dp], "
                         f"got {exec_idx.dtype} {tuple(exec_idx.shape)}")
    n_tiles, kg, dp = exec_idx.shape
    if step_cluster.shape != (n_tiles, kg) or step_cluster.dtype != torch.int8:
        raise ValueError(f"step_cluster must be int8 [{n_tiles}, {kg}], got "
                         f"{step_cluster.dtype} {tuple(step_cluster.shape)}")
    if (table.dim() != 3 or table.dtype != torch.int32
            or table.shape[-1] != 2**G):
        raise ValueError(f"table must be int32 [n_clus, N_arr, {2**G}], got "
                         f"{table.dtype} {tuple(table.shape)}")
    if a_codes.shape[1] != kg * G:
        raise ValueError(f"K={a_codes.shape[1]} != kg*G={kg * G}")
    if not 1 <= B_a <= 8 or not 1 <= G <= 6:
        raise ValueError(f"B_a={B_a} must be in [1, 8] and G={G} in [1, 6]")
    devs = {t.device for t in (a_codes, exec_idx, step_cluster, table)}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")


def tlmac_gemm_fused_plain(a_codes, exec_idx, step_cluster, table, *,
                           B_a: int, G: int) -> torch.Tensor:
    """Plain torch version of the kernel: int32 ``[M, n_tiles*dp]``."""
    n_tiles, _, dp = exec_idx.shape
    return tlmac_matmul_ref(a_codes, table, exec_idx, step_cluster,
                            B_a, G, n_tiles * dp)


def tlmac_gemm_fused(a_codes, exec_idx, step_cluster, table, *,
                     B_a: int, G: int) -> torch.Tensor:
    """Lookup GEMM from raw activation codes ``a_codes [M, K]`` int8 and
    the plan arrays in their stored dtypes: ``exec_idx [n_tiles, kg, dp]``
    uint8/int16, ``step_cluster [n_tiles, kg]`` int8, ``table [n_clus,
    N_arr, 2^G]`` int32.  Returns int32 ``[M, n_tiles*dp]``."""
    global launches
    _check_args(a_codes, exec_idx, step_cluster, table, B_a, G)
    if a_codes.device.type == "cpu":
        return tlmac_gemm_fused_plain(a_codes, exec_idx, step_cluster, table,
                                      B_a=B_a, G=G)
    if not a_codes.is_cuda:
        raise ValueError(f"unsupported device {a_codes.device}")
    n_tiles, kg, dp = exec_idx.shape
    if dp > 128 or G > 4:
        raise ValueError(f"the kernel takes dp <= 128 and G <= 4, got dp={dp}, "
                         f"G={G}")
    for name, t in (("a_codes", a_codes), ("exec_idx", exec_idx),
                    ("step_cluster", step_cluster), ("table", table)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    M, K = a_codes.shape
    out = torch.empty((M, n_tiles * dp), dtype=torch.int32,
                      device=a_codes.device)
    stream = torch.cuda.current_stream(a_codes.device).cuda_stream
    err = _launcher()(
        a_codes.data_ptr(), exec_idx.data_ptr(), _IDX_BYTES[exec_idx.dtype],
        step_cluster.data_ptr(), table.data_ptr(), out.data_ptr(),
        M, K, n_tiles, kg, dp, table.shape[1], B_a, G, stream)
    _build.check(err, "tlmac_gemm_fused")
    launches += 1
    return out
