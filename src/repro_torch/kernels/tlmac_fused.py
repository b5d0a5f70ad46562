"""Fused bit-plane pack + table-lookup GEMM (port of
``repro.kernels.tlmac_fused.tlmac_gemm_fused``).

``tlmac_gemm_fused`` launches the CUDA kernel of ``csrc/tlmac_fused.cu``
for CUDA tensors and runs ``tlmac_gemm_fused_plain`` (the plain torch
version, ported from ``ref.tlmac_matmul_ref``) for CPU tensors only.
Both return the same exact int32.  ``launches`` counts kernel launches.

The kernel reads the table as narrow rows (``narrow_table``: int8, or
int16 where an entry leaves int8), made once where the params are made;
on the card it refuses an int32 table rather than narrowing it on every
call.  The plain version takes any integer table.

``tlmac_gemm_onehot_plain`` is the kernel's algebra written in plain
torch: the sum over bit-planes folded into one-hot coefficients
``coef[m, kg, c] = sum_b 2^b [code_b(m, kg) == c]`` and one integer
product with the gathered table rows (the TPU kernel's ``'onehot'``
formulation).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import pack_bitplanes_ref, tlmac_matmul_ref

launches = 0

_IDX_BYTES = {torch.uint8: 1, torch.int16: 2}
_ROW_BYTES = {torch.int8: 1, torch.int16: 2}
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.load("tlmac_fused").tlmac_fused_launch
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                       + [ctypes.c_void_p] + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def narrow_table(table: torch.Tensor) -> torch.Tensor:
    """The table in the narrowest type the kernel reads, every value
    kept: int8 when every entry fits int8, else int16.  A table entry is
    a sum of G weight codes (paper Eq. 4: B_w + ceil(log2 G) bits), so a
    compiled plan always fits int16."""
    if table.dtype in _ROW_BYTES:
        return table.contiguous()
    if table.dtype.is_floating_point or table.dtype == torch.bool:
        raise ValueError(f"table must be an integer tensor, got {table.dtype}")
    lo, hi = int(table.min()), int(table.max())
    for dt in (torch.int8, torch.int16):
        info = torch.iinfo(dt)
        if info.min <= lo and hi <= info.max:
            return table.to(dt).contiguous()
    raise ValueError(f"table entries [{lo}, {hi}] leave int16: not a "
                     "lookup table of a quantised layer")


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
    if (table.dim() != 3 or table.dtype.is_floating_point
            or table.shape[-1] != 2**G):
        raise ValueError(f"table must be integer [n_clus, N_arr, {2**G}], "
                         f"got {table.dtype} {tuple(table.shape)}")
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


def onehot_coefficients(a_codes: torch.Tensor, B_a: int,
                        G: int) -> torch.Tensor:
    """``coef [M, kg, 2^G]`` int32: ``sum_b 2^b [code_b(m, kg) == c]``,
    each in ``[0, 2^B_a - 1]``; the kernel builds the same bytes per
    tile in shared memory."""
    codes = pack_bitplanes_ref(a_codes, B_a, G).long()        # [B_a, M, kg]
    C = 2**G
    weights = (1 << torch.arange(B_a, device=codes.device)).view(B_a, 1, 1, 1)
    onehot = torch.nn.functional.one_hot(codes, C)           # [B_a, M, kg, C]
    return (onehot * weights).sum(0).to(torch.int32)


def gathered_rows(exec_idx, step_cluster, table) -> torch.Tensor:
    """The table rows every (kg, column) reads, as ``W' [kg*2^G, N]`` in
    the table's dtype: ``W'[kg*2^G + c, nt*dp + p] = T[cl[nt, kg],
    idx[nt, kg, p], c]``.  ``coef.reshape(M, -1) @ W'`` is the GEMM."""
    n_tiles, kg, dp = exec_idx.shape
    C = table.shape[-1]
    rows = (step_cluster.long()[..., None] * table.shape[1]
            + exec_idx.long())                               # [nt, kg, dp]
    g = table.reshape(-1, C)[rows]                           # [nt, kg, dp, C]
    return g.permute(1, 3, 0, 2).reshape(kg * C, n_tiles * dp)


def tlmac_gemm_onehot_plain(a_codes, exec_idx, step_cluster, table, *,
                            B_a: int, G: int) -> torch.Tensor:
    """The kernel's algebra in plain torch, int32-equal to
    ``tlmac_gemm_fused_plain``: one-hot coefficients times the gathered
    rows, summed exactly (float64 holds every partial sum)."""
    M = a_codes.shape[0]
    coef = onehot_coefficients(a_codes, B_a, G).reshape(M, -1)
    w = gathered_rows(exec_idx, step_cluster, table)
    return torch.matmul(coef.double(), w.double()).to(torch.int32)


def tlmac_gemm_fused(a_codes, exec_idx, step_cluster, table, *,
                     B_a: int, G: int) -> torch.Tensor:
    """Lookup GEMM from raw activation codes ``a_codes [M, K]`` int8 and
    the plan arrays in their stored dtypes: ``exec_idx [n_tiles, kg, dp]``
    uint8/int16, ``step_cluster [n_tiles, kg]`` int8, ``table [n_clus,
    N_arr, 2^G]`` (on the card int8/int16 from ``narrow_table``).
    Returns int32 ``[M, n_tiles*dp]``."""
    global launches
    _check_args(a_codes, exec_idx, step_cluster, table, B_a, G)
    if a_codes.device.type == "cpu":
        return tlmac_gemm_fused_plain(a_codes, exec_idx, step_cluster, table,
                                      B_a=B_a, G=G)
    if not a_codes.is_cuda:
        raise ValueError(f"unsupported device {a_codes.device}")
    if table.dtype not in _ROW_BYTES:
        raise ValueError(f"the kernel reads narrow table rows (int8/int16 "
                         f"from narrow_table, made once with the params), "
                         f"got {table.dtype}")
    n_tiles, kg, dp = exec_idx.shape
    if dp > 128 or G > 4:
        raise ValueError(f"the kernel takes dp <= 128 and G <= 4, got dp={dp}, "
                         f"G={G}")
    for name, t in (("a_codes", a_codes), ("exec_idx", exec_idx),
                    ("step_cluster", step_cluster), ("table", table)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if table.data_ptr() % 16:
        raise ValueError("table must start 16-byte aligned")
    M, K = a_codes.shape
    out = torch.empty((M, n_tiles * dp), dtype=torch.int32,
                      device=a_codes.device)
    stream = torch.cuda.current_stream(a_codes.device).cuda_stream
    err = _launcher()(
        a_codes.data_ptr(), exec_idx.data_ptr(), _IDX_BYTES[exec_idx.dtype],
        step_cluster.data_ptr(), table.data_ptr(), _ROW_BYTES[table.dtype],
        out.data_ptr(), M, K, n_tiles, kg, dp, table.shape[1], B_a, G, stream)
    _build.check(err, "tlmac_gemm_fused")
    launches += 1
    return out
