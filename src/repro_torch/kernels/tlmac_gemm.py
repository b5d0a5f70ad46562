"""Table-lookup GEMM on pre-packed bit-plane codes (port of
``repro.kernels.tlmac_gemm.tlmac_gemm``).

``tlmac_gemm`` launches the CUDA kernel of ``csrc/tlmac_gemm.cu`` for
CUDA tensors and runs ``tlmac_gemm_plain`` (``ref.lookup_gemm_ref``) for
CPU tensors only.  Both return the same exact int32.  The Pallas kernel's
block sizes and its 'take'/'onehot' gather are TPU choices with one
result; the CUDA kernel takes any G in [1, 6], B_a in [1, 8] and D_p, and
needs no zero-row padding for a ragged KG.  ``launches`` counts kernel
launches.

The kernel reads the table as narrow rows (``tlmac_fused.narrow_table``:
int8, or int16 where an entry leaves int8), made once per plan and
device by its callers; on the card it refuses an int32 table rather than
narrowing it on every call.  The plain version takes any integer table.
``tlmac_gemm_onehot_plain`` is the kernel's algebra in plain torch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import lookup_gemm_ref
from repro_torch.kernels.tlmac_fused import _ROW_BYTES

launches = 0

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.load("tlmac_gemm").tlmac_gemm_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p] \
            + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check_args(codes, rowbase, table2d, B_a, G, N):
    if codes.dim() != 3 or codes.dtype != torch.int8:
        raise ValueError(f"codes must be int8 [B_a, M, KG], got {codes.dtype} "
                         f"{tuple(codes.shape)}")
    if rowbase.dim() != 3 or rowbase.dtype != torch.int32:
        raise ValueError(f"rowbase must be int32 [n_tiles, KG, D_p], got "
                         f"{rowbase.dtype} {tuple(rowbase.shape)}")
    if (table2d.dim() != 2 or table2d.dtype.is_floating_point
            or table2d.dtype == torch.bool or table2d.shape[1] != 2**G):
        raise ValueError(f"table2d must be integer [R, {2**G}], got "
                         f"{table2d.dtype} {tuple(table2d.shape)}")
    n_tiles, kg, dp = rowbase.shape
    if codes.shape[0] != B_a or codes.shape[2] != kg:
        raise ValueError(f"codes {tuple(codes.shape)} do not match B_a={B_a} "
                         f"and rowbase {tuple(rowbase.shape)}")
    if n_tiles * dp != N:
        raise ValueError(f"rowbase covers {n_tiles * dp} outputs, not N={N}")
    if not 1 <= B_a <= 8 or not 1 <= G <= 6:
        raise ValueError(f"B_a={B_a} must be in [1, 8] and G={G} in [1, 6]")
    devs = {t.device for t in (codes, rowbase, table2d)}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")


def tlmac_gemm_plain(codes, rowbase, table2d, *, B_a: int, G: int,
                     N: int) -> torch.Tensor:
    """Plain torch version of the kernel: int32 ``[M, N]``."""
    return lookup_gemm_ref(codes, rowbase, table2d, B_a)


def tlmac_gemm_onehot_plain(codes, rowbase, table2d, *, B_a: int, G: int,
                            N: int) -> torch.Tensor:
    """The kernel's decomposition in plain torch, int32-equal to
    ``tlmac_gemm_plain``: the B_a planes folded into one-hot coefficients
    ``coef [M, KG, 2^G] = sum_b 2^b [code_b == e]`` (the A operand, u8)
    times the table rows that ``rowbase`` selects (the B operand, gathered
    per output tile); rows wider than int8 are split into their u8 low and
    s8 high byte, two products summed as ``lo + 256 * hi`` modulo 2^32, as
    the kernel does for int16 rows.  Each product is exact in float64."""
    M, C = codes.shape[1], 2**G
    n_tiles, kg, dp = rowbase.shape
    weights = (1 << torch.arange(B_a, device=codes.device)).view(B_a, 1, 1, 1)
    onehot = torch.nn.functional.one_hot(codes.long() & (C - 1), C)
    coef = (onehot * weights).sum(0).reshape(M, kg * C).double()
    t = table2d.long()
    wide = table2d.dtype != torch.int8
    out = torch.empty((M, n_tiles, dp), dtype=torch.int64, device=codes.device)
    for nt in range(n_tiles):
        rows = t[rowbase[nt].long()]                      # [kg, dp, C]
        b = rows.permute(0, 2, 1).reshape(kg * C, dp)
        if wide:
            lo, hi = b & 0xFF, b >> 8                     # u8, s8
            acc = (coef @ lo.double()).long() + ((coef @ hi.double()).long()
                                                 << 8)
        else:
            acc = (coef @ b.double()).long()
        out[:, nt] = acc
    # modulo 2^32, as the int32 accumulators wrap
    out = (out + 2**31) % 2**32 - 2**31
    return out.reshape(M, N).to(torch.int32)


def tlmac_gemm(codes, rowbase, table2d, *, B_a: int, G: int,
               N: int) -> torch.Tensor:
    """Lookup GEMM from packed codes ``[B_a, M, KG]`` int8, ``rowbase
    [n_tiles, KG, D_p]`` int32 (rows of ``table2d``, see
    ``ref.rowbase_from_plan``) and ``table2d [R, 2^G]``: on the card the
    narrow rows of ``tlmac_fused.narrow_table`` (int8/int16), on the CPU
    any integer type.  Returns int32 ``[M, N]``, ``N = n_tiles * D_p``.
    Every rowbase entry must be a row of table2d and every code below 2^G
    (as ``pack_bitplanes`` makes them): the kernel does not bound-check
    them."""
    global launches
    _check_args(codes, rowbase, table2d, B_a, G, N)
    if codes.device.type == "cpu":
        return tlmac_gemm_plain(codes, rowbase, table2d, B_a=B_a, G=G, N=N)
    if not codes.is_cuda:
        raise ValueError(f"unsupported device {codes.device}")
    if table2d.dtype not in _ROW_BYTES:
        raise ValueError(f"the kernel reads narrow table rows (int8/int16 "
                         f"from tlmac_fused.narrow_table, made once per "
                         f"plan), got {table2d.dtype}")
    for name, t in (("codes", codes), ("rowbase", rowbase),
                    ("table2d", table2d)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if table2d.data_ptr() % 16:
        raise ValueError("table2d must be 16-byte aligned (its rows are "
                         "copied in 4- to 16-byte pieces)")
    n_tiles, kg, dp = rowbase.shape
    M = codes.shape[1]
    out = torch.empty((M, N), dtype=torch.int32, device=codes.device)
    if M == 0:
        return out
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    err = _launcher()(codes.data_ptr(), rowbase.data_ptr(), table2d.data_ptr(),
                      _ROW_BYTES[table2d.dtype], out.data_ptr(), M, kg,
                      n_tiles, dp, G, B_a, stream)
    _build.check(err, "tlmac_gemm")
    launches += 1
    return out
