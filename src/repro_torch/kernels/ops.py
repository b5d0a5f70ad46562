"""Kernel dispatch (port of ``repro.kernels.ops``).

The impl names are the reference's, and each maps one to one onto its
counterpart here:

- ``'ref'``    : the plain oracle (``ref.tlmac_matmul_ref``);
- ``'pallas'`` : the lookup GEMM on pre-packed codes, kernel 3
                 (``kernels/tlmac_gemm.py``, ``csrc/tlmac_gemm.cu``), fed by
                 the bit-plane kernel 4 unless ``codes=`` is given;
- ``'fused'``  : the fused pack + lookup GEMM, kernel 1
                 (``kernels/tlmac_fused.py``, ``csrc/tlmac_fused.cu``).

The reference's ``'xla*'`` impls are TPU graph formulations with no
counterpart here, ``'pallas-onehot'`` is a TPU addressing variant of
``'pallas'`` with the same result, and ``'auto'`` (autotune) is not
ported yet.  Every impl returns the same exact int32.  On CPU tensors
the kernel wrappers run their plain versions.

``codes=`` lets callers pass activations already packed with
``pack_bitplanes`` so one packing feeds many GEMMs (the three kernel rows
of a lookup conv); the fused kernel instead packs in-register.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.bitplanes import pack_bitplanes as _pack_kernel
from repro_torch.kernels.tlmac_fused import tlmac_gemm_fused
from repro_torch.kernels.tlmac_gemm import tlmac_gemm


def dense_int_matmul(a_codes: torch.Tensor,
                     w_codes: torch.Tensor) -> torch.Tensor:
    """Dense integer GEMM baseline (what a non-lookup QNN would run)."""
    return _ref.dense_int_matmul_ref(a_codes, w_codes)


def pack_bitplanes(a_codes: torch.Tensor, B_a: int, G: int,
                   impl: str = "ref") -> torch.Tensor:
    """Per-plane group codes int8 ``[B_a, M, K/G]``: ``'pallas'`` is the
    bit-plane kernel (int8 ``a_codes``), ``'ref'`` the plain oracle."""
    if impl == "pallas":
        return _pack_kernel(a_codes, B_a=B_a, G=G)
    if impl == "ref":
        return _ref.pack_bitplanes_ref(a_codes, B_a, G)
    raise ValueError(f"unknown impl {impl!r}")


def tlmac_matmul(a_codes, table, exec_idx, step_cluster, *, B_a: int,
                 G: int, N: int, impl: str = "fused",
                 codes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int32 ``[M, N]`` == a_codes @ W_codes by table lookup.

    ``exec_idx`` ``[D_s, D_p]`` or ``[n_tiles, kg, D_p]`` and
    ``step_cluster`` ``[D_s]`` or ``[n_tiles, kg]``; the fused kernel
    reads them in their stored dtypes (uint8/int16, int8) and shape
    ``[n_tiles, kg, D_p]``."""
    if impl == "ref":
        return _ref.tlmac_matmul_ref(a_codes, table, exec_idx, step_cluster,
                                     B_a, G, N)
    if impl == "fused":
        out = tlmac_gemm_fused(a_codes, exec_idx, step_cluster, table,
                               B_a=B_a, G=G)
        if out.shape[1] != N:
            raise ValueError(f"plan covers {out.shape[1]} outputs, not {N}")
        return out
    if impl == "pallas":
        M, K = a_codes.shape
        kg = K // G
        n_tiles = N // exec_idx.shape[-1]
        if codes is None:
            codes = pack_bitplanes(a_codes, B_a, G, impl="pallas")
        rowbase = _ref.rowbase_from_plan(table, exec_idx, step_cluster,
                                         n_tiles, kg)
        return tlmac_gemm(codes, rowbase, table.reshape(-1, 2**G), B_a=B_a,
                          G=G, N=N)
    raise ValueError(f"unknown impl {impl!r}")
