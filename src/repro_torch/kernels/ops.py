"""Lookup-GEMM dispatch (port of ``repro.kernels.ops.tlmac_matmul``).

Two impls, both exact int32: ``ref`` (the plain oracle) and ``fused``
(the hand-written kernel of ``kernels/tlmac_fused.py``; its plain
version on CPU tensors).  Autotune is not ported yet."""

from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.tlmac_fused import tlmac_gemm_fused


def tlmac_matmul(a_codes, table, exec_idx, step_cluster, *, B_a: int,
                 G: int, N: int, impl: str = "fused") -> torch.Tensor:
    """int32 ``[M, N]`` == a_codes @ W_codes by table lookup.
    ``exec_idx [n_tiles, kg, dp]`` and ``step_cluster [n_tiles, kg]`` in
    their stored dtypes."""
    if impl == "ref":
        return _ref.tlmac_matmul_ref(a_codes, table, exec_idx, step_cluster,
                                     B_a, G, N)
    if impl == "fused":
        out = tlmac_gemm_fused(a_codes, exec_idx, step_cluster, table,
                               B_a=B_a, G=G)
        if out.shape[1] != N:
            raise ValueError(f"plan covers {out.shape[1]} outputs, not {N}")
        return out
    raise ValueError(f"unknown impl {impl!r}")
