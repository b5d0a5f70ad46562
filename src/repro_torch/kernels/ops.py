"""Kernel dispatch (port of ``repro.kernels.ops``).

The impl names are the reference's, and each maps one to one onto its
counterpart here:

- ``'ref'``    : the plain oracle (``ref.tlmac_matmul_ref``);
- ``'pallas'`` : the lookup GEMM on pre-packed codes, kernel 3
                 (``kernels/tlmac_gemm.py``, ``csrc/tlmac_gemm.cu``), fed by
                 the bit-plane kernel 4 unless ``codes=`` is given;
- ``'fused'``  : the fused pack + lookup GEMM, kernel 1
                 (``kernels/tlmac_fused.py``, ``csrc/tlmac_fused.cu``);
- ``'auto'``   : the shape's winner in the autotune cache
                 (``kernels/autotune.py``), each winner int32-equal to
                 ``'ref'`` before it was timed; a miss tunes on concrete
                 operands when ``tune_on_miss`` and no CUDA graph is being
                 captured, else dispatches ``auto_default``.

The reference's ``'xla*'`` impls are TPU graph formulations with no
counterpart here, and ``'pallas-onehot'`` is a TPU addressing variant of
``'pallas'`` with the same result.  Every impl returns the same exact
int32.  On CPU tensors the kernel wrappers run their plain versions.

``codes=`` lets callers pass activations already packed with
``pack_bitplanes`` so one packing feeds many GEMMs (the three kernel rows
of a lookup conv); the fused kernel instead packs in-register.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.kernels import autotune
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.bitplanes import pack_bitplanes as _pack_kernel
from repro_torch.kernels.tlmac_fused import tlmac_gemm_fused
from repro_torch.kernels.tlmac_gemm import tlmac_gemm


def dense_int_matmul(a_codes: torch.Tensor,
                     w_codes: torch.Tensor) -> torch.Tensor:
    """Dense integer GEMM baseline (what a non-lookup QNN would run)."""
    return _ref.dense_int_matmul_ref(a_codes, w_codes)


def bitserial_matmul(a_codes: torch.Tensor, w_codes: torch.Tensor,
                     B_a: int) -> torch.Tensor:
    """Ablation: Eq. 3 serialisation without the lookup (see ref.py)."""
    return _ref.bitserial_matmul_ref(a_codes, w_codes, B_a)


def pack_bitplanes(a_codes: torch.Tensor, B_a: int, G: int,
                   impl: str = "ref") -> torch.Tensor:
    """Per-plane group codes int8 ``[B_a, M, K/G]``: ``'pallas'`` is the
    bit-plane kernel (int8 ``a_codes``), ``'ref'`` the plain oracle."""
    if impl == "pallas":
        return _pack_kernel(a_codes, B_a=B_a, G=G)
    if impl == "ref":
        return _ref.pack_bitplanes_ref(a_codes, B_a, G)
    raise ValueError(f"unknown impl {impl!r}")


def dispatch_config(config: Dict[str, Any], a_codes, table, exec_idx,
                    step_cluster, *, B_a: int, G: int, N: int,
                    codes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run one autotune candidate config; int32 ``[M, N]`` (``[E, M, N]``
    for an expert stack under ``'fused'``).

    ``exec_idx`` ``[D_s, D_p]`` or ``[n_tiles, kg, D_p]`` and
    ``step_cluster`` ``[D_s]`` or ``[n_tiles, kg]``; the fused kernel
    reads them in their stored dtypes (uint8/int16, int8) and shape
    ``[n_tiles, kg, D_p]``.  On the card both kernels read a table
    narrowed once by ``tlmac_fused.narrow_table`` (int8/int16 rows) and
    refuse an int32 one; ``'fused'`` also takes an expert stack (a
    leading E on every operand, int32 ``[E, M, N]`` from one launch);
    ``'pallas'`` (bit-plane pack + the lookup GEMM on packed codes) takes
    N_arr from ``table.shape[1]``, so the narrow table serves it
    unchanged, and rebuilds the plan's ``rowbase`` on every call;
    ``codes=`` passes planes packed once for several row GEMMs."""
    impl = config["impl"]
    if impl == "ref":
        return _ref.tlmac_matmul_ref(a_codes, table, exec_idx, step_cluster,
                                     B_a, G, N)
    if impl == "fused":
        out = tlmac_gemm_fused(a_codes, exec_idx, step_cluster, table,
                               B_a=B_a, G=G)
        if out.shape[-1] != N:
            raise ValueError(f"plan covers {out.shape[-1]} outputs, not {N}")
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


# resolved 'auto' configs by cache file, shape and call-site knobs, each
# with the autotune generation it was resolved at: the key and the cache
# read cost host time that every eager decode step would pay otherwise
_AUTO_MEMO: Dict[tuple, tuple] = {}


def resolve_auto(a_codes, table, exec_idx, step_cluster, *, B_a: int,
                 G: int, N: int, auto_default: str = autotune.DEFAULT_IMPL,
                 auto_allow: Optional[tuple] = None,
                 tune_on_miss: bool = True) -> Dict[str, Any]:
    """The config ``impl='auto'`` dispatches for these operands."""
    M, K = a_codes.shape
    dev = a_codes.device
    R = int(np.prod(table.shape[:-1]))
    memo_key = (autotune.cache_path(), dev.type, M, K, N, B_a, G,
                exec_idx.shape[-1], R, auto_allow, auto_default, tune_on_miss)
    hit = _AUTO_MEMO.get(memo_key)
    if hit is not None and hit[0] == autotune.generation:
        return hit[1]
    key = autotune.shape_key(M, K, N, B_a=B_a, G=G, D_p=exec_idx.shape[-1],
                             R=R, device=dev)
    config = autotune.lookup(key)
    if config is None:
        capturing = dev.type == "cuda" and \
            torch.cuda.is_current_stream_capturing()
        if tune_on_miss and not capturing:
            config = autotune.tune(a_codes, table, exec_idx, step_cluster,
                                   B_a=B_a, G=G, N=N)
        else:   # capturing (cannot time) or tuning off: the cache stays
            config = {"impl": auto_default}
    # the restriction binds cached and freshly tuned winners alike
    if auto_allow is not None and config["impl"] not in auto_allow:
        config = {"impl": auto_default}
    _AUTO_MEMO[memo_key] = (autotune.generation, config)
    return config


def tlmac_matmul(a_codes, table, exec_idx, step_cluster, *, B_a: int,
                 G: int, N: int, impl: str = "fused",
                 codes: Optional[torch.Tensor] = None,
                 auto_default: str = autotune.DEFAULT_IMPL,
                 auto_allow: Optional[tuple] = None,
                 tune_on_miss: bool = True) -> torch.Tensor:
    """int32 ``[M, N]`` == a_codes @ W_codes by table lookup, through
    ``impl`` (see ``dispatch_config``).  ``'auto'`` knobs:
    ``auto_allow`` restricts which winners may be dispatched (the serve
    linears allow the port's kernels only), ``tune_on_miss=False`` makes
    a miss dispatch ``auto_default`` instead of tuning (serving never
    sweeps inline)."""
    config = {"impl": impl}
    if impl == "auto":
        config = resolve_auto(a_codes, table, exec_idx, step_cluster,
                              B_a=B_a, G=G, N=N, auto_default=auto_default,
                              auto_allow=auto_allow,
                              tune_on_miss=tune_on_miss)
    return dispatch_config(config, a_codes, table, exec_idx, step_cluster,
                           B_a=B_a, G=G, N=N, codes=codes)
