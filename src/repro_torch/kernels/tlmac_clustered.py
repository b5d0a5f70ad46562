"""Cluster-scheduled lookup GEMM (port of
``repro.kernels.tlmac_clustered``): the paper's PE control structure.

  FPGA                                this port
  ------------------------------      --------------------------------
  mapping memory: step -> select s    steps re-ordered by cluster at
                                      compile time; the kernel's cluster
                                      loop index IS the select signal
  LUT array select s picks the        only cluster c's table slice
  truth-table slice                   [N_arr+1, 2^G] sits in shared
                                      memory while its steps run
  switches (mux per output)           the int8 mma's B operand read from
                                      row idx_sorted[s, p] of the slice
  PE (bit-serial adder tree)          coef [m, s, e] = sum_b 2^b
                                      [code_b == e], the mma's A operand

Host-side ``cluster_schedule`` / ``cluster_schedule_tiled`` (numpy,
identical to the reference's) turn a compiled plan into the padded,
cluster-sorted operand layout.  ``tlmac_gemm_clustered`` (one output
tile) and ``tlmac_gemm_clustered_multi`` (every tile of a layer, one
launch) launch the one CUDA kernel of ``csrc/tlmac_clustered.cu`` for
CUDA tensors and run their plain versions for CPU tensors only; each
counts its own launches (``launches``, ``launches_multi``).  The kernel
takes every plan the reference takes: G 1-6, any number of clusters, and
a slice of any size (one too large for shared memory is held there in
part, the rest read from device memory by the same kernel).  It reads
the table as narrow rows (``tlmac_fused.narrow_table``: int8, or
int16 where an entry leaves int8); ``device_schedule`` narrows it once,
and on the card an int32 ``table_pad`` is refused.  The plain versions
take any integer table.  ``tlmac_gemm_clustered_onehot_plain`` is the
kernel's algebra in plain torch.
``run_clustered`` / ``run_clustered_multi`` schedule a plan (once per
device, cached on the plan), pack the activation codes with the
bit-plane kernel, gather them into cluster order (plain torch, as the
reference's ``jnp.take``) and launch.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bitplanes import pack_bitplanes
from repro_torch.kernels.ref import lookup_gemm_ref
from repro_torch.kernels.tlmac_fused import _ROW_BYTES, narrow_table

launches = 0         # tlmac_gemm_clustered (one output tile)
launches_multi = 0   # tlmac_gemm_clustered_multi (every tile)

_fns = {}


def _launcher(name: str):
    fn = _fns.get(name)
    if fn is None:
        lib = _build.load("tlmac_clustered")
        fn = getattr(lib, name)
        if name == "tlmac_clustered_scratch_ints":
            fn.argtypes = [ctypes.c_int] * 3
        else:
            n_int = 7 if name == "tlmac_clustered_launch" else 8
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] \
                + [ctypes.c_void_p] * 2 + [ctypes.c_int] * n_int \
                + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


# ---------------------------------------------------------------------------
# host schedules (numpy, as in the reference)
# ---------------------------------------------------------------------------


def cluster_schedule(plan, bk: int = 8):
    """Reorder a plan's steps by cluster and pad each cluster to a
    multiple of ``bk`` k-steps.

    Returns dict with:
      order      [n_clus, ms]      original step ids (-1 padding)
      idx_sorted [n_clus, ms, D_p] within-cluster LUT-array ids
                                   (N_arr on padding slots)
      table_pad  [n_clus, N_arr+1, 2^G]  per-cluster tables + zero row
      ms         padded steps per cluster
    """
    n_clus, n_arr, C = plan.table.shape
    D_s, D_p = plan.exec_idx.shape
    per = [np.nonzero(plan.step_cluster == c)[0] for c in range(n_clus)]
    ms = max((len(p) for p in per), default=1)
    ms = -(-ms // bk) * bk
    order = np.full((n_clus, ms), -1, np.int32)
    idx_sorted = np.full((n_clus, ms, D_p), n_arr, np.int32)  # pad -> zero row
    for c, steps in enumerate(per):
        order[c, : len(steps)] = steps
        idx_sorted[c, : len(steps)] = plan.exec_idx[steps]
    table_pad = np.concatenate(
        [plan.table, np.zeros((n_clus, 1, C), np.int32)], axis=1
    )
    return {"order": order, "idx_sorted": idx_sorted,
            "table_pad": table_pad, "ms": ms}


def cluster_schedule_tiled(plan, n_tiles: int, bk: int = 8):
    """Per-(output-tile, cluster) schedule for multi-tile plans: every
    tile's steps re-ordered by cluster, each (tile, cluster) run padded
    to a common multiple-of-``bk`` length ``ms``.

    Returns dict with:
      order      [n_tiles, n_clus, ms]       original step ids (-1 pad)
      idx_sorted [n_tiles, n_clus, ms, D_p]  within-cluster array ids
                                             (N_arr on padding slots)
      table_pad  [n_clus, N_arr+1, 2^G]      per-cluster tables + zero row
      ms         padded steps per (tile, cluster)
    """
    n_clus, n_arr, C = plan.table.shape
    D_s, D_p = plan.exec_idx.shape
    assert D_s % n_tiles == 0
    kg = D_s // n_tiles
    per = [
        [np.nonzero(plan.step_cluster[nt * kg:(nt + 1) * kg] == c)[0] + nt * kg
         for c in range(n_clus)]
        for nt in range(n_tiles)
    ]
    ms = max((len(s) for tile in per for s in tile), default=1)
    ms = -(-ms // bk) * bk
    order = np.full((n_tiles, n_clus, ms), -1, np.int32)
    idx_sorted = np.full((n_tiles, n_clus, ms, D_p), n_arr, np.int32)
    for nt in range(n_tiles):
        for c, steps in enumerate(per[nt]):
            order[nt, c, : len(steps)] = steps
            idx_sorted[nt, c, : len(steps)] = plan.exec_idx[steps]
    table_pad = np.concatenate(
        [plan.table, np.zeros((n_clus, 1, C), np.int32)], axis=1
    )
    return {"order": order, "idx_sorted": idx_sorted,
            "table_pad": table_pad, "ms": ms}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def tlmac_gemm_clustered_multi_plain(codes_sorted, idx_sorted, table_pad, *,
                                     B_a: int, G: int) -> torch.Tensor:
    """Plain torch version of the kernel: int32 ``[M, n_tiles*D_p]``."""
    n_tiles, n_clus, ms, D_p = idx_sorted.shape
    n_arr1 = table_pad.shape[1]
    clus = torch.arange(n_clus, dtype=torch.int32, device=idx_sorted.device)
    rowbase = (clus[None, :, None, None] * n_arr1
               + idx_sorted.to(torch.int32)).reshape(n_tiles, n_clus * ms, D_p)
    t2d = table_pad.reshape(-1, table_pad.shape[-1])
    L = n_clus * ms
    return torch.cat([
        lookup_gemm_ref(codes_sorted[:, :, nt * L:(nt + 1) * L],
                        rowbase[nt:nt + 1], t2d, B_a)
        for nt in range(n_tiles)], dim=1)


def tlmac_gemm_clustered_plain(codes_sorted, idx_sorted, table_pad, *,
                               B_a: int, G: int) -> torch.Tensor:
    """Plain torch version of the kernel: int32 ``[M, D_p]``."""
    return tlmac_gemm_clustered_multi_plain(codes_sorted, idx_sorted[None],
                                            table_pad, B_a=B_a, G=G)


def tlmac_gemm_clustered_onehot_plain(codes_sorted, idx_sorted, table_pad, *,
                                      B_a: int, G: int) -> torch.Tensor:
    """The kernel's decomposition in plain torch, int32-equal to the plain
    versions: for every (tile, cluster) run up to its last step that
    selects a real row (the padding after it is skipped), the one-hot
    coefficients ``coef [M, steps, 2^G]`` times the rows of the run's
    slice ``table_pad[c]`` that the steps select, summed exactly (float64
    holds every partial sum).  ``idx_sorted`` is ``[n_tiles, n_clus, ms,
    D_p]`` (or ``[n_clus, ms, D_p]`` for one tile); returns int32 ``[M,
    n_tiles*D_p]``."""
    if idx_sorted.dim() == 3:
        idx_sorted = idx_sorted[None]
    n_tiles, n_clus, ms, D_p = idx_sorted.shape
    M, C = codes_sorted.shape[1], 2**G
    zero_row = table_pad.shape[1] - 1
    weights = (1 << torch.arange(B_a, device=codes_sorted.device)).view(
        B_a, 1, 1, 1)
    out = torch.zeros((M, n_tiles, D_p), dtype=torch.float64,
                      device=codes_sorted.device)
    for nt in range(n_tiles):
        for c in range(n_clus):
            idx = idx_sorted[nt, c].long()                    # [ms, D_p]
            real = (idx != zero_row).any(1).nonzero()
            if not len(real):
                continue
            live = int(real[-1]) + 1
            col0 = (nt * n_clus + c) * ms
            codes = codes_sorted[:, :, col0:col0 + live].long()
            coef = (torch.nn.functional.one_hot(codes, C) * weights).sum(0)
            rows = table_pad[c][idx[:live]]                  # [live, D_p, C]
            out[:, nt] += (coef.reshape(M, live * C).double()
                           @ rows.permute(0, 2, 1).reshape(live * C, D_p)
                           .double())
    return out.reshape(M, n_tiles * D_p).to(torch.int32)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_args(codes_sorted, idx_sorted, table_pad, B_a, G):
    n_tiles, n_clus, ms, D_p = idx_sorted.shape
    if codes_sorted.dim() != 3 or codes_sorted.dtype != torch.int8:
        raise ValueError(f"codes_sorted must be int8 [B_a, M, cols], got "
                         f"{codes_sorted.dtype} {tuple(codes_sorted.shape)}")
    if idx_sorted.dtype != torch.int32:
        raise ValueError(f"idx_sorted must be int32, got {idx_sorted.dtype}")
    if (table_pad.dim() != 3 or table_pad.dtype.is_floating_point
            or table_pad.dtype == torch.bool
            or table_pad.shape[0] != n_clus or table_pad.shape[2] != 2**G):
        raise ValueError(f"table_pad must be integer [{n_clus}, N_arr+1, "
                         f"{2**G}], got {table_pad.dtype} "
                         f"{tuple(table_pad.shape)}")
    if (codes_sorted.shape[0] != B_a
            or codes_sorted.shape[2] != n_tiles * n_clus * ms):
        raise ValueError(f"codes_sorted {tuple(codes_sorted.shape)} does not "
                         f"match B_a={B_a} and idx_sorted "
                         f"{tuple(idx_sorted.shape)}")
    if not 1 <= B_a <= 8 or not 1 <= G <= 6:
        raise ValueError(f"B_a={B_a} must be in [1, 8] and G={G} in [1, 6]")
    devs = {t.device for t in (codes_sorted, idx_sorted, table_pad)}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")


def _launch(codes_sorted, idx_sorted, table_pad, B_a, G, multi: bool):
    if not codes_sorted.is_cuda:
        raise ValueError(f"unsupported device {codes_sorted.device}")
    if table_pad.dtype not in _ROW_BYTES:
        raise ValueError(f"the kernel reads narrow table rows (int8/int16 "
                         f"from narrow_table, made once by device_schedule), "
                         f"got {table_pad.dtype}")
    for name, t in (("codes_sorted", codes_sorted), ("idx_sorted", idx_sorted),
                    ("table_pad", table_pad)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if table_pad.data_ptr() % 16:
        raise ValueError("table_pad must be 16-byte aligned (its slices are "
                         "copied in 16-byte pieces)")
    n_tiles, n_clus, ms, D_p = idx_sorted.shape
    n_arr1 = table_pad.shape[1]
    M = codes_sorted.shape[1]
    dev = codes_sorted.device
    out = torch.empty((M, n_tiles * D_p), dtype=torch.int32, device=dev)
    if M == 0:
        return out
    # the pre-pass writes each run's live steps per column group here
    scratch = torch.empty(_launcher("tlmac_clustered_scratch_ints")(
        n_tiles, n_clus, D_p), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (codes_sorted.data_ptr(), idx_sorted.data_ptr(),
            table_pad.data_ptr(), _ROW_BYTES[table_pad.dtype],
            scratch.data_ptr(), out.data_ptr())
    if multi:
        err = _launcher("tlmac_clustered_multi_launch")(
            *ptrs, M, n_tiles, n_clus, ms, D_p, n_arr1, G, B_a, stream)
    else:
        err = _launcher("tlmac_clustered_launch")(
            *ptrs, M, n_clus, ms, D_p, n_arr1, G, B_a, stream)
    _build.check(err, "tlmac_gemm_clustered" + ("_multi" if multi else ""))
    return out


def tlmac_gemm_clustered(codes_sorted, idx_sorted, table_pad, *, B_a: int,
                         G: int) -> torch.Tensor:
    """One-output-tile clustered lookup GEMM: ``codes_sorted [B_a, M,
    n_clus*ms]`` int8, ``idx_sorted [n_clus, ms, D_p]`` int32 (N_arr =
    padding), ``table_pad [n_clus, N_arr+1, 2^G]`` (on the card int8/int16
    from ``narrow_table``) -> int32
    ``[M, D_p]``.  Indices must be rows of their slice and codes below
    2^G: the kernel does not bound-check them."""
    global launches
    if idx_sorted.dim() != 3:
        raise ValueError(f"idx_sorted must be [n_clus, ms, D_p], got "
                         f"{tuple(idx_sorted.shape)}")
    _check_args(codes_sorted, idx_sorted[None], table_pad, B_a, G)
    if codes_sorted.device.type == "cpu":
        return tlmac_gemm_clustered_plain(codes_sorted, idx_sorted, table_pad,
                                          B_a=B_a, G=G)
    out = _launch(codes_sorted, idx_sorted[None], table_pad, B_a, G, False)
    launches += 1
    return out


def tlmac_gemm_clustered_multi(codes_sorted, idx_sorted, table_pad, *,
                               B_a: int, G: int) -> torch.Tensor:
    """Whole-layer clustered lookup GEMM in one launch: ``codes_sorted
    [B_a, M, n_tiles*n_clus*ms]`` int8, ``idx_sorted [n_tiles, n_clus, ms,
    D_p]`` int32, ``table_pad [n_clus, N_arr+1, 2^G]`` (on the card
    int8/int16) -> int32
    ``[M, n_tiles*D_p]``."""
    global launches_multi
    if idx_sorted.dim() != 4:
        raise ValueError(f"idx_sorted must be [n_tiles, n_clus, ms, D_p], "
                         f"got {tuple(idx_sorted.shape)}")
    _check_args(codes_sorted, idx_sorted, table_pad, B_a, G)
    if codes_sorted.device.type == "cpu":
        return tlmac_gemm_clustered_multi_plain(codes_sorted, idx_sorted,
                                                table_pad, B_a=B_a, G=G)
    out = _launch(codes_sorted, idx_sorted, table_pad, B_a, G, True)
    launches_multi += 1
    return out


# ---------------------------------------------------------------------------
# plan-level wrappers
# ---------------------------------------------------------------------------


def device_schedule(plan, n_tiles: int, bk: int, device, tiled: bool):
    """The plan's schedule as tensors on ``device`` (built once, cached on
    the plan): ``cols`` (code column of every scheduled step; padding
    reads column 0 and selects the zero row), ``idx_sorted``, and
    ``table_pad`` as the narrow rows the kernel reads (``narrow_table``,
    on the host: no call on the card synchronises to narrow it)."""
    key = ("cluster_schedule", tiled, n_tiles, bk, str(torch.device(device)))
    hit = plan.device_cache.get(key)
    if hit is None:
        if tiled:
            sched = cluster_schedule_tiled(plan, n_tiles, bk=bk)
            kg = plan.D_s // n_tiles
            # codes are shared across tiles: step s reads column s % kg
            cols = np.where(sched["order"] >= 0, sched["order"] % kg, 0)
        else:
            sched = cluster_schedule(plan, bk=bk)
            cols = np.where(sched["order"] >= 0, sched["order"], 0)
        hit = {
            "cols": torch.as_tensor(cols.reshape(-1).astype(np.int64),
                                    device=device),
            "idx_sorted": torch.as_tensor(sched["idx_sorted"], device=device),
            "table_pad": narrow_table(torch.as_tensor(
                sched["table_pad"])).to(device),
        }
        plan.device_cache[key] = hit
    return hit


def run_clustered(plan, a_codes: torch.Tensor, B_a: int,
                  bk: int = 8) -> torch.Tensor:
    """Schedule a single-output-tile plan, pack and sort the activation
    codes, run kernel 5. ``a_codes [M, K]`` (codes < 2^B_a) -> int32
    ``[M, D_p]``, on ``a_codes``' device."""
    sched = device_schedule(plan, 1, bk, a_codes.device, tiled=False)
    codes = pack_bitplanes(a_codes.to(torch.int8), B_a=B_a, G=plan.G)
    codes_sorted = codes.index_select(2, sched["cols"])
    return tlmac_gemm_clustered(codes_sorted, sched["idx_sorted"],
                                sched["table_pad"], B_a=B_a, G=plan.G)


def run_clustered_multi(plan, a_codes: torch.Tensor, B_a: int, N: int,
                        bk: int = 8) -> torch.Tensor:
    """Schedule a multi-output-tile plan, pack and sort the activation
    codes, run kernel 6 once. ``a_codes [M, K]`` -> int32 ``[M, N]``."""
    n_tiles = N // plan.exec_idx.shape[1]
    sched = device_schedule(plan, n_tiles, bk, a_codes.device, tiled=True)
    codes = pack_bitplanes(a_codes.to(torch.int8), B_a=B_a, G=plan.G)
    codes_sorted = codes.index_select(2, sched["cols"])
    return tlmac_gemm_clustered_multi(codes_sorted, sched["idx_sorted"],
                                      sched["table_pad"], B_a=B_a, G=plan.G)
