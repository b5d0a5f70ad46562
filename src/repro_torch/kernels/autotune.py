"""Shape-keyed autotuner behind ``ops.tlmac_matmul(impl="auto")`` and
``paged.paged_attention(impl="auto")`` (port of ``repro.kernels.autotune``).

The tuner runs every candidate on the concrete operands, holds its output
against the oracle first (int32-equal to ``'ref'`` for the lookup GEMM,
within ``rtol = atol = 2e-2`` of ``'lax'`` for attention), then times it
(median of ``reps`` samples after a warm-up; on the card CUDA events
around the replay of a CUDA graph of ``GRAPH_CALLS`` calls, as the serve
path replays its captured forwards, so the host's dispatch between
calls is not timed) and persists the winner to a JSON cache, so later
processes and CUDA graph captures, which cannot time, reuse it.  The
winner must also beat the baseline (the impl a miss dispatches) in an
interleaved re-match.

Unlike the reference, a candidate may be skipped only for a wrapper's
typed shape refusal (``ValueError``).  A wrong result raises
``CandidateMismatch``, and a build or launch error propagates: a kernel
silently dropped from the sweep would be a fallback.

Candidates: on the card, kernel 1 (``'fused'``) and kernels 4 + 3
(``'pallas'``) for the GEMM, kernel 2 at 1, 2, 4 and 8 splits and the
gathered ``'lax'`` reader for attention.  On the CPU only the plain
versions run (``'ref'`` and ``'lax'``, beside the baseline), as the
reference's Pallas candidates join only on the TPU.

Cache file: ``$REPRO_TORCH_AUTOTUNE_CACHE`` if set, else
``~/.cache/repro_torch/autotune.json``; never the reference's file, whose
winners name impls (``xla-flat``, ``xla-kscan``) this package does not
have.  Keys keep the reference's format, the backend taken from the
operands' device (``cuda`` or ``cpu``)::

    {"v1|cuda|M4,K4096,N4096,Ba3,G4,dp128,R2048":
        {"config": {"impl": "fused"}, "us": 48.1,
         "baseline_us": {"fused": 48.1}}, ...}

Concurrent writers merge under an ``fcntl`` lock.  ``generation`` moves
at every ``record``/``reset_cache`` and when ``_load`` reads another file
(the env path changed), so callers may memoise resolved configs by
``(cache_path(), generation)`` and re-resolve only when the cache
changed.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

try:
    import fcntl
except ImportError:  # non-POSIX: merge without the lock
    fcntl = None

CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
DEFAULT_IMPL = "fused"
ATTN_DEFAULT = {"impl": "flash", "n_splits": 4}
ATTN_RTOL = ATTN_ATOL = 2e-2
_SCHEMA = "v1"

_lock = threading.RLock()
_cache: Optional[Dict[str, Any]] = None
_cache_file: Optional[str] = None
generation: int = 0

_stats_lock = threading.Lock()
_registry_obj = None       # serve.telemetry.MetricsRegistry, made on first use
_tuned_keys: List[str] = []


class CandidateMismatch(RuntimeError):
    """A candidate's output differs from the oracle's."""


def _registry():
    global _registry_obj
    if _registry_obj is None:
        from repro_torch.serve.telemetry import MetricsRegistry

        _registry_obj = MetricsRegistry()
    return _registry_obj


def reset_stats() -> None:
    _registry().reset()
    with _stats_lock:
        _tuned_keys.clear()


def snapshot_stats() -> Dict[str, Any]:
    """The process-local lookup and tune counters
    (``PagedServeLoop.metrics()['autotune']``)."""
    with _stats_lock:
        return {"lookup_hits": int(_registry().get_counter("lookup_hits")),
                "lookup_misses": int(_registry().get_counter("lookup_misses")),
                "tuned_keys": list(_tuned_keys)}


# ---------------------------------------------------------------------------
# cache persistence
# ---------------------------------------------------------------------------


def cache_path() -> str:
    return os.environ.get(CACHE_ENV) or os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch", "autotune.json")


def _load() -> Dict[str, Any]:
    """The cache, read once per path (re-read, and ``generation`` moved,
    when the env path changes)."""
    global _cache, _cache_file, generation
    path = cache_path()
    with _lock:
        if _cache is not None and _cache_file == path:
            return _cache
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            data = {}
        if _cache_file is not None and _cache_file != path:
            generation += 1
        _cache, _cache_file = data, path
        return data


def _save() -> None:
    """Merge the in-memory entries into the file under an exclusive lock
    (another process may have written between our read and our replace;
    our entries win for keys both touched)."""
    global _cache
    path = cache_path()
    with _lock:
        data = _cache or {}
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            lock_f = open(path + ".lock", "w")
        except OSError:
            return  # read-only file system: tuned, not persisted
        try:
            if fcntl is not None:
                fcntl.flock(lock_f, fcntl.LOCK_EX)
            try:
                with open(path) as f:
                    disk = json.load(f)
            except (OSError, ValueError):
                disk = {}
            disk.update(data)
            _cache = data = disk
            tmp = path + f".tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(data, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except OSError:
            pass  # read-only file system: tuned, not persisted
        finally:
            lock_f.close()


def reset_cache() -> None:
    """Drop the in-memory cache (tests, or after changing the env path)."""
    global _cache, _cache_file, generation
    with _lock:
        _cache, _cache_file = None, None
        generation += 1


# ---------------------------------------------------------------------------
# keys and candidates
# ---------------------------------------------------------------------------


def _backend(device) -> str:
    return torch.device(device).type


def shape_key(M: int, K: int, N: int, *, B_a: int, G: int, D_p: int,
              R: int, device="cuda") -> str:
    return (f"{_SCHEMA}|{_backend(device)}|M{M},K{K},N{N},"
            f"Ba{B_a},G{G},dp{D_p},R{R}")


def candidates(device="cuda") -> List[Dict[str, Any]]:
    """GEMM candidates: the kernels on the card, the plain oracle on the
    CPU (the baseline joins in ``tune``)."""
    if _backend(device) == "cuda":
        return [{"impl": "fused"}, {"impl": "pallas"}]
    return [{"impl": "ref"}]


def lookup(key: str) -> Optional[Dict[str, Any]]:
    """The winning config of a shape key, or None.  A host-side dict read:
    safe during CUDA graph capture."""
    entry = _load().get(key)
    _registry().inc("lookup_hits" if entry else "lookup_misses")
    return dict(entry["config"]) if entry else None


def record(key: str, config: Dict[str, Any], us: float,
           baseline_us: Optional[Dict[str, float]] = None) -> None:
    global generation
    with _lock:
        data = _load()
        data[key] = {"config": config, "us": us,
                     "baseline_us": baseline_us or {}}
        generation += 1
        _save()
    _registry().inc("tunes")
    with _stats_lock:
        if key not in _tuned_keys:
            _tuned_keys.append(key)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def _check_not_capturing(device) -> None:
    if _backend(device) == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("autotune times candidates and cannot run during "
                           "CUDA graph capture: tune before the capture")


def _timer(device) -> Callable[[Callable[[], Any]], float]:
    """A one-call timer in µs: CUDA events on the card, the host clock on
    the CPU."""
    if _backend(device) == "cuda":
        def t(fn):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) * 1e3
        return t

    def t(fn):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e6
    return t


GRAPH_CALLS = 10    # calls of a candidate in one timing graph on the card
_side_streams: Dict[int, Any] = {}


def _sample(fn, device) -> Tuple[Callable[[], Any], int]:
    """What one timing sample runs, and how many calls of ``fn`` that is:
    on the card ``GRAPH_CALLS`` calls captured in one CUDA graph (a
    decode-attention kernel runs for about 12 µs, its Python dispatch for
    about 150, and the serve path replays graphs); on the CPU ``fn``."""
    if _backend(device) != "cuda":
        return fn, 1
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _side_streams:   # one warm-up stream: cuBLAS keeps a
        _side_streams[idx] = torch.cuda.Stream(idx)   # workspace per stream
    side, cur = _side_streams[idx], torch.cuda.current_stream(idx)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        fn()
    cur.wait_stream(side)
    torch.cuda.synchronize(idx)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(GRAPH_CALLS):
            fn()
    return graph.replay, GRAPH_CALLS


def _time(fn, reps: int, device) -> float:
    run, calls = _sample(fn, device)
    run()  # warm-up
    timer = _timer(device)
    return float(np.median([timer(run) for _ in range(reps)])) / calls


def _ab(fn_a, fn_b, reps: int, device) -> Tuple[float, float]:
    """Median µs a call of two impls measured in turns, so drift hits
    both alike."""
    (run_a, calls_a), (run_b, calls_b) = (_sample(fn_a, device),
                                          _sample(fn_b, device))
    run_a(), run_b()  # warm-up
    timer = _timer(device)
    ta, tb = [], []
    for _ in range(reps):
        ta.append(timer(run_a))
        tb.append(timer(run_b))
    return (float(np.median(ta)) / calls_a, float(np.median(tb)) / calls_b)


def _rematch_and_record(key, best_cfg, best_us, baseline_cfg, baseline_us,
                        make_run, reps: int, device):
    """The winner must beat the baseline again, timed in turns, before it
    is recorded (a near-tie decided by drift keeps the baseline)."""
    if baseline_us is not None and best_cfg != baseline_cfg:
        best_us, baseline_us = _ab(make_run(best_cfg), make_run(baseline_cfg),
                                   max(reps, 9), device)
        if best_us >= baseline_us:
            best_cfg, best_us = baseline_cfg, baseline_us
    baseline = ({baseline_cfg["impl"]: baseline_us}
                if baseline_us is not None else {})
    record(key, best_cfg, best_us, baseline)
    return dict(best_cfg)


def _sweep(cands, baseline_cfg, run, check, reps: int, device):
    """Verify then time each candidate; returns (best config, its µs, the
    baseline's µs).  Only a typed shape refusal skips a candidate."""
    if not any(c == baseline_cfg for c in cands):
        cands = list(cands) + [baseline_cfg]
    best_cfg, best_us, baseline_us = None, float("inf"), None
    for cand in cands:
        try:
            out = run(cand)
        except ValueError:
            continue
        check(cand, out)
        us = _time(lambda cand=cand: run(cand), reps, device)
        if cand == baseline_cfg:
            baseline_us = us
        if us < best_us:
            best_cfg, best_us = cand, us
    return best_cfg, best_us, baseline_us


# ---------------------------------------------------------------------------
# the lookup GEMM
# ---------------------------------------------------------------------------


def tune(a_codes, table, exec_idx, step_cluster, *, B_a: int, G: int, N: int,
         reps: int = 5, cands: Optional[List[Dict[str, Any]]] = None,
         verify: bool = True) -> Dict[str, Any]:
    """Verify, time and record the candidates of one GEMM shape on
    concrete operands; returns the winner's config (the baseline, not
    recorded, when every candidate refused the shape)."""
    from repro_torch.kernels import ops, ref as _ref

    dev = a_codes.device
    _check_not_capturing(dev)
    M, K = a_codes.shape
    key = shape_key(M, K, N, B_a=B_a, G=G, D_p=exec_idx.shape[-1],
                    R=int(np.prod(table.shape[:-1])), device=dev)
    want = (_ref.tlmac_matmul_ref(a_codes, table, exec_idx, step_cluster,
                                  B_a, G, N) if verify else None)

    def run(cfg):
        return ops.dispatch_config(cfg, a_codes, table, exec_idx,
                                   step_cluster, B_a=B_a, G=G, N=N)

    def check(cfg, out):
        if want is not None and not torch.equal(out, want):
            raise CandidateMismatch(
                f"lookup GEMM candidate {cfg} differs from 'ref' at {key}")

    baseline_cfg = {"impl": DEFAULT_IMPL}
    best_cfg, best_us, baseline_us = _sweep(
        candidates(dev) if cands is None else cands, baseline_cfg, run, check,
        reps, dev)
    if best_cfg is None:
        return baseline_cfg
    return _rematch_and_record(key, best_cfg, best_us, baseline_cfg,
                               baseline_us, lambda c: lambda: run(c), reps,
                               dev)


def lookup_or_default(M: int, K: int, N: int, *, B_a: int, G: int, D_p: int,
                      R: int, device="cuda",
                      default_impl: str = DEFAULT_IMPL) -> Dict[str, Any]:
    """Host-side resolution: the cached winner, else the default."""
    cfg = lookup(shape_key(M, K, N, B_a=B_a, G=G, D_p=D_p, R=R,
                           device=device))
    return cfg if cfg is not None else {"impl": default_impl}


# ---------------------------------------------------------------------------
# paged decode attention (kernels/paged.py): same tuner, same cache
# ---------------------------------------------------------------------------


def attn_shape_key(B: int, KV: int, rep: int, hd: int, MB: int, P: int,
                   window=None, kv_dtype: str = "fp", device="cuda") -> str:
    w = "none" if window is None else int(window)
    q = "" if kv_dtype == "fp" else f",q{kv_dtype}"
    return (f"{_SCHEMA}|{_backend(device)}|attn|B{B},KV{KV},rep{rep},"
            f"hd{hd},MB{MB},P{P},W{w}{q}")


def attention_candidates(device="cuda") -> List[Dict[str, Any]]:
    """Paged-attention candidates: kernel 2 at 1, 2, 4 and 8 splits and
    the gathered reader on the card; the gathered reader on the CPU (the
    baseline joins in ``tune_attention``)."""
    cands: List[Dict[str, Any]] = [{"impl": "lax"}]
    if _backend(device) == "cuda":
        cands += [{"impl": "flash", "n_splits": s} for s in (1, 2, 4, 8)]
    return cands


def tune_attention(q, k_pages, v_pages, block_table, positions, *,
                   window=None, reps: int = 5,
                   cands: Optional[List[Dict[str, Any]]] = None,
                   verify: bool = True, k_scales=None, v_scales=None,
                   qspec=None) -> Dict[str, Any]:
    """Verify-then-time tuning of paged decode attention: each candidate
    within ``rtol = atol = 2e-2`` of the ``'lax'`` reader (floats: the
    split-K paths reassociate the softmax), then timed; the winner is
    recorded under an ``attn|`` key of the same cache, quantised pools
    under their own kv dtype."""
    from repro_torch.kernels import paged

    dev = q.device
    _check_not_capturing(dev)
    qspec = qspec or paged.KVQuantSpec()
    B, _, H, hd = q.shape
    KV = k_pages.shape[2]
    key = attn_shape_key(B, KV, H // KV, hd, block_table.shape[1],
                         k_pages.shape[1], window, kv_dtype=qspec.dtype,
                         device=dev)

    def run(cfg):
        return paged.dispatch_attention(
            cfg, q, k_pages, v_pages, block_table, positions, window=window,
            k_scales=k_scales, v_scales=v_scales, qspec=qspec)

    want = run({"impl": "lax"}).float() if verify else None

    def check(cfg, out):
        if want is not None and not torch.allclose(
                out.float(), want, rtol=ATTN_RTOL, atol=ATTN_ATOL):
            raise CandidateMismatch(
                f"paged attention candidate {cfg} differs from 'lax' beyond "
                f"{ATTN_RTOL} at {key}")

    baseline_cfg = dict(ATTN_DEFAULT)
    best_cfg, best_us, baseline_us = _sweep(
        attention_candidates(dev) if cands is None else cands, baseline_cfg,
        run, check, reps, dev)
    if best_cfg is None:
        return baseline_cfg
    return _rematch_and_record(key, best_cfg, best_us, baseline_cfg,
                               baseline_us, lambda c: lambda: run(c), reps,
                               dev)
