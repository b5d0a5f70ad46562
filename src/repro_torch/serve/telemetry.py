"""Serve-loop observability: metrics registry and lifecycle tracer (port
of ``repro.serve.telemetry``; host-side, a copy of the reference's with
``torch.profiler.record_function`` in place of the JAX trace
annotation).

- **Metrics registry** (``MetricsRegistry``): named counters, gauges and
  bounded histograms.  A histogram keeps running count/sum/min/max plus
  a fixed-size uniform reservoir (algorithm R, seeded PRNG) for
  p50/p90/p99 and a capped most-recent tail: O(1) memory at any volume.
- **Lifecycle tracer** (``Tracer``): typed span events per request,
  ``submit -> queued -> admitted/resumed -> prefill_chunk* ->
  decode/verify* -> preempted -> (queued -> resumed -> ...) ->
  finished``, each with wall time and page/token attributes.
  ``LIFECYCLE`` is the transition relation; ``validate_lifecycle``
  checks a trace against it.
- **Exporters**: ``export_jsonl`` (one event per line) and
  ``export_chrome`` (Chrome trace-event JSON: one track per request plus
  a ``serve-loop`` track).
- **Profiler alignment**: ``Telemetry.annotate`` returns a
  ``torch.profiler.record_function`` range, and the forwards carry
  ``record_function`` ranges of their own (``models/lm.py``), so a
  ``torch.profiler`` trace lines up with the host spans.  Around a CUDA
  graph replay such a range marks the host's launch of the replay only:
  the kernels of a replay are not attributed to ranges recorded inside
  the captured function.

The loop's decode and verify spans (``phase.decode_s``,
``phase.verify_s``) end after the host has read the forward's argmax,
which waits for the device; with telemetry on the loop also waits for
the device at the end of each prefill chunk and copy-on-write copy.  So
every ``phase.*_s`` covers the device's work, not only its launch.

Everything here is host-side Python around the forwards: telemetry on or
off computes the same tokens and captures the same graphs.  Off, the
loop holds the shared ``NULL`` facade, whose hooks do nothing.
"""

from __future__ import annotations

import json
import random
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

# Bounded-memory defaults.  Below the reservoir cap every sample is kept,
# so summaries equal np.percentile over the raw list; the tail cap bounds
# the most recent raw samples kept; the event cap bounds the tracer
# (drops are counted).
RESERVOIR_CAP = 512
TAIL_CAP = 32
MAX_EVENTS = 200_000


def jsonable(obj):
    """Recursively coerce numpy and torch scalars/arrays so a metrics
    snapshot or trace document dumps with the stdlib ``json`` module."""
    if isinstance(obj, dict):
        return {str(k): jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, deque)):
        return [jsonable(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().tolist()     # Python scalars or lists
    if isinstance(obj, np.ndarray):
        return [jsonable(v) for v in obj.tolist()]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    return obj


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


class Histogram:
    """Streaming histogram with bounded memory.

    ``count``/``sum``/``min``/``max`` are exact; quantiles come from a
    fixed-size uniform reservoir (algorithm R: sample ``i`` past the cap
    replaces a random slot with probability ``cap/i``, seeded).  While
    ``count <= cap`` the reservoir is the whole sample set and
    ``quantile(q)`` equals ``np.percentile(raw, q)``.  A
    ``deque(maxlen=tail_cap)`` keeps the most recent raw samples."""

    __slots__ = ("cap", "count", "total", "vmin", "vmax",
                 "reservoir", "tail", "_rng")

    def __init__(self, cap: int = RESERVOIR_CAP, tail_cap: int = TAIL_CAP,
                 seed: int = 0):
        self.cap = int(cap)
        self.tail = deque(maxlen=int(tail_cap))
        self._rng = random.Random(seed)
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self.reservoir: List[float] = []

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        if len(self.reservoir) < self.cap:
            self.reservoir.append(v)
        else:
            j = self._rng.randrange(self.count)
            if j < self.cap:
                self.reservoir[j] = v
        self.tail.append(v)

    def reset(self) -> None:
        self.tail.clear()
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self.reservoir = []

    def quantile(self, q: float) -> float:
        """q in [0, 100], np.percentile semantics over the reservoir."""
        if not self.reservoir:
            return float("nan")
        return float(np.percentile(self.reservoir, q))

    def summary(self) -> Dict[str, Any]:
        if self.count == 0:
            return {"count": 0, "sum": 0.0, "mean": float("nan"),
                    "min": float("nan"), "max": float("nan"),
                    "p50": float("nan"), "p90": float("nan"),
                    "p99": float("nan"), "tail": []}
        return {
            "count": self.count,
            "sum": self.total,
            "mean": self.total / self.count,
            "min": self.vmin,
            "max": self.vmax,
            "p50": self.quantile(50),
            "p90": self.quantile(90),
            "p99": self.quantile(99),
            "tail": list(self.tail),
        }


class MetricsRegistry:
    """Named counters, gauges and histograms behind one lock.
    ``snapshot()`` returns a JSON-serialisable dict (histograms as
    quantile summaries)."""

    def __init__(self, hist_cap: int = RESERVOIR_CAP,
                 tail_cap: int = TAIL_CAP):
        self._lock = threading.Lock()
        self._hist_cap = int(hist_cap)
        self._tail_cap = int(tail_cap)
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, Histogram] = {}

    def inc(self, name: str, v: float = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + v

    def set_gauge(self, name: str, v: float) -> None:
        with self._lock:
            self.gauges[name] = v

    def observe(self, name: str, v: float) -> None:
        with self._lock:
            h = self.histograms.get(name)
            if h is None:
                h = self.histograms[name] = Histogram(
                    self._hist_cap, self._tail_cap)
            h.observe(v)

    def get_counter(self, name: str) -> float:
        with self._lock:
            return self.counters.get(name, 0)

    def histogram(self, name: str) -> Histogram:
        """Get-or-create (the returned Histogram is single-writer)."""
        with self._lock:
            h = self.histograms.get(name)
            if h is None:
                h = self.histograms[name] = Histogram(
                    self._hist_cap, self._tail_cap)
            return h

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.histograms.clear()

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return jsonable({
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "histograms": {k: h.summary()
                               for k, h in self.histograms.items()},
            })


# ---------------------------------------------------------------------------
# lifecycle tracing
# ---------------------------------------------------------------------------

# Request-lifecycle transition relation: event N+1 of a request must be in
# LIFECYCLE[event N] (None keys the start state).  ``queued`` is a span
# covering the wait, emitted at admission (so it follows ``preempted`` on
# a resume); ``admitted`` marks a first admission, ``resumed`` a
# re-admission.  The swap and cancel states are the reference's grammar,
# kept whole so that traces of either package validate alike.
LIFECYCLE: Dict[Optional[str], set] = {
    None: {"submit"},
    "submit": {"queued", "cancelled"},
    "queued": {"admitted", "resumed", "swapped_in", "cancelled"},
    "admitted": {"prefill_chunk", "cancelled"},
    "resumed": {"prefill_chunk", "cancelled"},
    "swapped_in": {"admitted", "resumed", "cancelled"},
    "prefill_chunk": {"prefill_chunk", "decode", "verify", "finished",
                      "preempted", "cancelled"},
    "decode": {"decode", "verify", "finished", "preempted", "cancelled"},
    "verify": {"decode", "verify", "finished", "preempted", "cancelled"},
    "preempted": {"queued", "swapped_out", "cancelled"},
    "swapped_out": {"queued", "cancelled"},
    "finished": set(),
    "cancelled": set(),
}

# Names the grammar governs; other rid events (``grow_page``) ride the
# request's track in exports but are not lifecycle states.
LIFECYCLE_EVENTS = {n for s in LIFECYCLE.values() for n in s}


def validate_lifecycle(events: Iterable[dict],
                       require_finished: bool = True) -> Dict[int, List[str]]:
    """Check every request's event sequence (in emission order) against
    ``LIFECYCLE``.  Raises AssertionError naming the request and the
    transition; returns ``{rid: [event names]}``.  ``require_finished``
    also asserts every request reached ``finished`` or ``cancelled``."""
    seqs: Dict[int, List[str]] = {}
    for ev in events:
        rid = ev.get("rid")
        if rid is None or ev["name"] not in LIFECYCLE_EVENTS:
            continue
        seqs.setdefault(rid, []).append(ev["name"])
    for rid, names in seqs.items():
        prev: Optional[str] = None
        for n in names:
            allowed = LIFECYCLE.get(prev, set())
            assert n in allowed, (
                f"request {rid}: illegal lifecycle transition "
                f"{prev!r} -> {n!r} (full sequence: {names})")
            prev = n
        if require_finished:
            assert prev in ("finished", "cancelled"), \
                f"request {rid} never reached a terminal state " \
                f"(last event {prev!r})"
    return seqs


class Tracer:
    """Append-only span/event log with wall-clock timestamps.

    Events are dicts ``{"name", "rid", "ts", "dur", ...attrs}`` with
    ``ts``/``dur`` in seconds from the tracer's epoch (``time.monotonic``
    at construction; ``t_wall_epoch`` is the matching UTC time).  ``rid``
    is None for serve-loop events.  Capped at ``max_events``; events past
    it are counted in ``dropped``."""

    def __init__(self, max_events: int = MAX_EVENTS):
        self.max_events = int(max_events)
        self.events: List[dict] = []
        self.dropped = 0
        self.t0 = time.monotonic()
        self.t_wall_epoch = time.time()

    def now(self) -> float:
        return time.monotonic() - self.t0

    def event(self, name: str, rid: Optional[int] = None,
              t0: Optional[float] = None, t1: Optional[float] = None,
              **attrs) -> None:
        """Record one event; omitted ``t0`` stamps now, omitted ``t1``
        makes it an instant (dur 0)."""
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        ts = self.now() if t0 is None else t0
        ev = {"name": name, "rid": rid, "ts": ts,
              "dur": 0.0 if t1 is None else max(0.0, t1 - ts)}
        if attrs:
            ev.update(attrs)
        self.events.append(ev)

    @contextmanager
    def span(self, name: str, rid: Optional[int] = None, **attrs):
        t0 = self.now()
        try:
            yield
        finally:
            self.event(name, rid, t0=t0, t1=self.now(), **attrs)

    def reset(self) -> None:
        self.events = []
        self.dropped = 0
        self.t0 = time.monotonic()
        self.t_wall_epoch = time.time()

    # -- exporters ----------------------------------------------------------

    def export_jsonl(self, path: str) -> int:
        """One JSON object per line (first line: epoch header).  Returns
        the number of events written."""
        with open(path, "w") as f:
            f.write(json.dumps({"trace_epoch_unix_s": self.t_wall_epoch,
                                "events": len(self.events),
                                "dropped": self.dropped}) + "\n")
            for ev in self.events:
                f.write(json.dumps(jsonable(ev)) + "\n")
        return len(self.events)

    def export_chrome(self, path: str) -> int:
        """Chrome trace-event JSON (``chrome://tracing`` / Perfetto): one
        track per request (``req <rid>``, tid rid + 1) plus tid 0
        (``serve-loop``); ``ts``/``dur`` in microseconds.  Spans are
        complete events (ph 'X'), zero-duration marks instants (ph
        'i')."""
        trace: List[dict] = [{
            "name": "process_name", "ph": "M", "pid": 0, "tid": 0,
            "args": {"name": "repro_torch.serve"},
        }, {
            "name": "thread_name", "ph": "M", "pid": 0, "tid": 0,
            "args": {"name": "serve-loop"},
        }]
        named = set()
        for ev in self.events:
            rid = ev.get("rid")
            tid = 0 if rid is None else int(rid) + 1
            if tid != 0 and tid not in named:
                named.add(tid)
                trace.append({"name": "thread_name", "ph": "M", "pid": 0,
                              "tid": tid, "args": {"name": f"req {rid}"}})
            args = {k: v for k, v in ev.items()
                    if k not in ("name", "rid", "ts", "dur")}
            base = {"name": ev["name"], "pid": 0, "tid": tid,
                    "ts": ev["ts"] * 1e6, "cat": "serve",
                    "args": jsonable(args)}
            if ev["dur"] > 0.0:
                base.update(ph="X", dur=ev["dur"] * 1e6)
            else:
                base.update(ph="i", s="t")
            trace.append(base)
        with open(path, "w") as f:
            json.dump({"traceEvents": trace, "displayTimeUnit": "ms"}, f)
        return len(self.events)


# ---------------------------------------------------------------------------
# facade
# ---------------------------------------------------------------------------


class _NullContext:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullContext()


class Telemetry:
    """The enabled facade: registry + tracer + profiler ranges."""

    enabled = True

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None):
        self.registry = registry or MetricsRegistry()
        self.tracer = tracer or Tracer()

    def now(self) -> float:
        return self.tracer.now()

    def rel(self, t_monotonic: float) -> float:
        """An absolute ``time.monotonic()`` stamp in tracer seconds."""
        return t_monotonic - self.tracer.t0

    def inc(self, name: str, v: float = 1) -> None:
        self.registry.inc(name, v)

    def set_gauge(self, name: str, v: float) -> None:
        self.registry.set_gauge(name, v)

    def observe(self, name: str, v: float) -> None:
        self.registry.observe(name, v)

    def event(self, name: str, rid: Optional[int] = None,
              t0: Optional[float] = None, t1: Optional[float] = None,
              **attrs) -> None:
        self.tracer.event(name, rid, t0=t0, t1=t1, **attrs)

    def span(self, name: str, rid: Optional[int] = None, **attrs):
        return self.tracer.span(name, rid, **attrs)

    def annotate(self, name: str):
        """A host range that a ``torch.profiler`` session records, which
        lines a device profile up with the host spans."""
        return torch.profiler.record_function(name)

    def export(self, chrome_path: Optional[str] = None,
               jsonl_path: Optional[str] = None) -> Dict[str, Any]:
        out: Dict[str, Any] = {"events": len(self.tracer.events),
                               "dropped": self.tracer.dropped}
        if chrome_path:
            self.tracer.export_chrome(chrome_path)
            out["chrome"] = chrome_path
        if jsonl_path:
            self.tracer.export_jsonl(jsonl_path)
            out["jsonl"] = jsonl_path
        return out


class _NullTelemetry:
    """Shared no-op facade: every hook is an empty method or a reused
    null context, nothing allocates and nothing reads the clock."""

    enabled = False
    registry = None
    tracer = None
    __slots__ = ()

    def now(self) -> float:
        return 0.0

    def rel(self, t_monotonic: float) -> float:
        return 0.0

    def inc(self, name: str, v: float = 1) -> None:
        pass

    def set_gauge(self, name: str, v: float) -> None:
        pass

    def observe(self, name: str, v: float) -> None:
        pass

    def event(self, name: str, rid: Optional[int] = None,
              t0: Optional[float] = None, t1: Optional[float] = None,
              **attrs) -> None:
        pass

    def span(self, name: str, rid: Optional[int] = None, **attrs):
        return _NULL_CTX

    def annotate(self, name: str):
        return _NULL_CTX

    def export(self, chrome_path: Optional[str] = None,
               jsonl_path: Optional[str] = None) -> Dict[str, Any]:
        return {"events": 0, "dropped": 0}


NULL = _NullTelemetry()
