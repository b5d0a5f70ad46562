"""Teacher-forced port-vs-JAX serve loops with the swap tier, fault
injection, cancellation, deadlines and tenants (shared by
``test_torch_swap.py`` and ``test_torch_faults.py``).

``run_pair`` runs the JAX ``PagedServeLoop`` on a workload and records,
in order, every forward (its inputs and logits) and every decision: each
accepted token run, copy-on-write copy, preemption, swap-out (the
blocks), swap-in (destination pages and the restored pages' checksums)
and cancel.  The port loop then runs the same workload with each forward
handing it JAX's logits of the same step, so both walk the same tokens;
every forward's inputs (tokens, positions, block tables, ``n_writes``)
and every decision must be equal at the same point of the sequence, each
forward's logits within ``LOGIT_TOL`` x its max |logit| (at least
``MIN_EXACT`` of them bit-equal), and at the end the fault, swap (less
the two measured rates), tenant and scheduler stats, the done and failed
sets, finish reasons, outputs and lifecycle sequences equal.

Both loops read one fake ``time.monotonic`` (patched into the scheduler
and loop modules of both packages), which ``drive`` advances by one
second per step: deadlines are decided by step count, never by the
host's speed.  ``swap_policy`` is pinned to ``'always'`` or ``'never'``:
``'auto'`` reads wall-clock rates.
"""

from __future__ import annotations

import dataclasses
import time
import types

import numpy as np
import torch

import jax

from repro.configs import smoke_config as jsmoke
from repro.models import lm as jlm
from repro.serve import faults as jfaults
from repro.serve import paged as jpaged_loop
from repro.serve import scheduler as jsched
from repro.serve import telemetry as jtel
from repro.serve.loop import Request as JRequest
from repro.serve.paged import PagedServeLoop as JLoop

from repro_torch import convert
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.serve import faults as tfaults
from repro_torch.serve import paged as tpaged_loop
from repro_torch.serve import scheduler as tsched
from repro_torch.serve import telemetry as ttel
from repro_torch.serve.loop import Request
from repro_torch.serve.paged import PagedServeLoop

ARCH = "codeqwen1.5-7b"
S_MAX = 48
LENGTHS = (6, 11, 3, 9, 5)              # tests/test_faults.py's workload
MAX_NEW = (12, 10, 8, 11, 9)
# x max |logit|, as tests/test_torch_serve.py: forwards differ from the
# jitted JAX loop's only where the logits GEMM sums in another order
LOGIT_TOL = 5e-2
MIN_EXACT = 0.75
FORWARDS = ("_prefill_chunk", "_decode", "_verify")
EVENTS = ("_accept", "_cow", "_preempt", "_swap_out", "_swap_restore",
          "cancel")

_models = {}


def model(kv="fp"):
    """(JAX cfg, JAX params, port cfg, port params) of the smoke model."""
    if kv not in _models:
        if "params" not in _models:
            jcfg = jsmoke(ARCH)
            params, _ = jlm.init_lm(jax.random.PRNGKey(0), jcfg,
                                    purpose="serve")
            _models["params"] = (params, convert.params_from_jax(
                jax.tree.map(np.asarray, params), device="cpu"))
        params, tp = _models["params"]
        _models[kv] = (dataclasses.replace(jsmoke(ARCH), serve_kv_dtype=kv),
                       params,
                       dataclasses.replace(tsmoke(ARCH), serve_kv_dtype=kv),
                       tp)
    return _models[kv]


def workload(vocab):
    rng = np.random.default_rng(7)
    return [(rng.integers(0, vocab, n).astype(np.int32), mn)
            for n, mn in zip(LENGTHS, MAX_NEW)]


class Clock:
    """A ``time`` stand-in whose ``monotonic`` reads ``t``."""

    def __init__(self):
        self.t = 1000.0

    def patch(self, monkeypatch):
        fake = types.SimpleNamespace(monotonic=lambda: self.t,
                                     perf_counter=time.perf_counter)
        for mod in (jsched, jpaged_loop, tsched, tpaged_loop):
            monkeypatch.setattr(mod, "time", fake)


def drive(loop, clock, until=None, max_steps=400):
    """Step ``loop`` (the clock one second on per step) until it drains,
    or until ``until(loop)`` is true after a step; returns that value."""
    for _ in range(max_steps):
        clock.t += 1.0
        more = loop.step()
        if until is not None:
            hit = until(loop)
            if hit:
                return hit
        if not more:
            return None
    raise AssertionError("loop did not drain")


def _event_args(kind, a, kw):
    if kind == "_accept":
        return [int(a[0]), [int(t) for t in a[2]]]
    if kind == "_swap_out":
        return [np.asarray(a[0]).tolist(), [int(b) for b in a[1]],
                kw.get("tenant")]
    if kind == "_swap_restore":
        return [[p.checksum for p in a[0]], [int(b) for b in a[1]]]
    return [int(x) for x in a]


def _stats(loop):
    sw = loop.swap_stats()
    if sw["enabled"]:
        sw = dict(sw, policy={k: v for k, v in sw["policy"].items()
                              if not k.endswith("_per_s")})
    sched = {k: v for k, v in loop.sched_stats().items()
             if k not in ("ttft_s", "queue_wait_s")}
    return dict(faults=loop.faults.stats(), swap=sw,
                tenants=loop.tenant_stats(), sched=sched,
                done={r.rid: (r.finish_reason, np.asarray(r.output).tolist())
                      for r in loop.done},
                failed={r.rid: (r.finish_reason, type(r.error).__name__,
                                np.asarray(r.output).tolist())
                        for r in loop.failed},
                spec=loop.spec_stats())


def _submit(loop, R, reqs):
    for i, (p, mn, kw) in enumerate(reqs):
        loop.submit(R(rid=i, prompt=p.copy(), max_new_tokens=mn, **kw))


def run_pair(monkeypatch, kv="fp", spec_k=0, loop_kw=None, req_kw=None,
             script=None, faults=None, reqs=None):
    """Run the JAX loop, then the teacher-forced port loop, on ``reqs``
    (default: ``workload`` with ``req_kw(i)`` keyword arguments per
    request).  ``script(loop, clock)`` drives a loop (default: ``drive``
    to the end); ``faults`` holds the ``FaultPlan`` fields, one plan of
    each package is made from them.  Returns the JAX
    loop, the port loop and the JAX stats (equal to the port's)."""
    jcfg, params, tcfg, tp = model(kv)
    loop_kw = {**dict(batch_slots=4, s_max=S_MAX, page_size=8, chunk=8,
                      n_pages=8, spec_k=spec_k, attn_impl="lax",
                      check_invariants=True, telemetry=True),
               **(loop_kw or {})}
    if reqs is None:
        reqs = [(p, mn, req_kw(i) if req_kw else {})
                for i, (p, mn) in enumerate(workload(tcfg.vocab))]
    script = script or (lambda loop, clock: drive(loop, clock))
    clock = Clock()
    clock.patch(monkeypatch)

    jloop = JLoop(params, jcfg, faults=jfaults.FaultPlan(**faults)
                  if faults else None, **loop_kw)
    log = []

    def record(kind, fn):
        def wrapper(*a, **kw):
            if kind in FORWARDS:
                logits, caches = fn(*a)
                # (params, caches, ...): copies, as the JAX loop mutates
                # its host buffers later
                log.append((kind, [np.array(x, copy=True) for x in a[2:]],
                            np.asarray(logits, np.float32)))
                return logits, caches
            log.append((kind, _event_args(kind, a, kw), None))
            return fn(*a, **kw)
        return wrapper
    names = [n for n in FORWARDS + EVENTS if getattr(jloop, n, None)]
    jitted = {n: getattr(jloop, n) for n in names}
    for n in names:
        setattr(jloop, n, record(n, getattr(jloop, n)))
    _submit(jloop, JRequest, reqs)
    script(jloop, clock)
    for n, fn in jitted.items():        # compiled_shapes reads the jits
        setattr(jloop, n, fn)
    want = _stats(jloop)
    want_life = jtel.validate_lifecycle(jloop.tel.tracer.events)

    clock.t = 1000.0
    loop = PagedServeLoop(tp, tcfg, faults=tfaults.FaultPlan(**faults)
                          if faults else None, device="cpu", **loop_kw)
    it = iter(log)
    pairs = []

    def forced(kind, fn):
        def wrapper(*a, **kw):
            jkind, jargs, jlogits = next(it)
            assert kind == jkind, (kind, jkind)
            if kind in FORWARDS:
                mine = [np.asarray(x) for x in a]
                assert len(mine) == len(jargs), kind
                for m, j in zip(mine, jargs):
                    assert np.array_equal(m, j), kind
                out = fn(*a)
                pairs.append((out.float().numpy(), jlogits))
                return torch.from_numpy(jlogits)
            assert _event_args(kind, a, kw) == jargs, (kind, jargs)
            return fn(*a, **kw)
        return wrapper
    for n in names:
        setattr(loop, n, forced(n, getattr(loop, n)))
    _submit(loop, Request, reqs)
    script(loop, clock)
    assert next(it, None) is None               # the same number of events
    assert _stats(loop) == want
    assert ttel.validate_lifecycle(loop.tel.tracer.events) == want_life
    exact = sum(np.array_equal(g, w) for g, w in pairs)
    assert exact >= MIN_EXACT * len(pairs), (exact, len(pairs))
    for got, w in pairs:
        np.testing.assert_allclose(got, w, atol=LOGIT_TOL * np.abs(w).max(),
                                   rtol=0)
    loop.check_compiled()
    loop.pages.check()
    loop.sched.check()
    if loop.prefix is not None:
        loop.prefix.check()
        loop.prefix.evict(10 ** 6)
    assert loop.pages.in_use == 0, "pool pages leaked"
    if loop.swap is not None:
        loop.swap.check()
    return jloop, loop, want
