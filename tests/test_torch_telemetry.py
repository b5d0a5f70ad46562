"""Serve telemetry in the port against the JAX package's
(``serve/telemetry.py`` and the instrumented paged loop; the units of
``tests/test_telemetry.py``).

- Histograms and the metrics registry summarise the same seeded samples
  to the same numbers; ``validate_lifecycle`` accepts and rejects the
  same sequences; ``NULL`` is inert; ``annotate`` is a
  ``torch.profiler.record_function``.
- Loop level, under forced preemption and speculation, the port loop
  teacher-forced with the JAX loop's logits (as in
  ``tests/test_torch_serve.py``) emits the JAX loop's event stream: the
  same names, request ids and attributes in the same order (times
  aside), and a trace that validates.
- Telemetry on and off give identical tokens and forward sets;
  ``metrics()`` agrees with the per-subsystem stats; the Chrome and JSONL
  exports parse.
"""

import dataclasses
import json

import numpy as np
import pytest

import jax
import torch

from repro.configs import smoke_config as jsmoke
from repro.models import lm as jlm
from repro.serve import telemetry as jtel
from repro.serve.loop import Request as JRequest
from repro.serve.paged import PagedServeLoop as JLoop

from repro_torch import convert
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.serve import telemetry as ttel
from repro_torch.serve.loop import Request
from repro_torch.serve.paged import PagedServeLoop
from repro_torch.serve.telemetry import (NULL, Histogram, MetricsRegistry,
                                         Telemetry, validate_lifecycle)

ARCH = "codeqwen1.5-7b"
TIMES = ("ts", "dur")           # wall-clock fields of an event


# ---------------------------------------------------------------------------
# histogram / registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,n,cap", [(0, 1, 4), (1, 37, 64), (2, 200, 16),
                                        (3, 5000, 32), (4, 64, 64)])
def test_histogram_matches_jax(seed, n, cap):
    """The same samples give the same summary (exact below the cap, the
    same seeded reservoir past it), within [min, max], equal to
    np.percentile while every sample is kept."""
    xs = np.random.default_rng(seed).exponential(1.0, n)
    t, j = Histogram(cap=cap, tail_cap=8), jtel.Histogram(cap=cap, tail_cap=8)
    for x in xs:
        t.observe(x)
        j.observe(x)
    s = t.summary()
    assert s == j.summary()
    assert t.reservoir == j.reservoir and list(t.tail) == list(j.tail)
    assert s["count"] == n and np.isclose(s["sum"], xs.sum())
    for q in ("p50", "p90", "p99"):
        assert s["min"] <= s[q] <= s["max"]
    assert s["p50"] <= s["p90"] <= s["p99"]
    if n <= cap:
        assert s["p90"] == float(np.percentile(xs, 90))
    assert len(t.reservoir) <= cap and len(t.tail) <= 8
    t.reset()
    j.reset()
    assert np.isnan(t.summary()["mean"]) and np.isnan(j.summary()["mean"])
    assert t.count == 0 and t.reservoir == [] and len(t.tail) == 0


def test_registry_snapshot_matches_jax():
    rng = np.random.default_rng(5)
    t, j = MetricsRegistry(hist_cap=16), jtel.MetricsRegistry(hist_cap=16)
    for _ in range(300):
        op = int(rng.integers(0, 3))
        name = f"m{int(rng.integers(0, 3))}"
        v = float(rng.exponential(1.0))
        for r in (t, j):
            if op == 0:
                r.inc(name, int(v * 10))
            elif op == 1:
                r.set_gauge(name, np.int64(int(v * 10)))
            else:
                r.observe(name, np.float32(v))
    snap = t.snapshot()
    assert snap == j.snapshot()
    json.dumps(snap)
    assert t.get_counter("nope") == j.get_counter("nope") == 0
    t.reset()
    assert t.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}


def test_jsonable_coerces_numpy_and_torch():
    doc = {"a": np.int64(3), "b": np.float32(0.5), "c": np.bool_(True),
           "d": np.arange(3), "e": torch.tensor([1, 2]),
           "f": torch.tensor(2.5), 7: (np.int32(1),)}
    out = ttel.jsonable(doc)
    assert out == {"a": 3, "b": 0.5, "c": True, "d": [0, 1, 2],
                   "e": [1, 2], "f": 2.5, "7": [1]}
    json.dumps(out)
    numpy_only = {k: v for k, v in doc.items()
                  if not isinstance(v, torch.Tensor)}
    assert ttel.jsonable(numpy_only) == jtel.jsonable(numpy_only)


# ---------------------------------------------------------------------------
# lifecycle grammar, tracer, facade
# ---------------------------------------------------------------------------


def _ev(name, rid):
    return {"name": name, "rid": rid, "ts": 0.0, "dur": 0.0}


def _outcome(validate, events, **kw):
    try:
        return ("ok", validate(events, **kw))
    except AssertionError as e:
        return ("rejected", str(e))


def test_validate_lifecycle_matches_jax():
    """The same grammar, and the same verdict and message on seeded random
    sequences (mostly legal walks, some with one illegal step), on the
    reference's hand cases and on cut traces."""
    assert ttel.LIFECYCLE == jtel.LIFECYCLE
    assert ttel.LIFECYCLE_EVENTS == jtel.LIFECYCLE_EVENTS
    rng = np.random.default_rng(0)
    names = sorted(ttel.LIFECYCLE_EVENTS) + ["grow_page", "cow_copy"]
    verdicts = {"ok": 0, "rejected": 0}
    for trial in range(300):
        events = []
        for rid in range(int(rng.integers(1, 4))):
            prev = None
            for _ in range(int(rng.integers(1, 9))):
                legal = sorted(ttel.LIFECYCLE.get(prev, set()))
                if not legal or rng.random() < 0.08:
                    nxt = names[int(rng.integers(len(names)))]
                else:
                    nxt = legal[int(rng.integers(len(legal)))]
                events.append(_ev(nxt, rid if rng.random() < 0.95 else None))
                prev = nxt if nxt in ttel.LIFECYCLE_EVENTS else prev
        if trial % 10 == 0:                   # interleaved out of order
            rng.shuffle(events)
        for req in (True, False):
            got = _outcome(validate_lifecycle, events, require_finished=req)
            assert got == _outcome(jtel.validate_lifecycle, events,
                                   require_finished=req)
            verdicts[got[0]] += 1
    assert verdicts["ok"] > 50 and verdicts["rejected"] > 50
    ok = [_ev(n, 0) for n in ("submit", "queued", "admitted", "prefill_chunk",
                              "decode", "verify", "preempted", "queued",
                              "resumed", "prefill_chunk", "decode",
                              "finished")]
    assert validate_lifecycle(ok + [_ev("grow_page", 0),
                                    _ev("cow_copy", None)])[0][-1] == \
        "finished"
    for bad in (["queued"], ["submit", "queued", "admitted", "decode"],
                ["submit", "queued"]):
        with pytest.raises(AssertionError):
            validate_lifecycle([_ev(n, 1) for n in bad])


def test_tracer_exports_match_jax(tmp_path):
    """The same events exported by both tracers parse to the same
    documents (process name and epoch aside)."""
    docs = []
    for mod in (ttel, jtel):
        tr = mod.Tracer(max_events=4)
        tr.event("submit", 0, t0=0.0, prompt_tokens=5)
        tr.event("queued", 0, t0=0.5, t1=1.5)
        tr.event("finished", 0, t0=2.0, tokens=np.int64(3))
        tr.event("prefix_evict", None, t0=2.5, pages=1)
        tr.event("dropped_one", 1)
        assert len(tr.events) == 4 and tr.dropped == 1
        jp, cp = tmp_path / f"{mod.__name__}.jsonl", \
            tmp_path / f"{mod.__name__}.json"
        assert tr.export_jsonl(str(jp)) == 4
        tr.export_chrome(str(cp))
        lines = [json.loads(ln) for ln in jp.read_text().splitlines()]
        lines[0].pop("trace_epoch_unix_s")
        chrome = json.loads(cp.read_text())
        chrome["traceEvents"][0]["args"].pop("name")   # package name
        docs.append((lines, chrome))
    assert docs[0] == docs[1]
    lines, chrome = docs[0]
    assert lines[0] == {"events": 4, "dropped": 1}
    assert {e["ph"] for e in chrome["traceEvents"]} == {"M", "i", "X"}


def test_null_telemetry_is_inert():
    assert not NULL.enabled
    NULL.inc("x")
    NULL.observe("y", 1.0)
    NULL.set_gauge("z", 2.0)
    NULL.event("submit", 0)
    assert NULL.now() == 0.0 and NULL.rel(123.4) == 0.0
    with NULL.span("a"):
        with NULL.annotate("b"):
            pass
    assert NULL.export(chrome_path="/nonexistent/x.json") == \
        {"events": 0, "dropped": 0}
    assert NULL.registry is None and NULL.tracer is None


def test_annotate_is_a_profiler_range():
    """``annotate`` is a ``torch.profiler.record_function``, and the
    range shows up in a profile of the host."""
    tel = Telemetry()
    assert isinstance(tel.annotate("region"), torch.profiler.record_function)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tel.annotate("repro_torch.test.region"):
            torch.ones(4).sum()
    assert "repro_torch.test.region" in {e.key for e in prof.key_averages()}
    with tel.span("s", 3, k=1):
        pass
    assert tel.tracer.events[-1]["name"] == "s"


# ---------------------------------------------------------------------------
# the instrumented loop
# ---------------------------------------------------------------------------

_models = {}


def _model():
    if not _models:
        jcfg = dataclasses.replace(jsmoke(ARCH), serve_paged_attn_impl="lax")
        tcfg = dataclasses.replace(tsmoke(ARCH), serve_paged_attn_impl="lax")
        params, _ = jlm.init_lm(jax.random.PRNGKey(0), jcfg, purpose="serve")
        _models["m"] = (jcfg, tcfg, params, convert.params_from_jax(
            jax.tree.map(np.asarray, params), device="cpu"))
    return _models["m"]


# tests/test_telemetry.py's loop: three slots, a 10-page pool that forces
# preemption, speculation with the n-gram drafter
LOOP = dict(batch_slots=3, s_max=64, page_size=8, chunk=8)


def _submit_all(loop, R, vocab, n_req=5, max_new=10, seed=3):
    rng = np.random.default_rng(seed)
    for r in range(n_req):
        p = rng.integers(1, vocab, int(rng.integers(4, 20))).astype(np.int32)
        loop.submit(R(rid=r, prompt=p, max_new_tokens=max_new,
                      priority=r % 2))


def _port_loop(tel, n_pages, spec_k=0, **kw):
    _, tcfg, _, tp = _model()
    return PagedServeLoop(tp, tcfg, n_pages=n_pages, spec_k=spec_k,
                          telemetry=tel, check_invariants=True, device="cpu",
                          **LOOP, **kw)


FORWARDS = ("_prefill_chunk", "_decode", "_verify")


def _strip(events):
    return [{k: v for k, v in ev.items() if k not in TIMES}
            for ev in events]


def test_lifecycle_matches_jax_under_preemption_and_spec():
    """Forced preemption and speculation: the port loop, teacher-forced
    with the JAX loop's logits, emits JAX's event stream (names, rids and
    attributes in order); the trace validates, and the preempted tracks
    read preempted -> queued -> resumed."""
    jcfg, tcfg, params, tp = _model()
    jloop = JLoop(params, jcfg, n_pages=10, spec_k=2, telemetry=True,
                  check_invariants=True, **LOOP)
    logits = []
    for name in FORWARDS:
        fn = getattr(jloop, name)

        def rec(*a, _fn=fn):
            lg, caches = _fn(*a)
            logits.append(np.asarray(lg, np.float32))
            return lg, caches
        setattr(jloop, name, rec)
    _submit_all(jloop, JRequest, jcfg.vocab, max_new=14)
    jdone = {r.rid: r.output.tolist() for r in jloop.run()}

    loop = _port_loop(True, n_pages=10, spec_k=2)
    it = iter(logits)
    for name in FORWARDS:
        fn = getattr(loop, name)

        def forced(*a, _fn=fn):
            _fn(*a)
            return torch.from_numpy(next(it))
        setattr(loop, name, forced)
    _submit_all(loop, Request, tcfg.vocab, max_new=14)
    done = {r.rid: r.output.tolist() for r in loop.run()}
    assert next(it, None) is None
    assert done == jdone
    loop.check_compiled()
    assert loop.preemptions == jloop.preemptions > 0
    assert loop.spec_steps == jloop.spec_steps > 0
    got, want = loop.tel.tracer.events, jloop.tel.tracer.events
    assert _strip(got) == _strip(want)
    seqs = validate_lifecycle(got)
    assert seqs == jtel.validate_lifecycle(want) and len(seqs) == 5
    preempted = [s for s in seqs.values() if "preempted" in s]
    assert preempted
    for s in preempted:
        i = s.index("preempted")
        assert s[i + 1:i + 3] == ["queued", "resumed"]
    assert any("verify" in s for s in seqs.values())
    assert "grow_page" in {e["name"] for e in got}
    # spans carry times, in order, inside the run
    for e in got:
        assert e["dur"] >= 0.0 and e["ts"] >= -1e-6


def test_telemetry_on_off_identical_outputs_and_forwards():
    outs, shapes = {}, {}
    for tel in (True, False):
        loop = _port_loop(tel, n_pages=10, spec_k=2)
        _submit_all(loop, Request, loop.cfg.vocab, max_new=8)
        outs[tel] = {r.rid: r.output.tolist() for r in loop.run()}
        loop.check_compiled()
        shapes[tel] = loop.compiled_shapes()
        if not tel:
            assert loop.tel is NULL and loop.prefix.tel is NULL
    assert outs[True] == outs[False]
    assert shapes[True] == shapes[False] == \
        {"chunk": 1, "decode": 1, "verify": 1}


def test_metrics_agree_with_stats():
    loop = _port_loop(True, n_pages=16, spec_k=2)
    _submit_all(loop, Request, loop.cfg.vocab)
    loop.run()
    m = loop.metrics()
    assert set(m) == {"pool", "prefix_cache", "spec", "quant", "scheduler",
                      "swap", "tenants", "faults", "autotune", "telemetry"}
    assert set(m["autotune"]) == {"lookup_hits", "lookup_misses",
                                  "tuned_keys"}
    assert m["swap"] == {"enabled": False} and m["faults"] == {
        "enabled": False}
    assert m["tenants"] == ttel.jsonable(loop.tenant_stats())
    assert m["tenants"]["tenants"]["default"]["completed"] == 5
    for k, v in loop.spec_stats().items():
        assert m["spec"][k] == v
    assert m["spec"]["k"] == 2 and m["spec"]["gen_tokens"] == loop.gen_tokens
    assert m["scheduler"] == ttel.jsonable(loop.sched_stats())
    assert m["pool"] == ttel.jsonable(loop.pool_stats())
    assert m["prefix_cache"] == loop.prefix.stats()
    assert m["quant"] == {"kv_dtype": "fp", "quantised": False,
                          "pool_bytes": loop.kv_pool_bytes()}
    hists = m["telemetry"]["histograms"]
    for name in ("phase.prefill_chunk_s", "phase.reserve_s",
                 "phase.verify_s"):
        assert hists[name]["count"] > 0, name
    assert hists["phase.prefill_chunk_s"]["count"] == \
        sum(1 for e in loop.tel.tracer.events if e["name"] == "prefill_chunk")
    g = m["telemetry"]["gauges"]
    assert g == {"live_slots": 0, "queued": 0,
                 "pool_pages_in_use": loop.pages.in_use}
    for key in ("ttft_s", "queue_wait_s"):
        s = m["scheduler"][key]
        assert s["count"] == 5 and len(s["tail"]) <= ttel.TAIL_CAP
        assert s["min"] <= s["p50"] <= s["p99"] <= s["max"]
    json.dumps(m)
    off = _port_loop(False, n_pages=16)
    assert "telemetry" not in off.metrics()
    assert off.metrics()["spec"]["tokens_per_step"] == 0.0


def test_trace_export_from_loop(tmp_path):
    chrome = tmp_path / "trace.json"
    loop = _port_loop(True, n_pages=16, trace_path=str(chrome))
    _submit_all(loop, Request, loop.cfg.vocab, n_req=3, max_new=4)
    loop.run()                                # exports on drain
    doc = json.loads(chrome.read_text())
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"submit", "queued", "admitted", "prefill_chunk", "decode",
            "finished"} <= names
    lines = (tmp_path / "trace.jsonl").read_text().splitlines()
    head = json.loads(lines[0])
    assert head["events"] == len(lines) - 1 == len(loop.tel.tracer.events)
    assert [json.loads(ln)["name"] for ln in lines[1:]] == \
        [e["name"] for e in loop.tel.tracer.events]
    off = _port_loop(False, n_pages=16)
    assert off.export_trace(str(tmp_path / "off.json")) == {}
    assert not (tmp_path / "off.json").exists()
