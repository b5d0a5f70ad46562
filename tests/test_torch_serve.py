"""Port ``PagedServeLoop`` vs the JAX ``PagedServeLoop`` (speculation
off; lax attention), with the prefix cache and on-demand pages off and
under the reference's defaults (both on, priority preemption), on the
workload of ``tests/test_serve_oracle.py``, on shared-prefix prompts and
under pool pressure; plus the typed admission errors, ``PageManager``
units and the package-hygiene check.

The loop comparison is teacher-forced: every forward of the port loop
records its own logits and hands the loop the JAX loop's logits of the
same step, so both loops walk the same token sequence and admit, page,
copy, preempt and finish identically.  Block tables, starts, ``last``,
positions and input tokens must then be equal at every forward, the
copy-on-write copies and preemptions equal and in the same order, and
each step's logits equal within ``LOGIT_TOL``.  Greedy tokens are
compared only where JAX's top-2 margin clears the tolerance: random-init
smoke models have near-tied argmaxes.
"""

import ast
import dataclasses
import os

import numpy as np
import pytest

import jax
import torch

from repro.configs import smoke_config as jsmoke
from repro.models import lm as jlm
from repro.serve.loop import Request as JRequest
from repro.serve.paged import PagedServeLoop as JLoop

from repro_torch import convert
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.serve.loop import Request
from repro_torch.serve.paged import (AdmissionError, PageManager,
                                     PagedServeLoop)

LENGTHS = (6, 11, 3, 9, 5)
MAX_NEW = (4, 6, 3, 5, 4)
S_MAX = 48
# x max |logit|.  Most forwards agree bit for bit; where the jitted JAX
# forward and the eager port sum in another order, a bf16 activation can
# land on the other side of a 3-bit code boundary, and one flipped code
# moves the logits by up to a few percent of their scale
LOGIT_TOL = 5e-2
MIN_EXACT = 0.75    # share of forwards whose logits must be bit-equal
ROOT = os.path.join(os.path.dirname(__file__), "..")

# (prefix_cache, on_demand): the reference's earlier core, its defaults
MODES = [(False, False), (True, True)]


def _workload(vocab):
    rng = np.random.default_rng(7)
    return [(rng.integers(0, vocab, n).astype(np.int32), mn)
            for n, mn in zip(LENGTHS, MAX_NEW)]


def _shared_prefix_workload(vocab):
    """A 12-token system prompt (three pages of 4) and distinct suffixes:
    later requests hit the cached prefix, skip its first chunk and copy
    the partly matched page their first live chunk rewrites."""
    rng = np.random.default_rng(3)
    system = rng.integers(0, vocab, 12).astype(np.int32)
    return [(np.concatenate([system, rng.integers(0, vocab, n)
                             .astype(np.int32)]), mn)
            for n, mn in ((3, 4), (7, 5), (1, 3), (10, 6), (5, 4))]


def _pressure_workload(vocab):
    """Distinct prompts whose decode outgrows a 9-page pool (8 usable)
    with two slots: on-demand growth preempts, and a victim's parked
    pages are mapped back when it resumes (distinct prompts: every hit is
    a request's own parked page)."""
    rng = np.random.default_rng(11)
    return [(rng.integers(0, vocab, n).astype(np.int32), mn)
            for n, mn in ((9, 12), (10, 11), (7, 10), (12, 9))]


# (name, workload, loop keyword arguments)
WORKLOADS = {
    "oracle": (_workload, dict(batch_slots=2, page_size=8, chunk=8)),
    "shared_prefix": (_shared_prefix_workload,
                      dict(batch_slots=2, page_size=4, chunk=8)),
    "pressure": (_pressure_workload,
                 dict(batch_slots=2, page_size=4, chunk=8, n_pages=9)),
}

_cache = {}


def _jax_run(arch, kv_dtype, workload, prefix_cache, on_demand):
    key = (arch, kv_dtype, workload, prefix_cache, on_demand)
    if key in _cache:
        return _cache[key]
    cfg = jsmoke(arch)
    params, _ = jlm.init_lm(jax.random.PRNGKey(0), cfg, purpose="serve")
    make, kw = WORKLOADS[workload]
    loop = JLoop(params, cfg, s_max=S_MAX, prefix_cache=prefix_cache,
                 on_demand=on_demand, spec_k=0, attn_impl="lax",
                 kv_dtype=kv_dtype, **kw)
    log = []
    for kind in ("_prefill_chunk", "_decode"):
        fn = getattr(loop, kind)

        def wrapper(*a, _fn=fn, _kind=kind):
            logits, caches = _fn(*a)
            # args after (params, caches): tokens, start/pos, bt[, last]
            log.append((_kind, [np.array(x, copy=True) for x in a[2:]],
                        np.asarray(logits, np.float32)))
            return logits, caches
        setattr(loop, kind, wrapper)
    _hook_events(loop, log)
    for i, (p, mn) in enumerate(make(cfg.vocab)):
        loop.submit(JRequest(rid=i, prompt=p.copy(), max_new_tokens=mn))
    done = {r.rid: r.output for r in loop.run()}
    stats = dict(refills=loop.refills, cow=loop.cow_copies,
                 preemptions=loop.preemptions, resumes=loop.resumes,
                 saved=loop.prefill_tokens_saved,
                 hits=loop.prefix.hit_blocks if loop.prefix else 0)
    _cache[key] = (cfg, params, log, done, stats)
    return _cache[key]


def _hook_events(loop, log):
    """Log every CoW copy and preemption of ``loop`` in forward order."""
    cow, preempt = loop._cow, loop._preempt

    def cow_wrapper(src, dst):
        log.append(("_cow", [int(src), int(dst)], None))
        return cow(src, dst)

    def preempt_wrapper(slot_i):
        log.append(("_preempt", [int(slot_i)], None))
        return preempt(slot_i)
    loop._cow, loop._preempt = cow_wrapper, preempt_wrapper


def _teacher_forced(arch, kv_dtype, workload, prefix_cache, on_demand):
    jcfg, params, jlog, jdone, jstats = _jax_run(arch, kv_dtype, workload,
                                                 prefix_cache, on_demand)
    tcfg = dataclasses.replace(tsmoke(arch), serve_kv_dtype=kv_dtype)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, params),
                                 device="cpu")
    make, kw = WORKLOADS[workload]
    loop = PagedServeLoop(tp, tcfg, s_max=S_MAX, prefix_cache=prefix_cache,
                          on_demand=on_demand, check_invariants=True,
                          device="cpu", **kw)
    it = iter(jlog)
    got_logits, margins_ok = [], 0

    def forced(kind, fn):
        def wrapper(*a):
            jkind, jargs, jlogits = next(it)
            assert kind == jkind, (kind, jkind)
            mine = [np.asarray(x) for x in a]
            if kind == "_prefill_chunk":     # tokens, start, bt_row, last
                assert np.array_equal(mine[0], jargs[0])
                assert mine[1] == int(jargs[1]) and mine[3] == int(jargs[3])
                assert np.array_equal(mine[2], jargs[2])
            else:                            # tokens, positions, block table
                for m, j in zip(mine, jargs):
                    assert np.array_equal(m, j), kind
            out = fn(*a)
            got_logits.append((out.float().numpy(), jlogits))
            return torch.from_numpy(jlogits)
        return wrapper

    def event(kind, fn):
        def wrapper(*a):
            jkind, jargs, _ = next(it)
            assert (kind, [int(x) for x in a]) == (jkind, jargs)
            return fn(*a)
        return wrapper

    loop._prefill_chunk = forced("_prefill_chunk", loop._prefill_chunk)
    loop._decode = forced("_decode", loop._decode)
    loop._cow = event("_cow", loop._cow)
    loop._preempt = event("_preempt", loop._preempt)
    for i, (p, mn) in enumerate(make(tcfg.vocab)):
        loop.submit(Request(rid=i, prompt=p.copy(), max_new_tokens=mn))
    done = {r.rid: r.output for r in loop.run()}
    assert next(it, None) is None                   # same number of events
    assert dict(refills=loop.refills, cow=loop.cow_copies,
                preemptions=loop.preemptions, resumes=loop.resumes,
                saved=loop.prefill_tokens_saved,
                hits=loop.prefix.hit_blocks if loop.prefix else 0) == jstats
    assert {k: v.tolist() for k, v in done.items()} == \
        {k: v.tolist() for k, v in jdone.items()}   # forced: JAX's tokens
    loop.pages.check()
    if loop.prefix is not None:
        loop.prefix.check()
        assert loop.pages.in_use == loop.prefix.n_nodes
        loop.prefix.evict(10**6)
    assert loop.pages.in_use == 0
    loop.check_compiled()
    assert loop.compiled_shapes() == {"chunk": 1, "decode": 1}
    exact = sum(np.array_equal(g, w) for g, w in got_logits)
    assert exact >= MIN_EXACT * len(got_logits), (exact, len(got_logits))
    for got, want in got_logits:
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, atol=LOGIT_TOL * scale, rtol=0)
        for g_row, w_row in zip(np.atleast_2d(got), np.atleast_2d(want)):
            top2 = np.sort(w_row)[-2:]
            if top2[1] - top2[0] > 2 * LOGIT_TOL * scale:
                assert int(np.argmax(g_row)) == int(np.argmax(w_row))
                margins_ok += 1
    assert margins_ok > 0
    return jstats


@pytest.mark.parametrize("prefix_cache,on_demand", MODES,
                         ids=["reserved", "defaults"])
@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "mistral-large-123b"])
def test_loop_teacher_forced_vs_jax(arch, kv_dtype, prefix_cache, on_demand):
    stats = _teacher_forced(arch, kv_dtype, "oracle", prefix_cache,
                            on_demand)
    assert stats["refills"] >= 3


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_loop_shared_prefix_teacher_forced_vs_jax(kv_dtype):
    stats = _teacher_forced("codeqwen1.5-7b", kv_dtype, "shared_prefix",
                            True, True)
    assert stats["hits"] >= 1 and stats["saved"] >= 8 and stats["cow"] >= 1


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_loop_pool_pressure_teacher_forced_vs_jax(kv_dtype):
    stats = _teacher_forced("codeqwen1.5-7b", kv_dtype, "pressure", True,
                            True)
    # distinct prompts: every prefix hit is a resume mapping parked pages
    assert stats["preemptions"] >= 1 and stats["resumes"] >= 1
    assert stats["hits"] >= 1


def test_loop_free_running_serves_every_request():
    cfg = tsmoke("codeqwen1.5-7b")
    from repro_torch.models import lm

    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    loop = PagedServeLoop(params, cfg, batch_slots=2, s_max=S_MAX,
                          page_size=8, chunk=8, device="cpu")
    for i, (p, mn) in enumerate(_workload(cfg.vocab)):
        loop.submit(Request(rid=i, prompt=p, max_new_tokens=mn))
    done = loop.run()
    assert sorted(r.rid for r in done) == list(range(len(LENGTHS)))
    for r in done:
        assert len(r.output) == MAX_NEW[r.rid] and r.finish_reason == "length"
    assert loop.refills >= 3 and loop.decode_steps > 0
    # finished requests' written pages stay in the prefix cache (the
    # default) until pressure or an explicit eviction frees them
    assert loop.pages.in_use == loop.prefix.n_nodes > 0
    assert not loop.block_table.any()
    loop.prefix.evict(10**6)
    assert loop.pages.in_use == 0
    loop.check_compiled()


def _jax_small_loop(on_demand, **kw):
    cfg = jsmoke("codeqwen1.5-7b")
    if "queue_limit" in kw:
        cfg = dataclasses.replace(cfg, serve_queue_limit=kw.pop("queue_limit"))
    params, _ = jlm.init_lm(jax.random.PRNGKey(0), cfg, purpose="serve")
    return JLoop(params, cfg, s_max=S_MAX, page_size=8, chunk=8, spec_k=0,
                 attn_impl="lax", on_demand=on_demand, **kw), JRequest


def _port_small_loop(on_demand, **kw):
    cfg = tsmoke("codeqwen1.5-7b")
    if "queue_limit" in kw:
        cfg = dataclasses.replace(cfg, serve_queue_limit=kw.pop("queue_limit"))
    from repro_torch.models import lm

    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    return PagedServeLoop(params, cfg, s_max=S_MAX, page_size=8, chunk=8,
                          on_demand=on_demand, device="cpu", **kw), Request


def _outcome(make, on_demand, case):
    """Run one admission case of ``tests/test_scheduler.py``; returns
    ``(where, error class name, message)`` or the finished outputs."""
    if case == "queue_limit":
        loop, R = make(on_demand, batch_slots=1, queue_limit=2)
    elif case == "lone_overflow":
        loop, R = make(on_demand, batch_slots=1, n_pages=3)
    else:
        loop, R = make(on_demand, batch_slots=1, n_pages=3)
    prompts = {"empty": [np.zeros(0, np.int32)],
               "oversized": [np.zeros(S_MAX + 1, np.int32)],
               "never_fits": [np.ones(40, np.int32)],
               "queue_limit": [np.full(4, i + 1, np.int32) for i in range(3)],
               # the prefill fits the 2-page pool, prompt + max_new does not
               "lone_overflow": [np.arange(6, dtype=np.int32)]}[case]
    try:
        for i, p in enumerate(prompts):
            loop.submit(R(rid=i, prompt=p, max_new_tokens=16))
    except Exception as e:                          # noqa: BLE001
        return ("submit", type(e).__name__, str(e).split(";")[0],
                len(loop.sched))
    try:
        done = loop.run()
    except Exception as e:                          # noqa: BLE001
        return ("step", type(e).__name__, str(e).split(":")[0],
                loop.preemptions)
    return ("done", sorted(r.rid for r in done), loop.preemptions)


@pytest.mark.parametrize("on_demand", [True, False],
                         ids=["on_demand", "reserved"])
def test_submit_rejects_requests_that_can_never_run(on_demand):
    """The typed errors of ``tests/test_scheduler.py`` (empty prompt,
    prompt past s_max, prompt pages past the pool, backpressure), and a
    lone request whose prefill fits but whose decode cannot: reserved
    mode raises ``PoolExhaustedError`` from ``step``; on-demand mode
    preempts it and raises when its resume cannot fit.  Port and JAX give
    the same outcome in each case."""
    want = {
        "empty": ("submit", "AdmissionError", "prompt length 0 outside "
                  "(0, s_max=48]", 0),
        "oversized": ("submit", "AdmissionError", "prompt length 49 outside "
                      "(0, s_max=48]", 0),
        "never_fits": ("submit", "AdmissionError", "request 0 can never fit"
                       ": prompt needs 5 pages, pool has 2", 0),
        "queue_limit": ("submit", "AdmissionError", "backpressure: queue at "
                        "serve_queue_limit=2", 2),
        # on-demand: preempted once, then its resume (17 tokens, 3 prefill
        # pages, 2 of them parked in the prefix cache) cannot fit
        "lone_overflow": ("step", "PoolExhaustedError",
                          "request 0 needs 1 fresh pages; pool has 2"
                          if on_demand else
                          "request 0 needs 3 fresh pages; pool has 2",
                          1 if on_demand else 0),
    }
    for case, outcome in want.items():
        assert _outcome(_jax_small_loop, on_demand, case) == outcome, case
        assert _outcome(_port_small_loop, on_demand, case) == outcome, case
    cfg = tsmoke("codeqwen1.5-7b")
    from repro_torch.models import lm

    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="params live on"):
        PagedServeLoop(params, cfg, device="meta")
    with pytest.raises(ValueError, match="serve_preempt_policy"):
        PagedServeLoop(params, cfg, preempt_policy="typo", device="cpu")
    assert issubclass(AdmissionError, ValueError)


def test_page_manager_refcounts_and_scratch_page():
    pm = PageManager(5)
    a = pm.alloc(3)
    assert a == [1, 2, 3] and pm.in_use == 3
    assert pm.alloc(2) is None and pm.exhaustions == 1
    assert pm.refcnt[a].tolist() == [1, 1, 1]
    pm.release(a)
    pm.check()
    assert pm.available == 4 and pm.peak == 3
    with pytest.raises(ValueError, match="scratch"):
        pm.release([0])
    with pytest.raises(ValueError, match="double free"):
        pm.release([1])
    assert pm.alloc(4) == [4, 1, 2, 3]           # freed pages rejoin FIFO
    pm.check()


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_neither_jax_nor_reference_package():
    files = _port_files()
    assert len(files) > 15
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro", "flax"), \
                    f"{path} imports {m}"
