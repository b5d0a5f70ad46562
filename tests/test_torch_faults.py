"""The port's fault injection, cancellation, deadlines and tenant quotas
against the JAX package's: the units of ``tests/test_faults.py``
(``FaultPlan``, ``FaultInjector``, checksummed ``SwapStore``, purges,
tenant budgets, the load-weighted ``peek``) run on both packages, seeded
fault streams are compared draw for draw, and the loop runs
teacher-forced against the JAX loop (``_torch_loop.py``) through cancels
in every state, deadlines under one fake clock, tenant quotas, injected
corruption and exhaustion, and seeded chaos plans with every site armed.

Tolerances: fault streams, host bytes, checksums, block tables,
decisions, terminal outcomes and every stat are exact; loop logits within
``LOGIT_TOL`` x their max |logit|, as ``tests/test_torch_serve.py``.
"""

import dataclasses

import numpy as np
import pytest

from repro.serve import faults as jfaults
from repro.serve import scheduler as jsched
from repro.serve import swap as jswap
from repro.serve.loop import Request as JRequest
from repro.serve.paged import PagedServeLoop as JLoop

from repro_torch.serve import faults as tfaults
from repro_torch.serve import scheduler as tsched
from repro_torch.serve import swap as tswap
from repro_torch.serve.loop import Request
from repro_torch.serve.paged import PagedServeLoop

import _torch_loop as H

PORT = dict(f=tfaults, s=tsched, w=tswap, R=Request)
JAX = dict(f=jfaults, s=jsched, w=jswap, R=JRequest)
BOTH = pytest.mark.parametrize("pkg", [PORT, JAX], ids=["port", "jax"])
CHAOS_RATES = {"alloc": 0.15, "swap_put": 0.25, "swap_corrupt": 0.5,
               "admit_stall": 0.1, "cancel": 0.04}


def _page(v, nbytes=8):
    return [{"k": np.full((2, nbytes // 2), v, np.int8)}]


# ---------------------------------------------------------------------------
# FaultPlan / FaultInjector units
# ---------------------------------------------------------------------------


@BOTH
def test_fault_plan_validates_sites_and_rates(pkg):
    FaultPlan = pkg["f"].FaultPlan
    FaultPlan(rates={"alloc": 0.5})
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultPlan(rates={"allok": 0.5})
    with pytest.raises(ValueError, match="in \\[0, 1\\]"):
        FaultPlan(rates={"alloc": 1.5})
    assert pkg["f"].SITES == jfaults.SITES


@BOTH
def test_injector_is_deterministic_and_capped(pkg):
    f = pkg["f"]
    plan = f.FaultPlan(seed=3, rates={"alloc": 0.5}, max_fires=4)
    i1, i2 = f.FaultInjector(plan), f.FaultInjector(plan)
    seq1 = [i1.fire("alloc") for _ in range(50)]
    assert seq1 == [i2.fire("alloc") for _ in range(50)]
    assert sum(seq1) == 4
    inj = f.FaultInjector(plan)
    for _ in range(50):
        inj.fire("alloc")
        inj.fire("swap_put")
    s = inj.stats()
    assert s["armed"]["alloc"] == 50 and s["fired"]["alloc"] == 4
    assert s["armed"]["swap_put"] == 50 and s["fired"]["swap_put"] == 0


@BOTH
def test_zero_rate_sites_do_not_perturb_the_stream(pkg):
    f = pkg["f"]
    plan = f.FaultPlan(seed=9, rates={"cancel": 0.3})
    i1, i2 = f.FaultInjector(plan), f.FaultInjector(plan)
    s1 = [i1.fire("cancel") for _ in range(40)]
    s2 = []
    for _ in range(40):
        i2.fire("alloc")
        s2.append(i2.fire("cancel"))
    assert s1 == s2


@BOTH
def test_null_faults_is_inert_and_shared(pkg):
    f = pkg["f"]
    assert not f.NULL_FAULTS.enabled
    assert not any(f.NULL_FAULTS.fire(s) for s in f.SITES)
    assert f.NULL_FAULTS.stats() == {"enabled": False}
    assert f.make_injector(None) is f.NULL_FAULTS
    inj = f.make_injector(f.FaultPlan(seed=1))
    assert isinstance(inj, f.FaultInjector)
    assert f.make_injector(inj) is inj


@BOTH
def test_corrupt_flips_exactly_one_byte(pkg):
    inj = pkg["f"].FaultInjector(pkg["f"].FaultPlan(seed=5))
    page = [{"k": np.arange(32, dtype=np.int8).reshape(4, 8)}]
    before = page[0]["k"].copy()
    inj.corrupt(page)
    diff = (page[0]["k"].view(np.uint8).reshape(-1)
            != before.view(np.uint8).reshape(-1))
    assert diff.sum() == 1


def test_fault_streams_and_torn_bytes_equal_jax():
    """One seeded plan, all sites armed, on both injectors: every fire,
    every choice, and every byte ``corrupt`` flips (in a page whose dict
    order is the pool's k, v, ks, vs, not JAX's sorted leaf order, with
    an empty leaf JAX skips) are the same."""
    plan = dict(seed=17, rates=CHAOS_RATES, max_fires=20)
    got = tfaults.FaultInjector(tfaults.FaultPlan(**plan))
    want = jfaults.FaultInjector(jfaults.FaultPlan(**plan))
    rng = np.random.default_rng(2)

    def page():
        return [{"b0": {"k": rng.integers(-9, 9, (3, 4, 2)).astype(np.int8),
                        "v": rng.integers(-9, 9, (3, 4, 2)).astype(np.int8),
                        "ks": rng.integers(0, 9, (3, 4)).astype(np.uint16),
                        "vs": np.zeros((0,), np.uint16)}}]
    for k in range(300):
        site = tfaults.SITES[k % len(tfaults.SITES)]
        assert got.fire(site) == want.fire(site), k
        if k % 7 == 0:
            assert got.choice(range(k + 1)) == want.choice(range(k + 1))
        if k % 11 == 0:
            a = page()
            b = [{"b0": {n: x.copy() for n, x in a[0]["b0"].items()}}]
            got.corrupt(a)
            want.corrupt(b)
            for n in a[0]["b0"]:
                assert np.array_equal(a[0]["b0"][n], b[0]["b0"][n]), (k, n)
    assert got.stats() == want.stats()


# ---------------------------------------------------------------------------
# SwapStore: checksums, purges, tenant budgets
# ---------------------------------------------------------------------------


@BOTH
def test_page_checksum_detects_any_flip(pkg):
    p = _page(3)
    c0 = pkg["w"].page_checksum(p)
    assert c0 == pkg["w"].page_checksum([{"k": p[0]["k"].copy()}])
    p[0]["k"][1, 2] ^= 1
    assert pkg["w"].page_checksum(p) != c0


@BOTH
def test_match_drops_corrupt_page_and_counts(pkg):
    store = pkg["w"].SwapStore(page_size=4)
    toks = np.arange(12, dtype=np.int32)
    assert store.put(toks, 0, _page(0)) and store.put(toks, 1, _page(1))
    key0 = tuple(int(t) for t in toks[:4])
    store.entries[key0].data[0]["k"][0, 0] ^= 0x7F
    nb = store.entries[key0].nbytes
    assert store.match(toks) == []
    s = store.stats()
    assert s["corrupt_dropped"] == 1 and s["corrupt_dropped_bytes"] == nb
    assert s["pages"] == 1
    store.check()


@BOTH
def test_purge_releases_exact_bytes_and_skips_gaps(pkg):
    store = pkg["w"].SwapStore(page_size=4)
    toks = np.arange(16, dtype=np.int32)
    assert store.put(toks, 0, _page(0)) and store.put(toks, 2, _page(2))
    nb = sum(p.nbytes for p in store.entries.values())
    assert store.purge(toks, 4) == (2, nb)
    s = store.stats()
    assert s["pages"] == 0 and s["bytes"] == 0
    assert s["purged_pages"] == 2 and s["purged_bytes"] == nb
    store.check()


@BOTH
def test_tenant_budget_evicts_own_lru_never_neighbours(pkg):
    nb = _page(0)[0]["k"].nbytes
    store = pkg["w"].SwapStore(page_size=4, tenant_budget=2 * nb)
    ta = np.arange(12, dtype=np.int32)
    tb = np.arange(12, dtype=np.int32) + 100
    assert store.put(ta, 0, _page(0), tenant="a")
    assert store.put(ta, 1, _page(1), tenant="a")
    assert store.put(tb, 0, _page(5), tenant="b")
    assert store.put(ta, 2, _page(2), tenant="a")
    assert store.stats()["tenant_bytes"] == {"a": 2 * nb, "b": nb}
    assert len(store.match(tb)) == 1
    assert store.match(ta) == []
    big = pkg["w"].SwapStore(page_size=4, tenant_budget=nb - 1)
    assert not big.put(ta, 0, _page(0), tenant="a")
    assert big.stats()["refused_puts"] == 1 and len(big) == 0
    store.check()


@BOTH
def test_swap_put_fault_refuses_and_corrupt_fault_damages(pkg):
    f, w = pkg["f"], pkg["w"]
    store = w.SwapStore(page_size=4, faults=f.FaultInjector(
        f.FaultPlan(seed=0, rates={"swap_put": 1.0})))
    toks = np.arange(8, dtype=np.int32)
    assert not store.put(toks, 0, _page(0))
    assert store.stats()["refused_puts"] == 1 and len(store) == 0
    store2 = w.SwapStore(page_size=4, faults=f.FaultInjector(
        f.FaultPlan(seed=0, rates={"swap_corrupt": 1.0})))
    assert store2.put(toks, 0, _page(0))
    assert store2.match(toks) == []
    assert store2.stats()["corrupt_dropped"] == 1


@BOTH
def test_peek_prefers_lightest_loaded_tenant_at_equal_priority(pkg):
    s, R = pkg["s"].Scheduler(), pkg["R"]
    s.push(R(rid=0, prompt=np.arange(4, dtype=np.int32), tenant="a"), 0)
    s.push(R(rid=1, prompt=np.arange(4, dtype=np.int32), tenant="b"), 0)
    assert s.peek().req.rid == 0
    assert s.peek(tenant_load={"a": 5}).req.rid == 1
    assert s.peek(tenant_load={"b": 5}).req.rid == 0
    s.push(R(rid=2, prompt=np.arange(4, dtype=np.int32), tenant="a"), 10)
    assert s.peek(tenant_load={"a": 99}).req.rid == 2
    assert s.peek(eligible=lambda e: e.req.tenant == "b").req.rid == 1
    s.check()


@BOTH
def test_error_taxonomy(pkg):
    s = pkg["s"]
    assert issubclass(s.DeadlineExceededError, s.AdmissionError)
    assert issubclass(s.QuotaExceededError, s.AdmissionError)
    assert not issubclass(s.CancelledError, s.AdmissionError)
    assert issubclass(s.AdmissionError, ValueError)
    ent = s.SchedEntry(req=None, priority=0, tokens=[1], out=[], seq=0,
                       enqueue_tick=0, t_submit=0.0, t_enqueue=0.0)
    assert (ent.deadline_s, ent.swap_blocks) == (None, 0)


# ---------------------------------------------------------------------------
# submit: typed errors, zero residue
# ---------------------------------------------------------------------------


def _door(Loop, params, cfg, R, **kw):
    loop = Loop(params, dataclasses.replace(cfg, serve_queue_limit=2),
                batch_slots=4, s_max=H.S_MAX, page_size=8, chunk=8,
                n_pages=8, telemetry=True, tenant_queue_limit=1,
                deadline_s=5.0, **kw)
    p = np.arange(6, dtype=np.int32)
    loop.submit(R(rid=0, prompt=p.copy(), tenant="a"))
    base = {k: v for k, v in loop.sched_stats().items()
            if not isinstance(v, dict)}
    out = []
    for req in (R(rid=1, prompt=np.zeros(0, np.int32)),
                R(rid=2, prompt=np.zeros(H.S_MAX + 1, np.int32)),
                R(rid=3, prompt=p.copy(), deadline_s=0.0),
                R(rid=4, prompt=p.copy(), deadline_s=-1.0),
                R(rid=5, prompt=p.copy(), tenant="a"),
                R(rid=6, prompt=p.copy(), tenant="b"),     # fills the queue
                R(rid=7, prompt=p.copy(), tenant="c")):
        try:
            loop.submit(req)
            out.append((req.rid, "queued"))
        except Exception as e:                      # noqa: BLE001
            out.append((req.rid, type(e).__name__, str(e).split(";")[0]))
    after = {k: v for k, v in loop.sched_stats().items()
             if not isinstance(v, dict)}
    rids = [e["rid"] for e in loop.tel.tracer.events]
    return out, base, after, rids, loop.sched.queued()[-1].deadline_s


def test_rejected_submit_leaves_zero_residue():
    """Every typed rejection fires before any push or event, with the
    reference's class and message, on both loops."""
    jcfg, params, tcfg, tp = H.model()
    got = _door(PagedServeLoop, tp, tcfg, Request, device="cpu")
    want = _door(JLoop, params, jcfg, JRequest)
    assert got == want
    out, base, after, rids, dl = got
    kinds = [o[1] for o in out]
    assert kinds == ["AdmissionError", "AdmissionError",
                     "DeadlineExceededError", "DeadlineExceededError",
                     "QuotaExceededError", "queued", "AdmissionError"]
    assert after["submitted"] == base["submitted"] + 1
    assert rids == [0, 6] and dl == 5.0           # the loop's default TTL


# ---------------------------------------------------------------------------
# the loop, teacher-forced against JAX's
# ---------------------------------------------------------------------------


def _live_with(n_out):
    """``drive``'s stop test: the rid of the first live slot that has
    emitted at least ``n_out`` tokens."""
    def until(loop):
        for s in loop.slots:
            if s is not None and len(s["out"]) >= n_out:
                return s["req"].rid + 1           # rid 0 must be truthy
        return None
    return until


def test_cancel_queued_request_and_idempotence(monkeypatch):
    def script(loop, clock):
        assert loop.cancel(3)
        assert not loop.cancel(3) and not loop.cancel(999)
        H.drive(loop, clock)
    _, loop, st = H.run_pair(monkeypatch, script=script)
    assert set(st["done"]) == {0, 1, 2, 4}
    assert st["failed"] == {3: ("cancelled", "CancelledError", [])}
    assert st["sched"]["cancelled"] == st["sched"]["removed"] == 1
    names = [e["name"] for e in loop.tel.tracer.events if e["rid"] == 3]
    assert names == ["submit", "cancelled"]


def test_cancel_mid_decode_keeps_partial_output(monkeypatch):
    def script(loop, clock):
        rid = H.drive(loop, clock, until=_live_with(2)) - 1
        assert loop.cancel(rid)
        H.drive(loop, clock)
    _, _, st = H.run_pair(monkeypatch, script=script)
    ((rid, (reason, err, out)),) = st["failed"].items()
    assert reason == "cancelled" and err == "CancelledError"
    assert 0 < len(out) < H.MAX_NEW[rid]
    assert len(st["done"]) == len(H.LENGTHS) - 1


def test_cancel_swapped_out_request_purges_host_bytes(monkeypatch):
    purged = []

    def script(loop, clock):
        def parked(lp):
            return next((e for e in lp.sched.queued() if e.swap_blocks), None)
        ent = H.drive(loop, clock, until=parked)
        held, bytes0 = ent.swap_blocks, loop.swap.stats()["bytes"]
        assert loop.cancel(ent.req.rid)
        s = loop.swap.stats()
        assert 0 < s["purged_pages"] <= held and ent.swap_blocks == 0
        assert s["bytes"] == bytes0 - s["purged_bytes"]
        purged.append((ent.req.rid, s["purged_pages"], s["purged_bytes"]))
        H.drive(loop, clock)
    _, _, st = H.run_pair(monkeypatch, kv="int8",
                          loop_kw=dict(n_pages=7, swap=True,
                                       swap_policy="always"), script=script)
    assert len(purged) == 2 and purged[0] == purged[1]     # JAX, then port
    assert purged[0][0] in st["failed"]


def test_queued_and_live_deadlines_under_one_clock(monkeypatch):
    """TTLs in steps of the fake clock: the whole set of tiny budgets is
    shed before any prefill; in the second run one request's budget runs
    out while it decodes (partial output kept) and one's while it waits
    in the queue (empty output)."""
    _, loop, st = H.run_pair(monkeypatch,
                             req_kw=lambda i: dict(deadline_s=1e-7))
    assert not st["done"] and len(st["failed"]) == len(H.LENGTHS)
    assert all(v == ("deadline", "DeadlineExceededError", [])
               for v in st["failed"].values())
    assert st["sched"]["expired"] == len(H.LENGTHS)
    assert loop.refills == 0 and loop.prefill_tokens_run == 0
    _, _, st = H.run_pair(
        monkeypatch, loop_kw=dict(batch_slots=2, deadline_s=600.0),
        req_kw=lambda i: {1: dict(deadline_s=4.0),
                          4: dict(deadline_s=2.0)}.get(i, {}))
    assert set(st["failed"]) == {1, 4}
    assert st["failed"][4] == ("deadline", "DeadlineExceededError", [])
    assert st["failed"][1][:2] == ("deadline", "DeadlineExceededError")
    assert 0 < len(st["failed"][1][2]) < H.MAX_NEW[1]
    assert len(st["done"]) == 3


def test_tenant_fairness_teacher_forced_vs_jax(monkeypatch):
    _, loop, st = H.run_pair(
        monkeypatch, loop_kw=dict(n_pages=7, tenant_page_quota=3),
        req_kw=lambda i: dict(tenant="a" if i % 2 == 0 else "b"))
    assert len(st["done"]) == len(H.LENGTHS) and not st["failed"]
    ts = st["tenants"]
    assert ts["page_quota"] == 3
    assert ts["tenants"]["a"]["completed"] == 3
    assert ts["tenants"]["b"]["completed"] == 2
    assert loop.metrics()["tenants"] == ts


def test_injected_corruption_recovers_via_recompute(monkeypatch):
    _, _, st = H.run_pair(
        monkeypatch, kv="int8",
        loop_kw=dict(n_pages=7, swap=True, swap_policy="always"),
        faults=dict(seed=1, rates={"swap_corrupt": 1.0}, max_fires=0))
    fired = st["faults"]["fired"]["swap_corrupt"]
    assert fired > 0 and st["swap"]["swapped_out_pages"] > 0
    assert 0 < st["swap"]["store"]["corrupt_dropped"] <= fired
    assert st["swap"]["swapped_in_pages"] == 0
    assert len(st["done"]) == len(H.LENGTHS)


def test_injected_exhaustion_stall_and_refusal(monkeypatch):
    _, _, st = H.run_pair(
        monkeypatch, kv="int8", spec_k=3,
        loop_kw=dict(n_pages=7, swap=True, swap_policy="always"),
        faults=dict(seed=2, rates={"alloc": 0.25, "admit_stall": 0.25,
                                   "swap_put": 0.5}))
    assert len(st["done"]) == len(H.LENGTHS) and not st["failed"]
    fired = st["faults"]["fired"]
    assert fired["alloc"] and fired["admit_stall"] and fired["swap_put"]


@pytest.mark.parametrize("seed,kv,spec_k", [(0, "int8", 3), (1, "fp", 0),
                                            (2, "int4", 3), (3, "fp", 3)])
def test_chaos_teacher_forced_vs_jax(monkeypatch, seed, kv, spec_k):
    """Every site armed at the reference's chaos rates, tenants a/b with
    page and swap-byte quotas and a generous deadline: every request ends
    done or failed with a typed error, the fault stream, host pages and
    outcomes equal JAX's, and nothing leaks."""
    _, loop, st = H.run_pair(
        monkeypatch, kv=kv, spec_k=spec_k,
        loop_kw=dict(n_pages=7, swap=True, swap_policy="always",
                     tenant_page_quota=3, tenant_swap_bytes=1 << 20),
        req_kw=lambda i: dict(tenant="a" if i % 2 == 0 else "b",
                              deadline_s=600.0),
        faults=dict(seed=seed, rates=CHAOS_RATES))
    assert len(st["done"]) + len(st["failed"]) == len(H.LENGTHS)
    assert sum(st["faults"]["fired"].values()) > 0
    assert st["swap"]["store"]["corrupt_dropped"] <= \
        st["faults"]["fired"]["swap_corrupt"]
    for reason, err, _ in st["failed"].values():
        assert (reason, err) in (("cancelled", "CancelledError"),
                                 ("deadline", "DeadlineExceededError"))
    assert loop.metrics()["faults"] == st["faults"]
