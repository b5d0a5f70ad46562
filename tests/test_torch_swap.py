"""The port's host-RAM swap tier against the JAX package's: the units of
``tests/test_swap.py`` and ``tests/test_faults.py`` on ``SwapStore``,
``StagingRing`` and ``SwapPolicy`` run on both packages, seeded operation
sequences drive both stores side by side, the page gather and scatter
(``swap_out_kv``/``swap_in_kv``, ``cache_swap_out``/``cache_swap_in``)
give JAX's host pages byte for byte with JAX's checksums, and the swap
loop runs teacher-forced against the JAX loop (``_torch_loop.py``).

Tolerances: integers, host bytes, checksums, block tables, decisions
and every stat are exact; loop logits within ``LOGIT_TOL`` x their max
|logit|, as ``tests/test_torch_serve.py``.
"""

import random

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.kernels import paged as jpaged
from repro.models import lm as jlm
from repro.serve.faults import FaultInjector as JInjector
from repro.serve.faults import FaultPlan as JPlan
from repro.serve.scheduler import SwapPolicy as JPolicy
from repro.serve.swap import StagingRing as JRing
from repro.serve.swap import SwapStore as JStore
from repro.serve.swap import page_checksum as jchecksum

from repro_torch import convert
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.kernels import paged as tpaged
from repro_torch.models import lm as tlm
from repro_torch.serve.faults import (FaultInjector, FaultPlan, tree_leaves,
                                      tree_map)
from repro_torch.serve.scheduler import SwapPolicy
from repro_torch.serve.swap import StagingRing, SwapStore, page_checksum

import _torch_loop as H

PORT = dict(Store=SwapStore, Ring=StagingRing, Policy=SwapPolicy,
            checksum=page_checksum, arange=torch.arange)
JAX = dict(Store=JStore, Ring=JRing, Policy=JPolicy, checksum=jchecksum,
           arange=jnp.arange)
BOTH = pytest.mark.parametrize("pkg", [PORT, JAX], ids=["port", "jax"])


def _page(v, nbytes=8):
    """A tiny fake host page (one int8 leaf of ``nbytes``)."""
    return [{"k": np.full((2, nbytes // 2), v, np.int8)}]


# ---------------------------------------------------------------------------
# units, on both packages
# ---------------------------------------------------------------------------


@BOTH
def test_swap_store_content_addressing_and_match(pkg):
    store = pkg["Store"](page_size=4)
    toks = np.arange(12, dtype=np.int32)
    assert store.put(toks, 0, _page(0)) and store.put(toks, 1, _page(1))
    assert store.put(toks, 0, _page(0))          # content dedupe
    assert store.stats()["dup_puts"] == 1
    assert store.stats()["pages"] == 2
    m = store.match(toks)
    assert len(m) == 2 and m[0].data[0]["k"][0, 0] == 0
    toks2 = np.concatenate([toks[:4], np.full(8, 99, np.int32)])
    assert len(store.match(toks2)) == 1
    assert len(store.match(toks, start_block=1)) == 1
    assert store.match(toks, start_block=2) == []
    store.check()


@BOTH
def test_swap_store_lru_budget_eviction_and_refusal(pkg):
    nb = _page(0)[0]["k"].nbytes
    store = pkg["Store"](page_size=4, max_bytes=2 * nb)
    t = np.arange(12, dtype=np.int32)
    assert store.put(t, 0, _page(0)) and store.put(t, 1, _page(1))
    store.match(t[:4])                  # touch block 0: block 1 is LRU
    assert store.put(t, 2, _page(2))    # evicts block 1
    assert len(store.match(t)) == 1
    s = store.stats()
    assert s["evicted_pages"] == 1 and s["bytes"] == 2 * nb
    store.check()
    tiny = pkg["Store"](page_size=4, max_bytes=nb - 1)
    assert not tiny.put(t, 0, _page(0))
    assert tiny.stats()["refused_puts"] == 1 and len(tiny) == 0


@BOTH
def test_staging_ring_depth_and_maturity_order(pkg):
    ring, ar = pkg["Ring"](width=2, depth=2), pkg["arange"]
    assert ring.stage((0, 2), {"a": ar(4)}) == []
    assert ring.stage((2, 2), {"a": ar(4) + 4}) == []
    out = ring.stage((4, 1), {"a": ar(4) + 8})
    assert len(out) == 1 and out[0][0] == (0, 2)
    assert isinstance(out[0][1]["a"], np.ndarray)     # forced to host
    assert out[0][1]["a"].tolist() == [0, 1, 2, 3]
    rest = ring.drain()
    assert [m for m, _ in rest] == [(2, 2), (4, 1)]
    assert rest[1][1]["a"].tolist() == [8, 9, 10, 11]
    assert ring.transactions == 3 and ring.drain() == []


@BOTH
def test_swap_policy_modes_bootstrap_and_crossover(pkg):
    P = pkg["Policy"]
    assert not P("never").decide(10_000, 1)
    assert P("always").decide(1, 10 ** 12)
    with pytest.raises(ValueError, match="swap policy"):
        P("sometimes")
    p = P("auto")
    assert p.decide(100, 100)           # optimistic bootstrap
    p.observe_prefill(1000, 1.0)
    p.observe_copy(1_000_000, 1.0)
    assert p.decide(1000, 100_000)
    assert not p.decide(10, 100_000)
    s = p.stats()
    assert s["chose_swap"] == 2 and s["chose_recompute"] == 1
    p.observe_prefill(4000, 1.0)
    assert 1000 < p.prefill_tok_per_s < 4000


def test_swap_policy_rates_equal_jax():
    """The EMA and the crossover on one seeded stream of observations."""
    rng = random.Random(5)
    ops = [(rng.choice("pcd"), rng.randint(1, 5000), rng.uniform(0.01, 2.0))
           for _ in range(200)]
    got, want = SwapPolicy("auto", alpha=0.3), JPolicy("auto", alpha=0.3)
    for op, n, dt in ops:
        for p in (got, want):
            if op == "p":
                p.observe_prefill(n, dt)
            elif op == "c":
                p.observe_copy(n * 1000, dt)
        if op == "d":
            assert got.decide(n, n * 997) == want.decide(n, n * 997)
    assert got.stats() == want.stats()


def _tree(rng, v):
    """A page with the pool's insertion order (k, v, ks, vs), which is not
    JAX's sorted leaf order, over two blocks and mixed dtypes."""
    def leaf(shape, dt):
        return (rng.integers(0, 100, shape) + v % 27).astype(dt)
    return [{"b1": {"k": leaf((2, 3), np.int8), "v": leaf((2, 3), np.int8),
                    "ks": leaf((2,), np.uint16), "vs": leaf((2,), np.uint16)},
             "b0": {"k": leaf((2, 5), np.uint16), "v": leaf((2, 5),
                                                            np.uint16)}}]


def test_page_checksum_follows_jax_leaf_order():
    rng = np.random.default_rng(0)
    for v in range(8):
        t = _tree(rng, v)
        assert page_checksum(t) == jchecksum(t)
    assert page_checksum(_page(3)) == jchecksum(_page(3))


def test_seeded_store_operations_equal_jax():
    """Put (with tenants, dedupes, budget and tenant evictions,
    refusals), match, purge and injected refusals and corruption on both
    stores from one seeded script: every result and every stat equal."""
    rng = random.Random(11)
    data_rng = np.random.default_rng(11)
    histories = [np.asarray([rng.randrange(50) for _ in range(24)], np.int32)
                 for _ in range(5)]
    histories.append(np.concatenate([histories[0][:8],
                                     np.arange(16, dtype=np.int32)]))
    plan = dict(seed=4, rates={"swap_put": 0.15, "swap_corrupt": 0.3})
    stores = [SwapStore(page_size=4, max_bytes=900, tenant_budget=500,
                        faults=FaultInjector(FaultPlan(**plan))),
              JStore(page_size=4, max_bytes=900, tenant_budget=500,
                     faults=JInjector(JPlan(**plan)))]
    for step in range(400):
        op = rng.choice(["put", "put", "put", "match", "purge"])
        h = rng.choice(histories)
        if op == "put":
            i, tenant = rng.randrange(6), rng.choice(["a", "b", None])
            tree = _tree(data_rng, step)      # a copy each: corrupt
            res = [s.put(h, i, [{b: {n: a.copy() for n, a in p.items()}
                                 for b, p in tree[0].items()}],
                         tenant=tenant) for s in stores]
        elif op == "match":
            start = rng.randrange(3)
            res = [[(p.key, p.checksum, p.nbytes) for p in
                    s.match(h, start_block=start)] for s in stores]
        else:
            n = rng.randrange(7)
            res = [s.purge(h, n) for s in stores]
        assert res[0] == res[1], (step, op)
        assert stores[0].stats() == stores[1].stats(), (step, op)
        for s in stores:
            s.check()
    st = stores[0].stats()
    assert st["evicted_pages"] and st["corrupt_dropped"] and \
        st["refused_puts"] and st["purged_pages"], st
    assert stores[0].faults.stats() == stores[1].faults.stats()
    for key, page in stores[0].entries.items():
        want = stores[1].entries[key]
        assert (page.checksum, page.tenant, page.tick) == \
            (want.checksum, want.tenant, want.tick)
        assert page_checksum(page.data) == jchecksum(want.data)


# ---------------------------------------------------------------------------
# page gather and scatter against JAX's
# ---------------------------------------------------------------------------


def _random_leaf(rng, shape, dtype):
    if dtype == np.int8:
        return rng.integers(-128, 128, size=shape).astype(np.int8)
    return np.asarray(jnp.asarray(rng.normal(size=shape), jnp.bfloat16))


def _bytes(a):
    """The raw bytes of a torch, JAX or numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        a = (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8).tobytes()


@pytest.mark.parametrize("dtype", ["fp", "int8", "int4"])
def test_swap_kv_page_roundtrip_matches_jax(dtype):
    """One layer's pool: the gathered pages equal JAX's byte for byte,
    and the scatter into other pages equals JAX's scatter (in place)."""
    spec = jpaged.spec_for(32, 2, page_size=8)
    jkv = jpaged.zero_kv_pool(spec, KV=2, hd=16, qspec=jpaged.KVQuantSpec(
        dtype))
    rng = np.random.default_rng(3)
    host = {n: _random_leaf(rng, leaf.shape, np.asarray(leaf).dtype)
            for n, leaf in jkv.items()}
    jkv = {n: jnp.asarray(a) for n, a in host.items()}
    tkv = convert.pool_from_jax(host, device="cpu")
    src, dst = [2, 5, 3], [6, 1, 4]
    jst = jax.tree.map(np.asarray, jpaged.swap_out_kv(
        jkv, jnp.asarray(src, jnp.int32)))
    tst = tpaged.swap_out_kv(tkv, torch.tensor(src))
    for n in jkv:
        assert _bytes(tst[n]) == _bytes(jst[n]), n
    want = jpaged.swap_in_kv(jkv, jst, jnp.asarray(dst, jnp.int32))
    leaves = {n: t for n, t in tkv.items()}
    got = tpaged.swap_in_kv(tkv, tst, torch.tensor(dst))
    for n in jkv:
        assert got[n] is leaves[n]                   # written in place
        assert _bytes(got[n]) == _bytes(want[n]), n
        assert _bytes(np.asarray(want[n])[dst]) == _bytes(host[n][src])


@pytest.mark.parametrize("dtype", ["fp", "int8", "int4"])
def test_cache_swap_host_pages_equal_jax(dtype):
    """Stacked caches of the smoke model: the port's gather, forced to
    host through the staging ring and split per page as the loop does,
    gives JAX's host pages byte for byte and leaf for leaf, with JAX's
    ``page_checksum``; scattering them into other pages is the identity
    on those pages, in place."""
    jcfg, _, tcfg, _ = H.model(dtype)
    spec = jpaged.spec_for(H.S_MAX, 2, page_size=8, n_pages=12)
    jcaches, _ = jlm.init_caches(jcfg, 2, H.S_MAX, paged=spec)
    rng = np.random.default_rng(9)
    host = jax.tree.map(lambda l: _random_leaf(rng, l.shape,
                                               np.asarray(l).dtype), jcaches)
    jcaches = jax.tree.map(jnp.asarray, host)
    tcaches = convert.pool_from_jax(host, device="cpu")
    pids = [3, 7, 0, 0]                           # a short tail pads with 0
    jdev = jlm.cache_swap_out(jcaches, jnp.asarray(pids, jnp.int32))
    ring = StagingRing(width=4)
    ring.stage("t", tlm.cache_swap_out(tcaches, torch.tensor(pids)))
    ((_, thost),) = ring.drain()
    jhost = jax.tree.map(np.asarray, jdev)
    for j in range(2):
        tpage = tree_map(lambda a: a[:, j].copy(), thost)
        jpage = jax.tree.map(lambda a: a[:, j].copy(), jhost)
        tl, jl = tree_leaves(tpage), jax.tree.leaves(jpage)
        assert len(tl) == len(jl)
        for a, b in zip(tl, jl):
            assert a.shape == b.shape and a.nbytes == b.nbytes
            assert a.flags.c_contiguous
            assert _bytes(a) == _bytes(b)
        assert page_checksum(tpage) == jchecksum(jpage)
    ids = [s.data_ptr() for seg in tcaches for p in seg.values()
           for s in p.values()]
    staged = tree_map(lambda a: torch.from_numpy(
        a.view(np.int16) if a.dtype == np.uint16 else a), thost)
    tlm.cache_swap_in(tcaches, staged, torch.tensor([9, 10, 0, 0]))
    assert ids == [s.data_ptr() for seg in tcaches for p in seg.values()
                   for s in p.values()]
    for seg, hseg in zip(tcaches, host):
        for b, pool in seg.items():
            for n, leaf in pool.items():
                assert _bytes(leaf[:, [9, 10]]) == _bytes(
                    hseg[b][n][:, [3, 7]]), (b, n)


# ---------------------------------------------------------------------------
# the swap loop, teacher-forced against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv,spec_k", [("int8", 0), ("fp", 3), ("int4", 3)])
def test_forced_swap_teacher_forced_vs_jax(monkeypatch, kv, spec_k):
    """``tests/test_swap.py``'s acceptance run: a 6-usable-page pool
    forces preemptions and the policy pins the swap path; swap-outs,
    restores (pages and checksums), block tables and stats equal JAX's."""
    jloop, loop, st = H.run_pair(
        monkeypatch, kv=kv, spec_k=spec_k,
        loop_kw=dict(n_pages=7, swap=True, swap_policy="always"))
    assert st["sched"]["preemptions"] > 0
    sw = st["swap"]
    assert sw["swapped_out_pages"] > 0 and sw["swapped_in_pages"] > 0
    assert sw["restored_tokens"] > 0
    assert sw["store"]["bytes"] == sum(p.nbytes
                                       for p in loop.swap.entries.values())
    assert sw["page_bytes"] == loop.page_bytes() == jloop.page_bytes()
    names = [e["name"] for e in loop.tel.tracer.events]
    assert "swapped_out" in names and "swapped_in" in names
    assert loop.metrics()["swap"]["store"] == sw["store"]
    tel = loop.metrics()["telemetry"]["counters"]
    assert tel["swap.in_pages"] == sw["swapped_in_pages"]


def test_zero_budget_degrades_to_recompute_vs_jax(monkeypatch):
    """A host budget smaller than one page refuses every put: the loop
    recomputes, as JAX's does, and nothing is host-resident."""
    _, loop, st = H.run_pair(
        monkeypatch, kv="int8",
        loop_kw=dict(n_pages=7, swap=True, swap_policy="always",
                     swap_bytes=1))
    assert st["sched"]["preemptions"] > 0
    sw = st["swap"]
    assert sw["swapped_out_pages"] == 0 and sw["swapped_in_pages"] == 0
    assert sw["store"]["refused_puts"] > 0 and len(loop.swap) == 0


def test_swap_never_keeps_recompute_vs_jax(monkeypatch):
    """Policy 'never': every victim recomputes through the prefix cache."""
    _, _, st = H.run_pair(
        monkeypatch, kv="fp",
        loop_kw=dict(n_pages=7, swap=True, swap_policy="never"))
    assert st["sched"]["preemptions"] > 0
    assert st["swap"]["policy"]["chose_recompute"] == \
        st["sched"]["preemptions"]
    assert st["swap"]["swapped_out_pages"] == 0


def test_swap_off_has_no_swap_state():
    jcfg, params, tcfg, tp = H.model()
    from repro.serve.paged import PagedServeLoop as JLoop
    from repro_torch.serve.paged import PagedServeLoop

    kw = dict(batch_slots=2, s_max=H.S_MAX, page_size=8, chunk=8)
    loop = PagedServeLoop(tp, tcfg, device="cpu", **kw)
    jloop = JLoop(params, jcfg, **kw)
    assert loop.swap is None and loop.swap_policy is None \
        and loop.swap_ring is None
    m, jm = loop.metrics(), jloop.metrics()
    assert m["swap"] == jm["swap"] == {"enabled": False}
    assert m["faults"] == jm["faults"] == {"enabled": False}
    assert m["tenants"] == jm["tenants"]
    loop.check_compiled()
