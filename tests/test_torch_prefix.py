"""The port's ref-counted ``PageManager`` and radix-tree ``PrefixCache``
(``repro_torch.serve``) against the JAX package's, and the port's
copy-on-write page copy against ``repro.kernels.paged.copy_page_kv``:
the units of ``tests/test_prefix_cache.py`` run on both, and seeded
operation sequences drive both side by side with equal refcounts, tree
stats and matches after every operation."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged as jpaged
from repro.serve.paged import PageManager as JPageManager
from repro.serve.prefix_cache import PrefixCache as JPrefixCache

from repro_torch.kernels import paged as tpaged
from repro_torch.models import lm as tlm
from repro_torch.serve.paged import PageManager
from repro_torch.serve.prefix_cache import PrefixCache

BOTH = [(PageManager, PrefixCache), (JPageManager, JPrefixCache)]
IDS = ["port", "jax"]


# ---------------------------------------------------------------------------
# PageManager
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("PM,_", BOTH, ids=IDS)
def test_page_manager_refcount_lifecycle(PM, _):
    pm = PM(6)
    pages = pm.alloc(3)
    assert sorted(pages) == [1, 2, 3] and pm.in_use == 3
    pm.retain(pages[:2])
    assert list(pm.refcnt[1:4]) == [2, 2, 1]
    pm.release(pages)                       # drops to [1, 1, 0]
    assert pm.in_use == 2 and pm.frees == 1
    pm.release(pages[:2])                   # last refs: all free again
    assert pm.in_use == 0 and pm.frees == 3
    pm.check()


@pytest.mark.parametrize("PM,_", BOTH, ids=IDS)
def test_page_manager_guards(PM, _):
    pm = PM(4)
    with pytest.raises(ValueError, match="scratch page 0"):
        pm.release([0])
    with pytest.raises(ValueError, match="double free"):
        pm.release([2])                     # never allocated
    pages = pm.alloc(1)
    pm.release(pages)
    with pytest.raises(ValueError, match="double free"):
        pm.release(pages)
    with pytest.raises(ValueError, match="retain of free"):
        pm.retain(pages)
    assert pm.alloc(99) is None             # over-ask: no partial grab
    assert pm.available == 3
    pm.check()


@pytest.mark.parametrize("seed", range(8))
def test_page_manager_and_tree_seeded_operations_match_jax(seed):
    """Random alloc/retain/release/insert/match/lock/evict sequences on
    both implementations: refcounts, free lists, tree stats and matches
    stay equal and both structural checks pass at every step."""
    rng = np.random.default_rng(seed)
    P = 4
    sides = [(pm := PM(12), PC(P, pm, max_pages=int(seed % 3) * 3))
             for PM, PC in BOTH]
    held = []                                    # pages we hold a ref to
    for _ in range(120):
        op = int(rng.integers(0, 6))
        if op == 0:                              # alloc
            n = int(rng.integers(1, 4))
            got = [pm.alloc(n) for pm, _ in sides]
            assert got[0] == got[1]
            held += got[0] or []
        elif op == 1 and held:                   # retain
            p = held[int(rng.integers(len(held)))]
            for pm, _ in sides:
                pm.retain([p])
            held.append(p)
        elif op == 2 and held:                   # release
            p = held.pop(int(rng.integers(len(held))))
            for pm, _ in sides:
                pm.release([p])
        elif op == 3:                            # insert a random prompt
            n_pages = int(rng.integers(1, 3))
            prompt = rng.integers(0, 3, size=n_pages * P)
            new = []
            for pm, tree in sides:
                pages = pm.alloc(n_pages)
                new.append(None if pages is None
                           else (pages, tree.insert(prompt, pages)))
            assert new[0] == new[1]
        elif op == 4:                            # match and lock
            prompt = rng.integers(0, 3, size=int(rng.integers(1, 4)) * P)
            hits = [tree.match(prompt) for _, tree in sides]
            assert [n.page_id for n in hits[0]] == \
                [n.page_id for n in hits[1]]
            if hits[0] and rng.random() < 0.5:
                for (_, tree), h in zip(sides, hits):
                    tree.lock(h)
                held += [n.page_id for n in hits[0]]
        else:                                    # evict under pressure
            n = int(rng.integers(1, 4))
            assert sides[0][1].evictable() == sides[1][1].evictable()
            assert sides[0][1].evict(n) == sides[1][1].evict(n)
        for pm, tree in sides:
            pm.check()
            tree.check()
        (pa, ta), (pb, tb) = sides
        assert np.array_equal(pa.refcnt, pb.refcnt)
        assert list(pa.free) == list(pb.free)
        assert ta.stats() == tb.stats()
    for pm, tree in sides:                       # drain
        for p in held:
            pm.release([p])
        tree.evict(10**6)
        pm.check()
        assert pm.in_use == 0


# ---------------------------------------------------------------------------
# radix tree semantics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("PM,PC", BOTH, ids=IDS)
def test_radix_match_insert_dedupe(PM, PC):
    pm = PM(10)
    tree = PC(4, pm)
    prompt = np.arange(8, dtype=np.int32)        # 2 full pages
    pages = pm.alloc(2)
    tree.insert(prompt, pages)
    assert tree.n_nodes == 2 and tree.inserted == 2
    hit = tree.match(prompt)
    assert [n.page_id for n in hit] == pages
    # a prompt diverging in page 2 matches only page 1
    other = prompt.copy()
    other[5] += 1
    assert len(tree.match(other)) == 1
    # duplicate insert releases the offered pages, keeps the tree's
    dup = pm.alloc(2)
    tree.insert(prompt, dup)
    assert tree.deduped == 2 and tree.n_nodes == 2
    assert pm.refcnt[dup[0]] == 0 and pm.refcnt[dup[1]] == 0
    pm.check()
    tree.check()


@pytest.mark.parametrize("PM,PC", BOTH, ids=IDS)
def test_radix_lru_eviction_respects_refs_and_leaves(PM, PC):
    pm = PM(10)
    tree = PC(2, pm)
    a = np.array([1, 1, 2, 2], np.int32)         # pages (1,1) -> (2,2)
    b = np.array([1, 1, 3, 3], np.int32)         # shares page (1,1)
    tree.insert(a, pm.alloc(2))
    tree.insert(b, pm.alloc(2))
    assert tree.n_nodes == 3                     # shared first page
    tree.match(a)                                # A's leaf is now MRU
    tree.evict(1)
    assert len(tree.match(b)) == 1               # B's leaf (LRU) evicted
    assert len(tree.match(a)) == 2               # A path intact
    # locked pages are never victims; the inner node survives while
    # its child holds it as parent
    hit = tree.match(a)
    tree.lock(hit)
    assert tree.evict(10) == 0                   # everything referenced
    pm.release([n.page_id for n in hit])
    assert tree.evict(10) == 2                   # leaf first, then root
    assert tree.n_nodes == 0 and pm.in_use == 0
    pm.check()


@pytest.mark.parametrize("PM,PC", BOTH, ids=IDS)
def test_radix_evictable_excludes_referenced_subtrees(PM, PC):
    pm = PM(10)
    tree = PC(2, pm)
    a = np.array([1, 1, 2, 2], np.int32)
    b = np.array([1, 1, 3, 3], np.int32)
    tree.insert(a, pm.alloc(2))
    tree.insert(b, pm.alloc(2))
    assert tree.evictable() == 3
    hit = tree.match(a)
    tree.lock(hit)
    assert tree.evictable() == 1                 # only B's unlocked leaf
    pm.release([n.page_id for n in hit])
    assert tree.evictable() == 3
    pm.check()
    tree.check()


@pytest.mark.parametrize("PM,PC", BOTH, ids=IDS)
def test_radix_max_pages_cap_evicts_lru(PM, PC):
    pm = PM(10)
    tree = PC(2, pm, max_pages=2)
    tree.insert(np.array([1, 1, 2, 2, 3, 3], np.int32), pm.alloc(3))
    assert tree.n_nodes == 2 and tree.evicted == 1
    assert pm.in_use == 2                        # evicted page freed
    # the kept nodes are the prefix (inner nodes can't evict first)
    assert len(tree.match(np.array([1, 1, 2, 2], np.int32))) == 2
    tree.check()
    pm.check()


# ---------------------------------------------------------------------------
# copy-on-write page copy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_copy_page_kv_equals_jax(kv_dtype):
    rng = np.random.default_rng(1)
    n_pages, P, KV, hd = 6, 4, 2, 8
    x = rng.standard_normal((n_pages, P, KV, hd)).astype(np.float32)
    jq = jpaged.KVQuantSpec(kv_dtype)
    if kv_dtype == "fp":
        jkv = {"k": jnp.asarray(x, jnp.bfloat16),
               "v": jnp.asarray(-x, jnp.bfloat16)}
    else:
        (kc, ks), (vc, vs) = (jpaged.quantise_kv(jnp.asarray(y), jq)
                              for y in (x, -x))
        jkv = {"k": kc, "v": vc, "ks": ks, "vs": vs}
    def to_np(v):
        return np.array(v.astype(jnp.float32) if v.dtype == jnp.bfloat16
                        else v, copy=True)

    tkv = {k: torch.from_numpy(to_np(v)).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.int8)
        for k, v in jkv.items()}
    want = jpaged.copy_page_kv(jkv, jnp.int32(2), jnp.int32(5))
    assert tpaged.copy_page_kv(tkv, 2, 5) is tkv              # in place
    for name in want:
        got = tkv[name].float() if tkv[name].dtype == torch.bfloat16 \
            else tkv[name]
        assert np.array_equal(got.numpy(), to_np(want[name])), name


def test_cache_copy_page_copies_every_layer_and_leaf():
    from repro_torch.configs import smoke_config
    from repro_torch.kernels.paged import spec_for

    cfg = smoke_config("codeqwen1.5-7b")
    caches = tlm.init_caches(cfg, spec_for(16, 1, page_size=4),
                             device="cpu")
    for seg in caches:
        for pool in seg.values():
            for leaf in pool.values():
                leaf.copy_(torch.randn(leaf.shape).to(leaf.dtype))
    before = [leaf.clone() for seg in caches for pool in seg.values()
              for leaf in pool.values()]
    assert tlm.cache_copy_page(caches, 1, 3) is caches
    after = [leaf for seg in caches for pool in seg.values()
             for leaf in pool.values()]
    for b, a in zip(before, after):
        assert torch.equal(a[:, 3], b[:, 1])
        keep = [p for p in range(a.shape[1]) if p != 3]
        assert torch.equal(a[:, keep], b[:, keep])
