"""The port's autotuner (``kernels/autotune.py``) and ``'auto'`` dispatch
(``ops.tlmac_matmul``, ``paged.paged_attention``, the serve linears, the
paged loop's ``tune``), on the CPU, where only the plain versions run.

- Keys: the reference's format, the backend taken from the device.
- The cache file: round trip, merge of concurrent writers (a simulated
  one and four processes), ``generation`` and the resolved-config memo.
- ``auto_allow`` filtering, ``tune_on_miss=False`` never tuning.
- A wrong candidate raises (``CandidateMismatch``) and nothing is
  recorded; a candidate's ``RuntimeError`` propagates; only a typed
  shape refusal (``ValueError``) skips a candidate.
- Attention: ``'lax'`` and the baseline within ``2e-2``, the miss default
  (flash-decode at 4 splits) and a recorded winner dispatched.
- The paged loop: ``tune`` records the main path's keys, ``metrics()``
  carries the ``autotune`` section, and ``'auto'`` serves the same tokens
  as the fixed impls.
"""

import dataclasses
import json
import multiprocessing as mp

import numpy as np
import pytest

import torch

from repro.kernels import autotune as jat

from repro_torch.configs import smoke_config
from repro_torch.kernels import autotune as at
from repro_torch.kernels import ops, paged
from repro_torch.models import lm, nn
from repro_torch.serve.loop import Request
from repro_torch.serve.paged import PagedServeLoop

import _torch_families  # noqa: F401  (one torch thread per worker)

CFG = smoke_config("codeqwen1.5-7b")


@pytest.fixture
def cache(tmp_path, monkeypatch):
    path = tmp_path / "at.json"
    monkeypatch.setenv(at.CACHE_ENV, str(path))
    at.reset_cache()
    at.reset_stats()
    yield path
    at.reset_cache()


def _linear(K=64, N=128, M=4, seed=0):
    """A tlmac serve linear's plan arrays (narrow table) and codes."""
    gen = torch.Generator().manual_seed(seed)
    p = nn.init_serve_linear(gen, K, N, CFG, device="cpu")
    a = torch.randint(0, 2**CFG.quant.a_bits, (M, K), generator=gen,
                      dtype=torch.int8)
    return a, p["table_narrow"], p["exec_idx"], p["step_cluster"]


def _key(a, t, e, N, device="cpu"):
    return at.shape_key(a.shape[0], a.shape[1], N, B_a=3, G=4,
                        D_p=e.shape[-1], R=int(np.prod(t.shape[:-1])),
                        device=device)


def test_keys_follow_the_reference_format():
    kw = dict(B_a=3, G=4, D_p=128, R=2048)
    want = jat.shape_key(4, 4096, 4096, **kw)
    assert want.split("|")[1] == "cpu"
    assert at.shape_key(4, 4096, 4096, **kw, device="cpu") == want
    assert at.shape_key(4, 4096, 4096, **kw, device="cuda:0") == \
        want.replace("|cpu|", "|cuda|")
    for window, kv in ((None, "fp"), (2048, "int8"), (64, "int4")):
        want = jat.attn_shape_key(4, 8, 4, 128, 64, 16, window, kv_dtype=kv)
        assert at.attn_shape_key(4, 8, 4, 128, 64, 16, window, kv_dtype=kv,
                                 device="cpu") == want
    assert at.cache_path() != jat.cache_path()
    assert at.CACHE_ENV != jat.CACHE_ENV


def test_candidates_by_device():
    assert at.candidates("cuda") == [{"impl": "fused"}, {"impl": "pallas"}]
    assert at.candidates("cpu") == [{"impl": "ref"}]
    assert at.attention_candidates("cuda") == [{"impl": "lax"}] + [
        {"impl": "flash", "n_splits": s} for s in (1, 2, 4, 8)]
    assert at.attention_candidates("cpu") == [{"impl": "lax"}]


def test_tune_records_and_the_cache_round_trips(cache):
    a, t, e, c = _linear()
    want = ops.tlmac_matmul(a, t, e, c, B_a=3, G=4, N=128, impl="ref")
    cfg = at.tune(a, t, e, c, B_a=3, G=4, N=128, reps=2)
    assert cfg["impl"] in ("ref", "fused")
    key = _key(a, t, e, 128)
    data = json.loads(cache.read_text())
    assert data[key]["config"] == cfg and data[key]["us"] > 0
    assert set(data[key]["baseline_us"]) == {"fused"}
    assert at.snapshot_stats()["tuned_keys"] == [key]
    at.reset_cache()                             # a fresh process
    assert at.lookup(key) == cfg
    kw = dict(B_a=3, G=4, D_p=e.shape[-1], R=int(np.prod(t.shape[:-1])),
              device="cpu")
    assert at.lookup_or_default(4, 64, 128, **kw) == cfg
    assert at.lookup_or_default(8, 64, 128, **kw) == {"impl": "fused"}
    mtime = cache.stat().st_mtime_ns
    got = ops.tlmac_matmul(a, t, e, c, B_a=3, G=4, N=128, impl="auto")
    assert torch.equal(got, want)
    assert cache.stat().st_mtime_ns == mtime      # no re-tune


def test_concurrent_writers_merge(cache):
    at.record("key_a", {"impl": "fused"}, 1.0)
    data = json.loads(cache.read_text())        # another process writes
    data["key_b"] = {"config": {"impl": "pallas"}, "us": 2.0,
                     "baseline_us": {}}
    cache.write_text(json.dumps(data))
    at.record("key_c", {"impl": "fused"}, 3.0)   # our memo lacks key_b
    assert set(json.loads(cache.read_text())) == {"key_a", "key_b", "key_c"}


def _write_keys(path, worker):
    import os

    os.environ[at.CACHE_ENV] = path
    at.reset_cache()
    for i in range(5):
        at.record(f"w{worker}_{i}", {"impl": "fused"}, float(i))


def test_concurrent_processes_merge(cache):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_write_keys, args=(str(cache), w))
             for w in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
        assert not p.is_alive() and p.exitcode == 0
    assert set(json.loads(cache.read_text())) == {
        f"w{w}_{i}" for w in range(4) for i in range(5)}


def test_generation_and_memo(cache, monkeypatch):
    a, t, e, c = _linear(seed=1)
    key = _key(a, t, e, 128)
    seen = []
    real = ops.dispatch_config

    def spy(config, *args, **kw):
        seen.append(config["impl"])
        return real(config, *args, **kw)

    monkeypatch.setattr(ops, "dispatch_config", spy)
    kw = dict(B_a=3, G=4, N=128, impl="auto", tune_on_miss=False)
    ops.tlmac_matmul(a, t, e, c, **kw)
    misses = at.snapshot_stats()["lookup_misses"]
    ops.tlmac_matmul(a, t, e, c, **kw)           # memo: no second lookup
    assert at.snapshot_stats()["lookup_misses"] == misses == 1
    g = at.generation
    at.record(key, {"impl": "pallas"}, 1.0)
    assert at.generation == g + 1
    ops.tlmac_matmul(a, t, e, c, **kw)           # re-resolved
    assert seen == ["fused", "fused", "pallas"]
    at.reset_cache()
    assert at.generation == g + 2


def test_memo_follows_the_cache_path(cache, tmp_path, monkeypatch):
    """Pointing the env path at another file, without ``reset_cache``,
    re-resolves from that file: the memo is keyed on the path and
    ``_load`` moves ``generation`` when it reads another file."""
    a, t, e, c = _linear(seed=4)
    kw = dict(B_a=3, G=4, N=128, impl="auto", tune_on_miss=False)
    at.record(_key(a, t, e, 128), {"impl": "pallas"}, 1.0)
    assert ops.resolve_auto(a, t, e, c, B_a=3, G=4, N=128,
                            tune_on_miss=False) == {"impl": "pallas"}
    g = at.generation
    monkeypatch.setenv(at.CACHE_ENV, str(tmp_path / "other.json"))
    assert ops.resolve_auto(a, t, e, c, B_a=3, G=4, N=128,
                            tune_on_miss=False) == {"impl": "fused"}
    assert at.generation == g + 1
    want = ops.tlmac_matmul(a, t, e, c, B_a=3, G=4, N=128, impl="ref")
    assert torch.equal(ops.tlmac_matmul(a, t, e, c, **kw), want)
    monkeypatch.setenv(at.CACHE_ENV, str(cache))
    assert ops.resolve_auto(a, t, e, c, B_a=3, G=4, N=128,
                            tune_on_miss=False) == {"impl": "pallas"}


def test_auto_allow_filters_winners(cache, monkeypatch):
    a, t, e, c = _linear(seed=2)
    at.record(_key(a, t, e, 128), {"impl": "ref"}, 1.0)
    seen = []
    real = ops.dispatch_config

    def spy(config, *args, **kw):
        seen.append(config["impl"])
        return real(config, *args, **kw)

    monkeypatch.setattr(ops, "dispatch_config", spy)
    want = ops.tlmac_matmul(a, t, e, c, B_a=3, G=4, N=128, impl="ref")
    got = ops.tlmac_matmul(a, t, e, c, B_a=3, G=4, N=128, impl="auto",
                           auto_allow=("fused", "pallas"),
                           auto_default="fused")
    assert torch.equal(got, want) and seen[-1] == "fused"
    ops.tlmac_matmul(a, t, e, c, B_a=3, G=4, N=128, impl="auto")
    assert seen[-1] == "ref"                    # unrestricted: honoured


def test_tune_on_miss_false_never_tunes(cache, monkeypatch):
    a, t, e, c = _linear(seed=3)

    def boom(*a_, **k_):
        raise AssertionError("tune() ran")

    monkeypatch.setattr(at, "tune", boom)
    got = ops.tlmac_matmul(a, t, e, c, B_a=3, G=4, N=128, impl="auto",
                           tune_on_miss=False)
    assert torch.equal(got, ops.tlmac_matmul(a, t, e, c, B_a=3, G=4, N=128,
                                             impl="ref"))
    assert not cache.exists()
    # the serve linear never tunes inline either
    x = torch.randn((2, 3, 64), dtype=torch.bfloat16)
    p = nn.init_serve_linear(torch.Generator().manual_seed(3), 64, 128, CFG,
                             device="cpu")
    assert CFG.serve_tlmac_impl == "auto"
    nn.serve_linear_apply(p, x, CFG)
    assert not cache.exists()


_DISPATCH = ops.dispatch_config


def _sabotage(monkeypatch, impl, fn):
    def patched(config, *args, **kw):
        out = _DISPATCH(config, *args, **kw)
        return fn(out) if config["impl"] == impl else out

    monkeypatch.setattr(ops, "dispatch_config", patched)


def test_a_wrong_candidate_is_refused(cache, monkeypatch):
    a, t, e, c = _linear(seed=4)
    _sabotage(monkeypatch, "pallas", lambda out: out + 1)
    with pytest.raises(at.CandidateMismatch, match="pallas"):
        at.tune(a, t, e, c, B_a=3, G=4, N=128, reps=2,
                cands=[{"impl": "pallas"}, {"impl": "ref"}])
    assert not cache.exists()                   # nothing recorded


def test_a_kernel_error_propagates_and_a_refusal_skips(cache, monkeypatch):
    a, t, e, c = _linear(seed=5)

    def launch_error(out):
        raise RuntimeError("tlmac_gemm: CUDA launch failed")

    _sabotage(monkeypatch, "pallas", launch_error)
    with pytest.raises(RuntimeError, match="launch failed"):
        at.tune(a, t, e, c, B_a=3, G=4, N=128, reps=2,
                cands=[{"impl": "pallas"}])
    assert not cache.exists()

    def refusal(out):
        raise ValueError("shape not taken")

    _sabotage(monkeypatch, "pallas", refusal)
    cfg = at.tune(a, t, e, c, B_a=3, G=4, N=128, reps=2,
                  cands=[{"impl": "pallas"}])
    assert cfg == {"impl": "fused"}             # the baseline won alone


def _pool(B=2, KV=2, rep=2, hd=16, P=4, MB=3, kv="fp", seed=0):
    gen = torch.Generator().manual_seed(seed)
    spec = paged.PageSpec(page_size=P, n_pages=B * MB + 1, max_blocks=MB)
    qs = paged.KVQuantSpec(kv)
    pool = paged.zero_kv_pool(spec, KV, hd, qs, device="cpu")
    n = spec.n_pages * P
    k, v = torch.randn((2, n, KV, hd), generator=gen).to(torch.bfloat16)
    pid = torch.arange(spec.n_pages).repeat_interleave(P)
    off = torch.arange(P).repeat(spec.n_pages)
    paged._write_kv(pool, pid, off, k, v, qs)
    bt = (1 + torch.arange(B * MB, dtype=torch.int32)).reshape(B, MB)
    pos = torch.tensor([P * MB - 1, 5], dtype=torch.int32)[:B]
    q = torch.randn((B, 1, KV * rep, hd), generator=gen).to(torch.bfloat16)
    return q, pool, bt, pos, qs


@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_tune_attention_and_auto_dispatch(cache, kv):
    q, pool, bt, pos, qs = _pool(kv=kv)
    ks, vs = paged.pool_scales(pool)
    key = at.attn_shape_key(2, 2, 2, 16, 3, 4, None, kv_dtype=kv,
                            device="cpu")
    lax = paged.dispatch_attention({"impl": "lax"}, q, pool["k"], pool["v"],
                                   bt, pos, k_scales=ks, v_scales=vs,
                                   qspec=qs)
    auto = paged.paged_attention(q, pool["k"], pool["v"], bt, pos,
                                 k_scales=ks, v_scales=vs, qspec=qs)
    torch.testing.assert_close(auto.float(), lax.float(), rtol=2e-2,
                               atol=2e-2)
    assert not cache.exists()                   # a miss: flash, no tuning
    cfg = at.tune_attention(q, pool["k"], pool["v"], bt, pos, reps=2,
                            k_scales=ks, v_scales=vs, qspec=qs)
    assert cfg in ({"impl": "lax"}, at.ATTN_DEFAULT)
    assert at.lookup(key) == cfg
    at.reset_cache()
    cache.unlink()                              # a miss that may tune
    paged.paged_attention(q, pool["k"], pool["v"], bt, pos, k_scales=ks,
                          v_scales=vs, qspec=qs, tune_on_miss=True)
    assert key in json.loads(cache.read_text())
    at.record(key, {"impl": "lax"}, 1.0)
    got = paged.paged_attention(q, pool["k"], pool["v"], bt, pos,
                                k_scales=ks, v_scales=vs, qspec=qs)
    assert torch.equal(got, lax)


def test_tune_attention_refuses_a_wrong_candidate(cache, monkeypatch):
    q, pool, bt, pos, qs = _pool()
    real = paged.dispatch_attention

    def patched(config, *args, **kw):
        out = real(config, *args, **kw)
        return out + 1 if config.get("n_splits") == 2 else out

    monkeypatch.setattr(paged, "dispatch_attention", patched)
    with pytest.raises(at.CandidateMismatch, match="n_splits"):
        at.tune_attention(q, pool["k"], pool["v"], bt, pos, reps=2,
                          cands=[{"impl": "flash", "n_splits": 2}])
    assert not cache.exists()


def _requests(vocab, n=3):
    rng = np.random.default_rng(9)
    return [Request(rid=i, prompt=rng.integers(0, vocab, L).astype(np.int32),
                    max_new_tokens=4) for i, L in enumerate((5, 13, 9)[:n])]


def test_paged_loop_tunes_then_serves_auto(cache):
    cfg = smoke_config("codeqwen1.5-7b")
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0),
                        device="cpu")
    kw = dict(batch_slots=2, s_max=32, page_size=8, chunk=8, device="cpu")
    fixed = PagedServeLoop(params, dataclasses.replace(
        cfg, serve_tlmac_impl="fused"), attn_impl="flash", **kw)
    for r in _requests(cfg.vocab):
        fixed.submit(r)
    want = {r.rid: r.output.tolist() for r in fixed.run()}
    loop = PagedServeLoop(params, cfg, **kw)
    tuned = loop.tune(reps=1)
    # (K, N) of the smoke's linears: q/k/v/o 64 -> 64, wi/wg 64 -> 128,
    # wo 128 -> 64; each at the chunk's 8 rows and the decode step's 2
    gemm = {k for k in tuned if "|attn|" not in k}
    assert {k.split("|")[2].split(",Ba")[0] for k in gemm} == {
        f"M{m},K{k},N{n}" for m in (2, 8)
        for k, n in ((64, 64), (64, 128), (128, 64))}
    assert len(gemm) == 6 and len(tuned) == 7
    assert set(tuned) <= set(json.loads(cache.read_text()))
    assert loop.tune(reps=1) == tuned            # cached: nothing re-tuned
    for r in _requests(cfg.vocab):
        loop.submit(r)
    got = {r.rid: r.output.tolist() for r in loop.run()}
    assert got == want
    snap = loop.metrics()["autotune"]
    assert set(snap) == {"lookup_hits", "lookup_misses", "tuned_keys"}
    assert sorted(snap["tuned_keys"]) == sorted(tuned)
    assert snap["lookup_hits"] > 0
