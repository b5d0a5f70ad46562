"""Self-speculative decoding in the port against the JAX package: the
n-gram drafter, the verify-window page write, the ``[B, k+1]`` verify
forward and the speculative serve loop (the units of
``tests/test_spec_decode.py``, run on both packages).

- Drafter proposals, ``write_spec_kv`` pools (codes and scales, every
  page) and single verify forwards are bit-equal to JAX's.
- Within the port, verify row ``j`` equals sequential decode step ``j``
  (``serve_paged_attn_impl='lax'``) bit for bit, and a spec-on loop emits
  the spec-off loop's tokens at every accept rate.
- Loop level, teacher-forced as in ``tests/test_torch_serve.py``: every
  forward of the port loop hands it the JAX loop's logits of the same
  step, so both walk the same tokens; inputs (tokens and drafts,
  positions, ``n_writes``, block tables), accepted tokens, copy-on-write
  copies and preemptions must then be equal at every forward, and the
  logits within ``LOGIT_TOL`` x their scale (at least ``MIN_EXACT`` of
  the forwards bit-equal).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import smoke_config as jsmoke
from repro.kernels import paged as jpaged
from repro.models import lm as jlm
from repro.serve.loop import Request as JRequest
from repro.serve.paged import PagedServeLoop as JLoop
from repro.serve.spec import Drafter as JDrafter
from repro.serve.spec import NGramDrafter as JNGram
from repro.serve.spec import make_drafter as jmake_drafter

from repro_torch import convert
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.kernels import paged as tpaged
from repro_torch.models import lm as tlm
from repro_torch.serve.loop import Request
from repro_torch.serve.paged import PagedServeLoop
from repro_torch.serve.spec import Drafter, NGramDrafter, make_drafter

ARCH = "codeqwen1.5-7b"
S_MAX = 48
# x max |logit|, as tests/test_torch_serve.py.  Loop forwards differ from
# the jitted JAX loop's only where the logits GEMM sums in another order
# (torch's bf16 GEMM on the CPU against XLA's f32 dot): a few bf16 steps
LOGIT_TOL = 5e-2
MIN_EXACT = 0.75


def _replay(base):
    class ReplayDrafter(base):
        """``tests/test_spec_decode.py::ReplayDrafter``: replays each
        request's known continuation, corrupting every proposed token
        with probability ``corrupt_p`` (0: every draft right, 1: every
        window rejected at its first row)."""

        def __init__(self, streams, corrupt_p, vocab, seed=0):
            self.streams = [np.asarray(s, np.int64) for s in streams]
            self.p = corrupt_p
            self.vocab = vocab
            self.rng = np.random.default_rng(seed)

        def propose(self, context, k):
            ctx = np.asarray(context, np.int64)
            for s in self.streams:
                if len(s) >= len(ctx) and np.array_equal(s[: len(ctx)], ctx):
                    d = s[len(ctx): len(ctx) + k].astype(np.int32)
                    flip = self.rng.random(len(d)) < self.p
                    return np.where(flip, (d + 1) % self.vocab, d)
            return np.zeros(0, np.int32)
    return ReplayDrafter


TReplay, JReplay = _replay(Drafter), _replay(JDrafter)


# ---------------------------------------------------------------------------
# drafter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_n,min_n", [(3, 1), (1, 1), (4, 2), (2, 2)])
def test_ngram_drafter_matches_jax(max_n, min_n):
    """Seeded contexts over a small alphabet (many recurrences), short
    contexts below ``n + 1`` and ``k`` from 0 past the continuation."""
    t, j = NGramDrafter(max_n, min_n), JNGram(max_n, min_n)
    rng = np.random.default_rng(max_n * 10 + min_n)
    n_hits = 0
    for trial in range(60):
        L = int(rng.integers(0, 24))
        ctx = rng.integers(0, 4 if trial % 2 else 9, L).astype(np.int32)
        for k in (0, 1, 3, 7, 30):
            got, want = t.propose(ctx, k), j.propose(ctx, k)
            assert got.dtype == want.dtype == np.int32
            assert got.tolist() == want.tolist(), (ctx.tolist(), k)
            n_hits += bool(len(got))
    assert n_hits > 20             # the contexts do recur
    ctx = np.array([7, 1, 2, 3, 9, 9, 1, 2, 3], np.int32)
    assert NGramDrafter().propose(ctx, 3).tolist() == [9, 9, 1]


def test_make_drafter_accepts_and_refuses_as_jax():
    assert isinstance(make_drafter("ngram"), NGramDrafter)
    assert make_drafter("none") is None and make_drafter(None) is None
    custom = NGramDrafter(max_n=2)
    assert make_drafter(custom) is custom
    for bad, err in (("tiny-llama", ValueError), (7, TypeError)):
        with pytest.raises(err) as got:
            make_drafter(bad)
        with pytest.raises(err) as want:
            jmake_drafter(bad)
        assert str(got.value) == str(want.value)
    for args in ((1, 2), (0, 0)):
        with pytest.raises(ValueError, match="min_n"):
            NGramDrafter(*args)
        with pytest.raises(ValueError, match="min_n"):
            JNGram(*args)


# ---------------------------------------------------------------------------
# the verify-window page write
# ---------------------------------------------------------------------------


def _random_pool(rng, dtype, n_pages, P, KV, hd):
    """A pool full of random content (untouched slots must stay so)."""
    qs = jpaged.KVQuantSpec(dtype)
    if not qs.quantised:
        a = lambda: rng.standard_normal((n_pages, P, KV, hd)).astype(
            np.float32)
        return {"k": jnp.asarray(a(), jnp.bfloat16),
                "v": jnp.asarray(a(), jnp.bfloat16)}
    cw = qs.code_width(hd)
    c = lambda: rng.integers(-128, 128, (n_pages, P, KV, cw)).astype(np.int8)
    s = lambda: jnp.asarray(rng.uniform(0.1, 2, (n_pages, P, KV)),
                            jnp.bfloat16)
    return {"k": jnp.asarray(c()), "v": jnp.asarray(c()), "ks": s(),
            "vs": s()}


def _write_both(dtype, pool, k, v, bt, positions, n_writes):
    qs = jpaged.KVQuantSpec(dtype)
    want = jpaged.write_spec_kv(dict(pool), jnp.asarray(k, jnp.bfloat16),
                                jnp.asarray(v, jnp.bfloat16), jnp.asarray(bt),
                                jnp.asarray(positions), jnp.asarray(n_writes),
                                qs)
    tpool = convert.pool_from_jax(jax.tree.map(np.asarray, pool),
                                  device="cpu")
    tk = convert.to_torch(np.asarray(jnp.asarray(k, jnp.bfloat16)), "cpu")
    tv = convert.to_torch(np.asarray(jnp.asarray(v, jnp.bfloat16)), "cpu")
    got = tpaged.write_spec_kv(tpool, tk, tv, torch.from_numpy(bt),
                               torch.from_numpy(positions),
                               torch.from_numpy(n_writes),
                               tpaged.KVQuantSpec(dtype))
    assert got is tpool                       # written in place
    want = convert.pool_from_jax(jax.tree.map(np.asarray, want),
                                 device="cpu")
    return got, want


def _assert_pool_equal(got, want):
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        a, b = got[name], want[name]
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", ["fp", "int8", "int4"])
def test_write_spec_kv_matches_jax(dtype):
    """Random windows (live slots, an idle slot, page-boundary crossings,
    n_writes 0..K1) on random pools: the whole pool after the write is
    JAX's, codes and scales; the valid rows land where the block table
    says, and everything else the write touched is page 0."""
    rng = np.random.default_rng({"fp": 0, "int8": 1, "int4": 2}[dtype])
    B, P, MB, KV, hd, K1 = 4, 8, 4, 2, 8, 5
    n_pages = B * MB + 1
    for trial in range(6):
        pool = _random_pool(rng, dtype, n_pages, P, KV, hd)
        bt = np.zeros((B, MB), np.int32)
        for b in range(B - 1):                # the last slot idle
            bt[b] = 1 + rng.permutation(n_pages - 1)[:MB]
        positions = rng.integers(0, MB * P - K1, B).astype(np.int32)
        positions[B - 1] = 0
        n_writes = rng.integers(0, K1 + 1, B).astype(np.int32)
        n_writes[B - 1] = 0
        k = rng.standard_normal((B, K1, KV, hd)).astype(np.float32)
        v = rng.standard_normal((B, K1, KV, hd)).astype(np.float32)
        before = convert.pool_from_jax(jax.tree.map(np.asarray, pool),
                                       device="cpu")
        got, want = _write_both(dtype, pool, k, v, bt, positions, n_writes)
        _assert_pool_equal(got, want)
        # pages other than the valid targets and page 0 are untouched
        targets = {int(bt[b, (positions[b] + j) // P])
                   for b in range(B) for j in range(n_writes[b])}
        for pg in set(range(1, n_pages)) - targets:
            for name in got:
                assert torch.equal(got[name][pg], before[name][pg]), pg


def test_write_spec_routes_padding_to_scratch():
    """``tests/test_spec_decode.py``'s case on both packages: slot 1
    crosses a page boundary, slot 2 is idle; padding rows land only in
    page 0."""
    B, P, MB, KV, hd, K1 = 3, 8, 4, 2, 4, 4
    n_pages = B * MB + 1
    rng = np.random.default_rng(0)
    pool = _random_pool(rng, "fp", n_pages, P, KV, hd)
    bt = np.zeros((B, MB), np.int32)
    for b in range(2):
        bt[b] = 1 + b * MB + np.arange(MB)
    positions = np.array([5, 30, 0], np.int32)
    n_writes = np.array([4, 2, 0], np.int32)
    ones = np.ones((B, K1, KV, hd), np.float32)
    got, want = _write_both("fp", pool, ones, ones, bt, positions, n_writes)
    _assert_pool_equal(got, want)
    k = got["k"].float().numpy()
    expect = np.asarray(pool["k"], np.float32).copy()
    for b, (pos, nw) in enumerate(zip(positions, n_writes)):
        for j in range(K1):
            p = pos + j
            expect[bt[b, p // P] if j < nw else 0, p % P] = 1.0
    assert np.array_equal(k, expect)


@pytest.mark.parametrize("dtype", ["fp", "int8"])
def test_write_spec_clamps_padded_rows_past_block_table(dtype):
    """A window straddling the end of the table: padding rows' ``pos //
    P`` index one past the last block, clamp, and land in page 0."""
    P, MB, KV, hd = 4, 2, 1, 2
    rng = np.random.default_rng(5)
    pool = _random_pool(rng, dtype, 4, P, KV, hd)
    before = convert.pool_from_jax(jax.tree.map(np.asarray, pool),
                                   device="cpu")
    bt = np.array([[1, 2]], np.int32)
    k = np.full((1, 4, KV, hd), 3.0, np.float32)
    got, want = _write_both(dtype, pool, k, k, bt, np.array([6], np.int32),
                            np.array([2], np.int32))
    _assert_pool_equal(got, want)
    for name in got:
        assert not torch.equal(got[name][0], before[name][0])   # padding
        assert torch.equal(got[name][1], before[name][1])       # clean
        assert torch.equal(got[name][3], before[name][3])
        assert torch.equal(got[name][2, :2], before[name][2, :2])


# ---------------------------------------------------------------------------
# the verify forward
# ---------------------------------------------------------------------------

_models = {}


def _model(arch, kv_dtype="fp"):
    key = (arch, kv_dtype)
    if key not in _models:
        jcfg = dataclasses.replace(jsmoke(arch), serve_paged_attn_impl="lax",
                                   serve_kv_dtype=kv_dtype)
        tcfg = dataclasses.replace(tsmoke(arch), serve_paged_attn_impl="lax",
                                   serve_kv_dtype=kv_dtype)
        params, _ = jlm.init_lm(jax.random.PRNGKey(0), jcfg, purpose="serve")
        tp = convert.params_from_jax(jax.tree.map(np.asarray, params),
                                     device="cpu")
        _models[key] = (jcfg, tcfg, params, tp)
    return _models[key]


def _prefilled(arch, kv_dtype, B=2, L=11, C=8, P=8):
    """Both packages' caches after a two-chunk prefill of slot 0 (slot 1
    keeps one page of its own and a shorter history).  Returns the
    models, caches, block table and the prefill's argmax."""
    jcfg, tcfg, params, tp = _model(arch, kv_dtype)
    spec = jpaged.spec_for(S_MAX, B, page_size=P)
    jc, _ = jlm.init_caches(jcfg, B, S_MAX, paged=spec)
    tc = tlm.init_caches(tcfg, tpaged.spec_for(S_MAX, B, page_size=P),
                         device="cpu")
    rng = np.random.default_rng(0)
    bt = np.zeros((B, spec.max_blocks), np.int32)
    bt[0, :4] = [3, 1, 4, 2]
    bt[1, :2] = [5, 6]
    lens = [L, 5]
    tok0 = []
    for b in range(B):
        prompt = rng.integers(0, jcfg.vocab, lens[b]).astype(np.int32)
        for ci in range(-(-lens[b] // C)):
            buf = np.zeros(C, np.int32)
            seg = prompt[ci * C:(ci + 1) * C]
            buf[: len(seg)] = seg
            last = (lens[b] - 1) - ci * C if (ci + 1) * C >= lens[b] else 0
            jl, jc = jlm.prefill_chunk(
                params, jc, jnp.asarray(buf[None]), jnp.int32(ci * C),
                jnp.asarray(bt[b]), jcfg, last=jnp.int32(last))
            tlm.prefill_chunk(tp, tc, torch.from_numpy(buf[None]), ci * C,
                              torch.from_numpy(bt[b]), tcfg, last=last)
        tok0.append(int(np.argmax(np.asarray(jl))))
    return jcfg, tcfg, params, tp, jc, tc, bt, np.array(lens, np.int32), tok0


def _clone(caches):
    return [{b: {n: t.clone() for n, t in pool.items()}
             for b, pool in seg.items()} for seg in caches]


@pytest.mark.parametrize("arch,kv_dtype", [
    ("codeqwen1.5-7b", "fp"), ("codeqwen1.5-7b", "int8"),
    ("codeqwen1.5-7b", "int4"), ("mistral-large-123b", "fp"),
    ("mistral-large-123b", "int8")])
def test_verify_step_matches_jax(arch, kv_dtype):
    """One verify window over two slots (slot 1 with a short draft and a
    padding row) on the same caches and params: the pool after it equal
    to JAX's, and every row of logits bit-equal to JAX's.  Three roundings
    of XLA's that the port copies decide this: ``jax.nn.silu`` rounds
    each op to bf16 (``nn.silu``), the norm after a block's attention
    reads the residual sum in f32 (``lm.apply_block``), and the gated
    product reaches ``wo`` in f32 (``lm.ffn_apply``).  Without them a
    bf16 ulp moves a 3-bit activation code and the row differs (mistral
    int8: 10% of the logit scale)."""
    jcfg, tcfg, params, tp, jc, tc, bt, lens, tok0 = _prefilled(arch,
                                                                kv_dtype)
    K1 = 4
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab, (2, K1)).astype(np.int32)
    toks[:, 0] = tok0
    n_writes = np.array([K1, 2], np.int32)
    jl, jc2 = jlm.verify_step_paged(params, jc, jnp.asarray(toks),
                                    jnp.asarray(lens), jnp.asarray(n_writes),
                                    jnp.asarray(bt), jcfg)
    tl, tc2 = tlm.verify_step_paged(tp, tc, torch.from_numpy(toks),
                                    torch.from_numpy(lens),
                                    torch.from_numpy(n_writes),
                                    torch.from_numpy(bt), tcfg)
    assert tc2 is tc                          # written in place
    want = np.asarray(jl, np.float32)
    got = tl.float().numpy()
    assert got.shape == want.shape == (2, K1, jcfg.vocab)
    rows = [np.array_equal(got[b, j], want[b, j])
            for b in range(2) for j in range(K1)]
    assert all(rows), rows
    jpool = convert.pool_from_jax(jax.tree.map(np.asarray, jc2), device="cpu")
    _assert_pool_equal(tc[0]["b0"], jpool[0]["b0"])


@pytest.mark.parametrize("arch,kv_dtype", [
    ("codeqwen1.5-7b", "fp"), ("codeqwen1.5-7b", "int8"),
    ("mistral-large-123b", "fp"), ("mistral-large-123b", "int8")])
def test_verify_rows_bitexact_vs_sequential_decode(arch, kv_dtype):
    """Within the port: with the true continuation as draft, verify row
    ``j`` equals the ``j``-th sequential ``decode_step_paged`` with the
    ``'lax'`` reader, bit for bit (both slots, one with a shorter
    window)."""
    _, tcfg, _, tp, _, tc, bt, lens, tok0 = _prefilled(arch, kv_dtype)
    K1 = 4
    seq_caches = _clone(tc)
    toks = [list(tok0)]
    seq = []
    for step in range(K1):
        cur = torch.tensor([[t] for t in toks[-1]], dtype=torch.int32)
        lg, _ = tlm.decode_step_paged(
            tp, seq_caches, cur, torch.from_numpy(lens + step),
            torch.from_numpy(bt), tcfg)
        seq.append(lg.clone())
        toks.append([int(x) for x in torch.argmax(lg, -1)])
    window = np.array(toks[:K1], np.int32).T           # [B, K1]
    n_writes = np.array([K1, 3], np.int32)
    vl, _ = tlm.verify_step_paged(tp, tc, torch.from_numpy(window),
                                  torch.from_numpy(lens),
                                  torch.from_numpy(n_writes),
                                  torch.from_numpy(bt), tcfg)
    for b in range(2):
        for j in range(n_writes[b]):
            assert torch.equal(vl[b, j], seq[j][b]), (b, j)
    # the window wrote every valid row's K/V as the decode steps did
    for name, leaf in tc[0]["b0"].items():
        for b in range(2):
            for j in range(n_writes[b]):
                p = int(lens[b]) + j
                pg = int(bt[b, p // 8])
                assert torch.equal(leaf[:, pg, p % 8],
                                   seq_caches[0]["b0"][name][:, pg, p % 8])


def test_decode_reader_follows_config():
    """``'lax'`` runs the gathered reader, ``'auto'``/``'flash'`` the
    flash-decode kernel (its plain version here): each within the decode
    tolerance of the other, the two readers distinct code paths; an
    unknown reader raises."""
    _, tcfg, _, tp, _, tc, bt, lens, tok0 = _prefilled(ARCH, "fp")
    cur = torch.tensor([[t] for t in tok0], dtype=torch.int32)
    out = {}
    for impl in ("lax", "auto", "flash"):
        cfg = dataclasses.replace(tcfg, serve_paged_attn_impl=impl)
        out[impl], _ = tlm.decode_step_paged(
            tp, _clone(tc), cur, torch.from_numpy(lens),
            torch.from_numpy(bt), cfg)
    assert torch.equal(out["auto"], out["flash"])
    scale = out["lax"].float().abs().max()
    assert (out["lax"].float() - out["flash"].float()).abs().max() \
        <= 2e-2 * scale
    with pytest.raises(ValueError, match="not in"):
        tlm.decode_step_paged(
            tp, _clone(tc), cur, torch.from_numpy(lens),
            torch.from_numpy(bt),
            dataclasses.replace(tcfg, serve_paged_attn_impl="flash-lax"))


# ---------------------------------------------------------------------------
# the speculative loop
# ---------------------------------------------------------------------------


def _reqs(vocab, seed, lengths, max_new):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, n).astype(np.int32), mn)
            for n, mn in zip(lengths, max_new)]


def _shared(vocab, seed=3):
    prompt = np.random.default_rng(seed).integers(0, vocab, 16) \
        .astype(np.int32)
    return [(prompt, 4), (prompt.copy(), 7), (prompt.copy(), 5)]


# name: (workload, loop kwargs, spec_k, corruption, drafter seed, eos)
# 'mixed' is test_spec_loop_bitexact_at_accept_rate's workload, 'prefix'
# its rollback next to prefix-cached (CoW'd) pages, 'eos' the stop mid
# window (``_eos``)
CASES = {
    "mixed-p0": ("mixed", 3, 0.0, 2, False),
    "mixed-p0.4": ("mixed", 3, 0.4, 2, False),
    "mixed-p1": ("mixed", 3, 1.0, 2, False),
    "prefix-p0.5": ("prefix", 3, 0.5, 4, False),
    "eos-p0": ("eos", 4, 0.0, 0, True),
}
WORKLOADS = {
    "mixed": (lambda v: _reqs(v, 1, [6, 11, 3, 9], [6, 8, 5, 6]),
              dict(batch_slots=2, page_size=8, chunk=8)),
    "prefix": (_shared, dict(batch_slots=1, page_size=8, chunk=8)),
    "eos": (lambda v: _reqs(v, 8, [6, 9], [12, 12]),
            dict(batch_slots=2, page_size=8, chunk=8)),
}

_runs = {}


def _submit(loop, reqs, R):
    for i, (p, mn) in enumerate(reqs):
        loop.submit(R(rid=i, prompt=p.copy(), max_new_tokens=mn))
    return {r.rid: np.asarray(r.output).tolist() for r in loop.run()}


def _jax_spec_off(workload):
    """JAX's spec-off 'lax' outputs: the replay drafter's streams."""
    key = ("jax-off", workload)
    if key not in _runs:
        jcfg, _, params, _ = _model(ARCH)
        make, kw = WORKLOADS[workload]
        loop = JLoop(params, jcfg, s_max=S_MAX, spec_k=0, attn_impl="lax",
                     **kw)
        _runs[key] = _submit(loop, make(jcfg.vocab), JRequest)
    return _runs[key]


def _eos(free):
    """The eos of the 'eos' case: the first token of request 0's
    free-running output that differs from its first token, so the stop
    lands mid-stream and, with perfect drafts, inside a verify window
    (the smoke model repeats a few tokens, so a later position's token
    may equal the first)."""
    return next(t for t in free[0] if t != free[0][0])


def _streams(reqs, outs):
    return [np.concatenate([p, np.asarray(outs[i], np.int32)])
            for i, (p, _) in enumerate(reqs)]


def _case(name):
    workload, k, p, seed, with_eos = CASES[name]
    make, kw = WORKLOADS[workload]
    vocab = tsmoke(ARCH).vocab
    reqs = make(vocab)
    free = _jax_spec_off(workload)
    eos = _eos(free) if with_eos else None
    return reqs, kw, k, p, seed, eos, _streams(reqs, free)


def _hook(loop, names, record):
    """Wrap ``loop``'s forwards and events ``names`` with ``record``."""
    for name in names:
        setattr(loop, name, record(name, getattr(loop, name)))


def _jax_spec_run(name):
    if ("jax", name) in _runs:
        return _runs[("jax", name)]
    reqs, kw, k, p, seed, eos, streams = _case(name)
    jcfg, _, params, _ = _model(ARCH)
    loop = JLoop(params, jcfg, s_max=S_MAX, eos_id=eos, spec_k=k,
                 drafter=JReplay(streams, p, jcfg.vocab, seed=seed), **kw)
    log = []

    def record(kind, fn):
        def wrapper(*a):
            if kind in ("_prefill_chunk", "_decode", "_verify"):
                logits, caches = fn(*a)
                # copies: the JAX loop's host buffers are mutated later
                log.append((kind, [np.array(x, copy=True) for x in a[2:]],
                            np.asarray(logits, np.float32)))
                return logits, caches
            if kind == "_accept":
                log.append((kind, [int(a[0]), [int(t) for t in a[2]]],
                            None))
            else:
                log.append((kind, [int(x) for x in a], None))
            return fn(*a)
        return wrapper
    names = ("_prefill_chunk", "_decode", "_verify", "_accept", "_cow",
             "_preempt")
    jitted = {n: getattr(loop, n) for n in names}
    _hook(loop, names, record)
    done = _submit(loop, reqs, JRequest)
    for n, fn in jitted.items():           # compiled_shapes reads the jits
        setattr(loop, n, fn)
    out = dict(log=log, done=done, spec=loop.spec_stats(),
               shapes=loop.compiled_shapes(), cow=loop.cow_copies,
               saved=loop.prefill_tokens_saved)
    _runs[("jax", name)] = out
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_spec_loop_teacher_forced_vs_jax(name):
    reqs, kw, k, p, seed, eos, streams = _case(name)
    want = _jax_spec_run(name)
    _, tcfg, _, tp = _model(ARCH)
    loop = PagedServeLoop(tp, tcfg, s_max=S_MAX, eos_id=eos, spec_k=k,
                          drafter=TReplay(streams, p, tcfg.vocab, seed=seed),
                          check_invariants=True, device="cpu", **kw)
    assert loop.cfg.serve_paged_attn_impl == "lax"
    it = iter(want["log"])
    pairs = []

    def record(kind, fn):
        def wrapper(*a):
            jkind, jargs, jlogits = next(it)
            assert kind == jkind, (kind, jkind)
            if kind == "_accept":
                assert [int(a[0]), [int(t) for t in a[2]]] == jargs
                return fn(*a)
            if kind in ("_cow", "_preempt"):
                assert [int(x) for x in a] == jargs, kind
                return fn(*a)
            mine = [np.asarray(x) for x in a]
            assert len(mine) == len(jargs), kind
            for m, j in zip(mine, jargs):    # tokens and drafts, positions,
                assert np.array_equal(m, j), kind   # n_writes, block tables
            out = fn(*a)
            pairs.append((out.float().numpy(), jlogits))
            return torch.from_numpy(jlogits)
        return wrapper
    _hook(loop, ("_prefill_chunk", "_decode", "_verify", "_accept", "_cow",
                 "_preempt"), record)
    done = _submit(loop, reqs, Request)
    assert next(it, None) is None               # the same number of events
    assert done == want["done"]
    assert loop.spec_stats() == want["spec"]
    # one shape per forward; a run whose every step drafted never decodes
    assert loop.compiled_shapes() == want["shapes"] == \
        {"chunk": 1, "decode": int(loop.decode_steps > 0), "verify": 1}
    assert (loop.cow_copies, loop.prefill_tokens_saved) == \
        (want["cow"], want["saved"])
    loop.check_compiled()
    loop.pages.check()
    loop.prefix.check()
    exact = sum(np.array_equal(g, w) for g, w in pairs)
    assert exact >= MIN_EXACT * len(pairs), (exact, len(pairs))
    for got, w in pairs:
        np.testing.assert_allclose(got, w, atol=LOGIT_TOL * np.abs(w).max(),
                                   rtol=0)
    st = want["spec"]
    assert st["spec_steps"] > 0
    if p == 0.0 and eos is None:     # eos drops the rest of a window
        assert st["accept_rate"] == 1.0 and st["tokens_per_step"] > 1.5
    if p == 1.0:
        assert st["accepted"] == 0 and st["tokens_per_step"] == 1.0
    if name.startswith("prefix"):
        assert want["cow"] >= 2 and want["saved"] > 0
    if eos is not None:
        assert 1 < len(done[0]) < 12 and done[0][-1] == eos


@pytest.mark.parametrize("name", list(CASES))
def test_spec_loop_equals_spec_off_in_the_port(name):
    """Free-running port loops: speculation on (replay drafts over the
    port's own spec-off tokens) emits exactly the spec-off ``'lax'``
    loop's tokens at every accept rate, with rollback next to shared
    pages and eos inside a window."""
    reqs, kw, k, p, seed, _, _ = _case(name)
    _, tcfg, _, tp = _model(ARCH)
    off = PagedServeLoop(tp, tcfg, s_max=S_MAX, attn_impl="lax",
                         device="cpu", **kw)
    free = _submit(off, reqs, Request)
    eos = _eos(free) if CASES[name][4] else None
    if eos is not None:
        off = PagedServeLoop(tp, tcfg, s_max=S_MAX, attn_impl="lax",
                             eos_id=eos, device="cpu", **kw)
        want = _submit(off, reqs, Request)
        assert len(want[0]) < len(free[0])        # eos fired
    else:
        want = free
    assert off.compiled_shapes() == {"chunk": 1, "decode": 1}
    on = PagedServeLoop(tp, tcfg, s_max=S_MAX, eos_id=eos, spec_k=k,
                        drafter=TReplay(_streams(reqs, free), p, tcfg.vocab,
                                        seed=seed),
                        check_invariants=True, device="cpu", **kw)
    assert _submit(on, reqs, Request) == want
    st = on.spec_stats()
    assert st["spec_steps"] > 0
    assert on.gen_tokens == sum(len(o) - 1 for o in want.values())
    on.check_compiled()
    on.prefix.evict(10**6)
    on.pages.check()
    assert on.pages.in_use == 0


def test_ngram_loop_serves_and_counts():
    """The default n-gram drafter on prompts that repeat a span: drafts
    are proposed and accepted, outputs equal the spec-off loop's, and the
    forward set is the three shapes."""
    _, tcfg, _, tp = _model(ARCH)
    rng = np.random.default_rng(12)
    span = rng.integers(0, tcfg.vocab, 6).astype(np.int32)
    reqs = [(np.concatenate([span, rng.integers(0, tcfg.vocab, 3)
                             .astype(np.int32), span]).astype(np.int32), 8),
            (rng.integers(0, tcfg.vocab, 9).astype(np.int32), 6)]
    kw = dict(batch_slots=2, page_size=8, chunk=8)
    off = PagedServeLoop(tp, tcfg, s_max=S_MAX, attn_impl="lax",
                         device="cpu", **kw)
    want = _submit(off, reqs, Request)
    on = PagedServeLoop(tp, dataclasses.replace(tcfg, serve_spec_k=3),
                        s_max=S_MAX, device="cpu", **kw)
    assert isinstance(on.drafter, NGramDrafter)
    assert _submit(on, reqs, Request) == want
    assert on.spec_proposed > 0 and on.spec_steps > 0
    st = on.spec_stats()
    assert st["tokens_per_step"] >= 1.0
    assert on.slot_steps >= on.spec_steps


def test_spec_knobs_and_constructor_errors():
    """The reference's knobs and ``ValueError``s: spec_k and the drafter
    flow from the config; drafter 'none' disarms speculation (no verify
    forward, decode reader unpinned); a drafter with speculation off and
    a reader that conflicts with speculation are refused, on both
    packages."""
    jcfg, tcfg, params, tp = _model(ARCH)
    tbase = dataclasses.replace(tcfg, serve_paged_attn_impl="auto")
    jbase = dataclasses.replace(jcfg, serve_paged_attn_impl="auto")
    kw = dict(batch_slots=1, s_max=32, page_size=8, chunk=8)
    on = PagedServeLoop(tp, dataclasses.replace(tbase, serve_spec_k=2),
                        device="cpu", **kw)
    assert on.spec_k == 2 and isinstance(on.drafter, NGramDrafter)
    assert "verify" in on.forwards
    assert on.cfg.serve_paged_attn_impl == "lax"
    none = PagedServeLoop(tp, dataclasses.replace(
        tbase, serve_spec_k=2, serve_spec_drafter="none"), device="cpu",
        **kw)
    assert none.drafter is None and "verify" not in none.forwards
    assert none.cfg.serve_paged_attn_impl == "auto"
    off = PagedServeLoop(tp, tbase, device="cpu", **kw)
    assert off.spec_k == 0 and set(off.forwards) == {"chunk", "decode"}
    assert off.compiled_shapes() == {"chunk": 0, "decode": 0}
    ok = PagedServeLoop(tp, tbase, spec_k=2, attn_impl="lax", device="cpu",
                        **kw)
    assert ok.cfg.serve_paged_attn_impl == "lax"
    for (T, P, cfg), R in (((PagedServeLoop, tp, tbase), dict(device="cpu")),
                           ((JLoop, params, jbase), {})):
        with pytest.raises(ValueError, match="speculation is off"):
            T(P, cfg, drafter=NGramDrafter() if T is PagedServeLoop
              else JNGram(), **kw, **R)
        for impl in ("flash", "flash-lax"):
            with pytest.raises(ValueError, match="conflicts with"):
                T(P, cfg, spec_k=2, attn_impl=impl, **kw, **R)
    with pytest.raises(ValueError, match="not in"):
        PagedServeLoop(tp, tbase, attn_impl="flash-lax", device="cpu", **kw)
