"""The MoE family (``moe-gqa``) in the port's serve loops against the JAX
package's, on ``tests/test_serve_oracle.py``'s workload (five requests,
two slots, pages and chunks of 8, s_max 48).

- The paged loop, teacher-forced against the JAX paged loop with the
  prefix cache on and off (gathered ``'lax'`` reader on both): every
  forward's inputs (tokens, starts, ``last``, positions, block tables)
  equal, every logits row bit-equal but for the vocab head's allowance
  (``_torch_families.HEAD_ULP_SHARE``), the outputs equal.
- The dense ``ServeLoop``, teacher-forced against the JAX one as
  ``test_torch_dense_loop.py`` holds the dense families: inputs equal at
  every call, logits rows under the head's allowance, outputs and refills
  equal, the caches bit-equal (the rotary's sin and cos are the C
  library's on both sides: ``nn.libm_sincosf``).
- The reference's paged-vs-dense outcome, mirrored: the MoE capacity
  depends on the routing group's length (a paged prefill routes chunks
  of 8 tokens, the dense oracle the whole prompt), so some requests'
  paged tokens differ from the dense oracle's in the reference
  (``test_serve_oracle.py::...[moe-gqa-*]`` fails there).  The port's
  free-running paged loop must give JAX's paged tokens, its dense
  ``ServeLoop`` JAX's dense tokens, and so the same requests differ.
"""

import numpy as np
import pytest

import jax
import torch

from repro.serve.loop import Request as JRequest
from repro.serve.loop import ServeLoop as JServeLoop
from repro.serve.paged import PagedServeLoop as JLoop

from repro_torch import convert
from repro_torch.serve.loop import Request, ServeLoop
from repro_torch.serve.paged import PagedServeLoop

import _torch_families as F
from test_torch_dense_loop import _caches_equal, _run_jax_loop

LENGTHS = (6, 11, 3, 9, 5)          # tests/test_serve_oracle.py's workload
MAX_NEW = (4, 6, 3, 5, 4)
S_MAX = 48
LOOP = dict(batch_slots=2, s_max=S_MAX, page_size=8, chunk=8,
            attn_impl="lax")

_runs: dict = {}


def _workload(vocab):
    rng = np.random.default_rng(7)
    return [(rng.integers(0, vocab, n).astype(np.int32), mn)
            for n, mn in zip(LENGTHS, MAX_NEW)]


def _jax_paged(prefix_cache):
    """The JAX paged loop over the workload: every forward's inputs and
    logits in order, and the outputs."""
    if prefix_cache in _runs:
        return _runs[prefix_cache]
    jcfg, _, params, _ = F.model("moe-gqa")
    loop = JLoop(params, jcfg, prefix_cache=prefix_cache, **LOOP)
    log = []
    for kind in ("_prefill_chunk", "_decode"):
        fn = getattr(loop, kind)

        def wrapper(*a, _fn=fn, _kind=kind):
            logits, caches = _fn(*a)
            log.append((_kind, [np.array(x, copy=True) for x in a[2:]],
                        np.asarray(logits, np.float32)))
            return logits, caches
        setattr(loop, kind, wrapper)
    for i, (p, mn) in enumerate(_workload(jcfg.vocab)):
        loop.submit(JRequest(rid=i, prompt=p.copy(), max_new_tokens=mn))
    done = {r.rid: r.output.tolist() for r in loop.run()}
    _runs[prefix_cache] = (log, done, loop.refills)
    return _runs[prefix_cache]


@pytest.mark.parametrize("prefix_cache", [True, False],
                         ids=["cache", "nocache"])
def test_moe_paged_loop_teacher_forced_vs_jax(prefix_cache):
    jlog, jdone, jrefills = _jax_paged(prefix_cache)
    _, tcfg, _, tp = F.model("moe-gqa")
    loop = PagedServeLoop(tp, tcfg, prefix_cache=prefix_cache,
                          check_invariants=True, device="cpu", **LOOP)
    it = iter(jlog)
    pairs = []

    def forced(kind, fn):
        def wrapper(*a):
            jkind, jargs, jlogits = next(it)
            assert kind == jkind
            for m, j in zip(a, jargs):
                assert np.array_equal(np.asarray(m), j), kind
            got = fn(*a).float().numpy()
            for r, (g, w) in enumerate(zip(np.atleast_2d(got),
                                           np.atleast_2d(jlogits))):
                pairs.append((f"{kind} {len(pairs)}.{r}", w, g))
            return torch.from_numpy(jlogits)
        return wrapper

    loop._prefill_chunk = forced("_prefill_chunk", loop._prefill_chunk)
    loop._decode = forced("_decode", loop._decode)
    for i, (p, mn) in enumerate(_workload(tcfg.vocab)):
        loop.submit(Request(rid=i, prompt=p.copy(), max_new_tokens=mn))
    done = {r.rid: r.output.tolist() for r in loop.run()}
    assert next(it, None) is None               # every forward replayed
    assert done == jdone and loop.refills == jrefills >= 3
    bad, exact = F.rows_match(pairs)
    assert not bad, bad
    assert exact >= len(pairs) - 1, (exact, len(pairs))
    loop.check_compiled()
    assert loop.compiled_shapes() == {"chunk": 1, "decode": 1}
    loop.pages.check()


def test_moe_paged_vs_dense_outcome_equals_the_reference():
    jcfg, tcfg, params, tp = F.model("moe-gqa")
    work = _workload(jcfg.vocab)
    jsolo = JServeLoop(params, jcfg, batch_slots=1, s_max=S_MAX)
    tsolo = ServeLoop(tp, tcfg, batch_slots=1, s_max=S_MAX, device="cpu")
    for i, (p, mn) in enumerate(work):
        jsolo.submit(JRequest(rid=i, prompt=p, max_new_tokens=mn))
        jsolo.run()
        tsolo.submit(Request(rid=i, prompt=p, max_new_tokens=mn))
        tsolo.run()
    jdense = {r.rid: r.output.tolist() for r in jsolo.done}
    tdense = {r.rid: r.output.tolist() for r in tsolo.done}
    assert tdense == jdense
    for prefix_cache in (True, False):
        _, jpaged, _ = _jax_paged(prefix_cache)
        loop = PagedServeLoop(tp, tcfg, prefix_cache=prefix_cache,
                              device="cpu", **LOOP)
        for i, (p, mn) in enumerate(work):
            loop.submit(Request(rid=i, prompt=p.copy(), max_new_tokens=mn))
        tpaged = {r.rid: r.output.tolist() for r in loop.run()}
        assert tpaged == jpaged, prefix_cache
        jdiff = {rid for rid in jdense if jpaged[rid] != jdense[rid]}
        tdiff = {rid for rid in tdense if tpaged[rid] != tdense[rid]}
        # the reference's own failure: capacity drops of chunked groups
        assert tdiff == jdiff and jdiff, (prefix_cache, jdiff)


def test_moe_dense_loop_teacher_forced_vs_jax(monkeypatch):
    from repro_torch.models import lm as tlm

    jcfg, tcfg, params, tp = F.model("moe-gqa")
    log, jdone, jrefills = _run_jax_loop(jcfg, params, monkeypatch)
    it = iter(log)
    pairs = []
    real_prefill, real_decode = tlm.prefill, tlm.decode_step

    def prefill(p, tokens, cfg, S_max=None):
        kind, jt, jl, jc = next(it)
        assert kind == "prefill" and np.array_equal(tokens.numpy(), jt)
        lg, c = real_prefill(p, tokens, cfg, S_max=S_max)
        pairs.extend((f"prefill {b}", F.to_np(jl[b]), lg[b].float().numpy())
                     for b in range(lg.shape[0]))
        assert _caches_equal(c, jc), "prefill caches"
        return convert.to_torch(jl, "cpu"), c

    def decode(p, c, tokens, pos, cfg):
        kind, jt, jpos, jl, jc = next(it)
        assert kind == "decode" and pos == jpos
        assert np.array_equal(tokens.numpy(), jt)
        lg, c = real_decode(p, c, tokens, pos, cfg)
        pairs.extend((f"decode {pos}.{b}", F.to_np(jl[b]),
                      lg[b].float().numpy()) for b in range(lg.shape[0]))
        assert _caches_equal(c, jc), ("decode caches", pos)
        return convert.to_torch(jl, "cpu"), c

    monkeypatch.setattr(tlm, "prefill", prefill)
    monkeypatch.setattr(tlm, "decode_step", decode)
    loop = ServeLoop(tp, tcfg, batch_slots=2, s_max=S_MAX, device="cpu")
    for i, (p, mn) in enumerate(_workload(tcfg.vocab)):
        loop.submit(Request(rid=i, prompt=p, max_new_tokens=mn))
    done = {r.rid: r.output.tolist() for r in loop.run()}
    assert next(it, None) is None                 # every call replayed
    assert done == jdone and loop.refills == jrefills >= 2
    bad, exact = F.rows_match(pairs)
    assert not bad, bad
    assert exact >= len(pairs) - 2, (exact, len(pairs))
