"""Port ``PagedServeLoop`` vs the JAX ``PagedServeLoop`` (prefix cache,
on-demand paging and speculation off; lax attention) on the workload of
``tests/test_serve_oracle.py``, plus ``PageManager`` units and the
package-hygiene check.

The loop comparison is teacher-forced: every forward of the port loop
records its own logits and hands the loop the JAX loop's logits of the
same step, so both loops walk the same token sequence and admit, page
and finish identically.  Block tables, positions and input tokens must
then be equal at every step, and each step's logits equal within
``LOGIT_TOL``.  Greedy tokens are compared only where JAX's top-2 margin
clears the tolerance: random-init smoke models have near-tied argmaxes.
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


def _workload(vocab):
    rng = np.random.default_rng(7)
    return [(rng.integers(0, vocab, n).astype(np.int32), mn)
            for n, mn in zip(LENGTHS, MAX_NEW)]


_cache = {}


def _jax_run(arch, kv_dtype):
    key = (arch, kv_dtype)
    if key in _cache:
        return _cache[key]
    cfg = jsmoke(arch)
    params, _ = jlm.init_lm(jax.random.PRNGKey(0), cfg, purpose="serve")
    loop = JLoop(params, cfg, batch_slots=2, s_max=S_MAX, page_size=8,
                 chunk=8, prefix_cache=False, on_demand=False, spec_k=0,
                 attn_impl="lax", kv_dtype=kv_dtype)
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
    for i, (p, mn) in enumerate(_workload(cfg.vocab)):
        loop.submit(JRequest(rid=i, prompt=p.copy(), max_new_tokens=mn))
    done = {r.rid: r.output for r in loop.run()}
    _cache[key] = (cfg, params, log, done, loop.refills)
    return _cache[key]


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "mistral-large-123b"])
def test_loop_teacher_forced_vs_jax(arch, kv_dtype):
    jcfg, params, jlog, jdone, jrefills = _jax_run(arch, kv_dtype)
    tcfg = dataclasses.replace(tsmoke(arch), serve_kv_dtype=kv_dtype)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, params),
                                 device="cpu")
    loop = PagedServeLoop(tp, tcfg, batch_slots=2, s_max=S_MAX, page_size=8,
                          chunk=8, device="cpu")
    it = iter(jlog)
    got_logits, margins_ok = [], 0

    def forced(kind, fn):
        def wrapper(*a):
            jkind, jargs, jlogits = next(it)
            assert kind == jkind
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

    loop._prefill_chunk = forced("_prefill_chunk", loop._prefill_chunk)
    loop._decode = forced("_decode", loop._decode)
    for i, (p, mn) in enumerate(_workload(tcfg.vocab)):
        loop.submit(Request(rid=i, prompt=p.copy(), max_new_tokens=mn))
    done = {r.rid: r.output for r in loop.run()}
    assert next(it, None) is None                   # same number of forwards
    assert loop.refills == jrefills >= 3
    assert {k: v.tolist() for k, v in done.items()} == \
        {k: v.tolist() for k, v in jdone.items()}   # forced: JAX's tokens
    loop.pages.check()
    assert loop.pages.in_use == 0
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
    assert loop.pages.in_use == 0 and not loop.block_table.any()


def test_submit_rejects_requests_that_can_never_run():
    cfg = tsmoke("codeqwen1.5-7b")
    from repro_torch.models import lm

    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    loop = PagedServeLoop(params, cfg, batch_slots=1, s_max=16, page_size=8,
                          chunk=8, n_pages=2, device="cpu")
    with pytest.raises(AdmissionError):
        loop.submit(Request(rid=0, prompt=np.zeros(0, np.int32)))
    with pytest.raises(AdmissionError):
        loop.submit(Request(rid=1, prompt=np.zeros(17, np.int32)))
    with pytest.raises(AdmissionError, match="never fit"):
        loop.submit(Request(rid=2, prompt=np.zeros(6, np.int32),
                            max_new_tokens=8))
    with pytest.raises(ValueError, match="params live on"):
        PagedServeLoop(params, cfg, device="meta")


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
