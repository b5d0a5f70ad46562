"""The port's dense-cache oracle (``serve.loop.ServeLoop``, ``lm.prefill``,
``lm.decode_step``) against the JAX package, and the reference's
paged-vs-dense contract held inside the port.

- Units: ``kv_roundtrip``, ``zero_cache``, ``_store_prefill`` and
  ``_local_decode`` equal JAX's bit for bit.
- The loop, teacher-forced against the JAX ``ServeLoop`` (more requests
  than slots, so freed slots refill mid-decode with left-padded
  prefills): every prefill and decode of the port loop gets the JAX
  loop's logits of the same call, so both walk the same tokens; the
  inputs (tokens, the shared position) and the caches after every call
  must be equal bit for bit, the logits under the vocab head's allowance
  (``_torch_families.HEAD_ULP_SHARE``), and the outputs and ``refills``
  equal.
  The MoE family (``moe-gqa``) runs the same comparison in
  ``test_torch_moe_loop.py``.
- The matrix of ``tests/test_serve_oracle.py`` less MoE, in the port: the
  paged loop's greedy outputs equal each request run solo through the
  dense loop, with the prefix cache on and off, on fp and int8 pools
  (the dense loop round-trips its f32 cache at equal quantisation).  The
  paged loop reads with ``'lax'``, the gathered reader that the
  reference's ``'auto'`` resolves to on a CPU cache miss.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.kernels import paged as jpaged
from repro.models import lm as jlm
from repro.serve import loop as jloop_mod
from repro.serve.loop import Request as JRequest
from repro.serve.loop import ServeLoop as JServeLoop

from repro_torch import convert
from repro_torch.kernels import paged as tpaged
from repro_torch.models import lm as tlm
from repro_torch.serve.loop import Request, ServeLoop
from repro_torch.serve.paged import PagedServeLoop

import _torch_families as F

LENGTHS = (6, 11, 3, 9, 5)          # tests/test_serve_oracle.py's workload
MAX_NEW = (4, 6, 3, 5, 4)
S_MAX = 48


def _workload(vocab):
    rng = np.random.default_rng(7)
    return [(rng.integers(0, vocab, n).astype(np.int32), mn)
            for n, mn in zip(LENGTHS, MAX_NEW)]


def _bits(t):
    t = torch.as_tensor(t) if not isinstance(t, torch.Tensor) else t
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _caches_equal(tc, jc):
    jt = convert.dense_caches_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    for seg, jseg in zip(tc, jt):
        for b, pool in seg.items():
            for name, leaf in pool.items():
                want = jseg[b][name]
                assert leaf.dtype == want.dtype and leaf.shape == want.shape
                if not torch.equal(_bits(leaf), _bits(want)):
                    return False
    return True


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_kv_roundtrip_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((2, 7, 3, 16)) * 3, jnp.bfloat16)
    x = x.at[0, 0, 0].set(0)                     # an all-zero vector: scale 1
    want = np.asarray(jpaged.kv_roundtrip(x, jpaged.KVQuantSpec(dtype)))
    got = tpaged.kv_roundtrip(convert.to_torch(np.asarray(x), "cpu"),
                              tpaged.KVQuantSpec(dtype))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["attn", "attn_local"])
@pytest.mark.parametrize("kv", ["fp", "int8"])
@pytest.mark.parametrize("S,S_max", [(5, 12), (11, 40), (30, 40)])
def test_zero_cache_and_store_prefill_match_jax(kind, kv, S, S_max):
    """``attn_local`` keeps a ring of ``min(local_window, S_max)`` = 24 or
    12: a prefill shorter than it leaves zeros behind, a longer one keeps
    its last keys."""
    jcfg, tcfg = F.cfgs("window-local", kv=kv)
    jz = jlm.zero_cache(kind, jcfg, 2, S_max)
    tz = tlm.zero_cache(kind, tcfg, 2, S_max, device="cpu")
    for name in ("k", "v"):
        assert tz[name].shape == jz[name].shape
        assert str(tz[name].dtype).replace("torch.", "") == str(
            jz[name].dtype)
    rng = np.random.default_rng(S)
    dt = jnp.float32 if kv != "fp" else jnp.bfloat16
    k, v = (jnp.asarray(rng.standard_normal((2, S, 4, 16)), dt)
            for _ in range(2))
    want = jlm._store_prefill(kind, jcfg, jz, (k, v))
    tlm._store_prefill(kind, tz, (convert.to_torch(np.asarray(k), "cpu"),
                                  convert.to_torch(np.asarray(v), "cpu")))
    for name in ("k", "v"):
        w = convert.to_torch(np.asarray(want[name]), "cpu")
        assert torch.equal(_bits(tz[name]), _bits(w)), name


@pytest.mark.parametrize("kv", ["fp", "int8"])
@pytest.mark.parametrize("pos", [3, 30])
def test_local_decode_matches_jax(kv, pos):
    """One ring-buffer step of layer 0 at ``pos`` (before and after the
    ring of 24 wraps): output and cache bit-equal to JAX's jitted step."""
    jcfg, tcfg, params, tp = F.model("window-local", kv=kv)
    rng = np.random.default_rng(pos)
    dt = np.float32
    cache = {n: (rng.standard_normal((2, 24, 4, 16)) * 0.5).astype(dt)
             for n in ("k", "v")}
    jcache = {n: jnp.asarray(c, jnp.float32 if kv != "fp" else jnp.bfloat16)
              for n, c in cache.items()}
    h = jnp.asarray(rng.standard_normal((2, 1, jcfg.d_model)), jnp.bfloat16)
    jp = jax.tree.map(lambda a: a[0], params["segments"][0]["b0"]["attn"])
    apply_fn = jlm._apply_fn_for("serve")
    jy, (jk, jv) = jax.jit(lambda p, h, c: jlm._local_decode(
        p, h, jcfg, c, jnp.int32(pos), jnp.int32(pos % 24), apply_fn))(
            jp, h, jcache)
    tcache = {n: convert.to_torch(np.asarray(c), "cpu")
              for n, c in jcache.items()}
    ty = tlm._local_decode(tp.layers(0)[0]["b0"]["attn"],
                           convert.to_torch(np.asarray(h), "cpu"), tcfg,
                           tcache, pos, tlm.nn.serve_linear_apply)
    assert np.array_equal(ty.float().numpy(), F.to_np(jy))
    for name, want in (("k", jk), ("v", jv)):
        assert torch.equal(_bits(tcache[name]), _bits(
            convert.to_torch(np.asarray(want), "cpu"))), name


def test_prefill_uses_the_blocked_attention_past_its_threshold(monkeypatch):
    """``sdpa`` switches to the blocked ``_flash`` at ``Sq * Sk >=
    FLASH_THRESHOLD``, as the reference's: with the threshold and blocks
    shrunk on both sides, a windowed prefill equals JAX's."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn

    for mod in (jattn, tattn):
        monkeypatch.setattr(mod, "FLASH_THRESHOLD", 64)
        monkeypatch.setattr(mod, "FLASH_QB", 4)
        monkeypatch.setattr(mod, "FLASH_KB", 8)
    calls = []
    flash = tattn._flash
    monkeypatch.setattr(tattn, "_flash",
                        lambda *a: calls.append(1) or flash(*a))
    jcfg, tcfg, params, tp = F.model("window-local", local_window=8)
    toks = np.random.default_rng(4).integers(0, jcfg.vocab, (2, 19)).astype(
        np.int32)
    jl, jc = jlm.prefill(params, {"tokens": jnp.asarray(toks)}, jcfg,
                         S_max=24)
    tl, tc = tlm.prefill(tp, torch.from_numpy(toks), tcfg, S_max=24)
    assert calls
    bad, _ = F.rows_match([(str(b), F.to_np(jl[b]), tl[b].float().numpy())
                           for b in range(2)])
    assert not bad
    assert _caches_equal(tc, jc)


# ---------------------------------------------------------------------------
# the loop, teacher-forced against JAX's
# ---------------------------------------------------------------------------


def _run_jax_loop(jcfg, params, monkeypatch):
    """The JAX dense loop over the workload, recording every call:
    ``('prefill', tokens, logits, caches)`` and ``('decode', tokens, pos,
    logits, caches)`` (numpy copies)."""
    log = []
    real_prefill = jlm.prefill

    def prefill(p, batch, cfg, S_max=None):
        lg, c = real_prefill(p, batch, cfg, S_max=S_max)
        log.append(("prefill", np.array(batch["tokens"]), np.array(lg),
                    jax.tree.map(np.array, c)))
        return lg, c

    monkeypatch.setattr(jloop_mod.lm, "prefill", prefill)
    loop = JServeLoop(params, jcfg, batch_slots=2, s_max=S_MAX)
    real_decode = loop._decode

    def decode(p, c, t, pos):
        lg, c2 = real_decode(p, c, t, pos)
        log.append(("decode", np.array(t), int(pos), np.array(lg),
                    jax.tree.map(np.array, c2)))
        return lg, c2

    loop._decode = decode
    for i, (p, mn) in enumerate(_workload(jcfg.vocab)):
        loop.submit(JRequest(rid=i, prompt=p, max_new_tokens=mn))
    done = {r.rid: r.output.tolist() for r in loop.run()}
    monkeypatch.undo()
    return log, done, loop.refills


# the recurrent families' loop: every JAX row whose top-2 margin clears
# RECURRENT_MARGIN x its max |logit| must have the port's argmax; layer 0's
# first block state within RECURRENT_STATE_TOL x its max |leaf| of JAX's
# (deeper states drift once a float ulp moves a 3-bit activation code)
RECURRENT_MARGIN = 3e-2
RECURRENT_STATE_TOL = 1e-4


def _first_state_close(tc, jc):
    jt = convert.dense_caches_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    for name, leaf in tc[0]["b0"].items():
        want = jt[0]["b0"][name]
        assert leaf.dtype == want.dtype and leaf.shape == want.shape, name
        d = (leaf[0].double() - want[0].double()).abs().max().item()
        scale = max(want[0].abs().max().item(), 1.0)
        if not d <= RECURRENT_STATE_TOL * scale:
            return False
    return all(bool(torch.isfinite(leaf).all()) for seg in tc
               for pool in seg.values() for leaf in pool.values())


@pytest.mark.parametrize("family,kv", [("codeqwen-gqa", "fp"),
                                       ("window-local", "int8"),
                                       ("minicpm-gqa", "fp"),
                                       ("command-r-gqa-r4", "int8"),
                                       ("xlstm", "fp"),
                                       ("recurrentgemma", "fp")])
def test_dense_loop_teacher_forced_vs_jax(family, kv, monkeypatch):
    """The recurrent families (xLSTM, RG-LRU with a local window) are held
    within tolerances: XLA's f32 exp, tanh and sigmoid are not torch's."""
    jcfg, tcfg, params, tp = F.model(family, kv=kv)
    log, jdone, jrefills = _run_jax_loop(jcfg, params, monkeypatch)
    it = iter(log)
    pairs = []
    real_prefill, real_decode = tlm.prefill, tlm.decode_step
    recurrent = family in F.RECURRENT_FAMILIES
    caches_match = _first_state_close if recurrent else _caches_equal

    def prefill(p, tokens, cfg, S_max=None):
        kind, jt, jl, jc = next(it)
        assert kind == "prefill" and np.array_equal(tokens.numpy(), jt)
        lg, c = real_prefill(p, tokens, cfg, S_max=S_max)
        pairs.extend((f"prefill {b}", F.to_np(jl[b]), lg[b].float().numpy())
                     for b in range(lg.shape[0]))
        assert caches_match(c, jc), "prefill caches"
        return convert.to_torch(jl, "cpu"), c

    def decode(p, c, tokens, pos, cfg):
        kind, jt, jpos, jl, jc = next(it)
        assert kind == "decode" and pos == jpos
        assert np.array_equal(tokens.numpy(), jt)
        lg, c = real_decode(p, c, tokens, pos, cfg)
        pairs.extend((f"decode {pos}.{b}", F.to_np(jl[b]),
                      lg[b].float().numpy()) for b in range(lg.shape[0]))
        assert caches_match(c, jc), ("decode caches", pos)
        return convert.to_torch(jl, "cpu"), c

    monkeypatch.setattr(tlm, "prefill", prefill)
    monkeypatch.setattr(tlm, "decode_step", decode)
    loop = ServeLoop(tp, tcfg, batch_slots=2, s_max=S_MAX, device="cpu")
    for i, (p, mn) in enumerate(_workload(tcfg.vocab)):
        loop.submit(Request(rid=i, prompt=p, max_new_tokens=mn))
    done = {r.rid: r.output.tolist() for r in loop.run()}
    assert next(it, None) is None                 # every call replayed
    assert done == jdone and loop.refills == jrefills >= 2
    if recurrent:
        clear = 0
        for name, want, got in pairs:
            top2 = np.sort(want)[-2:]
            if top2[1] - top2[0] > RECURRENT_MARGIN * np.abs(want).max():
                clear += 1
                assert got.argmax() == want.argmax(), name
        assert clear >= len(pairs) // 2, (clear, len(pairs))
        return
    bad, exact = F.rows_match(pairs)
    assert not bad, bad
    assert exact >= len(pairs) - 2, (exact, len(pairs))


def test_dense_loop_refuses_a_device_it_was_not_given():
    _, tcfg, _, tp = F.model("codeqwen-gqa")
    with pytest.raises(ValueError, match="params live on"):
        ServeLoop(tp, tcfg, device="cuda")


# ---------------------------------------------------------------------------
# paged == dense, inside the port
# ---------------------------------------------------------------------------

_oracle: dict = {}


def _solo(family, kv):
    """Each request run solo through one ``batch_slots=1`` dense loop."""
    key = (family, kv)
    if key not in _oracle:
        _, tcfg, _, tp = F.model(family, kv=kv)
        solo = ServeLoop(tp, tcfg, batch_slots=1, s_max=S_MAX, device="cpu")
        for i, (p, mn) in enumerate(_workload(tcfg.vocab)):
            solo.submit(Request(rid=i, prompt=p, max_new_tokens=mn))
            solo.run()
        _oracle[key] = {r.rid: r.output.tolist() for r in solo.done}
    return _oracle[key]


@pytest.mark.parametrize("kv", ["fp", "int8"])
@pytest.mark.parametrize("prefix_cache", [True, False],
                         ids=["cache", "nocache"])
@pytest.mark.parametrize("family", sorted(F.FAMILIES))
def test_paged_greedy_equals_dense_oracle(family, prefix_cache, kv):
    _, tcfg, _, tp = F.model(family, kv=kv)
    want = _solo(family, kv)
    loop = PagedServeLoop(tp, tcfg, batch_slots=2, s_max=S_MAX, page_size=8,
                          chunk=8, attn_impl="lax", prefix_cache=prefix_cache,
                          device="cpu")
    for i, (p, mn) in enumerate(_workload(tcfg.vocab)):
        loop.submit(Request(rid=i, prompt=p.copy(), max_new_tokens=mn))
    done = {r.rid: r.output.tolist() for r in loop.run()}
    assert loop.refills >= 3
    assert done == want, (family, prefix_cache, kv)
    loop.check_compiled()
    loop.pages.check()
    if prefix_cache:
        loop.prefix.check()
