"""The enc-dec family of the port (seamless-m4t-medium's smoke: a 2-layer
encoder, 2 ``dec_cross`` decoder layers, gelu FFNs, a frames frontend)
against the JAX package, on params converted from JAX's
``lm.init_lm(PRNGKey(0), cfg, purpose='serve')``.

- ``nn.gelu`` equals ``jax.jit(jax.nn.gelu)`` on every finite bf16
  value, and the gelu FFN equals the reference's compiled one (XLA fuses
  the gelu's last product into ``wo``'s quantiser, unrounded): bit for
  bit, at calibrated lookup steps, where a wrong rounding moves codes.
- The frontend's train-path linear (``nn.linear_apply``: N2UQ and LSQ
  fake-quant, or plain bf16), cross-attention (``gqa_train`` and
  ``gqa_decode`` with ``cross_kv``), ``encode``, and ``prefill(tokens,
  frames=...)`` followed by decode steps: outputs, logits and every cache
  leaf bit-equal to JAX's (no recurrent state here, and the rotary and
  gelu copy XLA's roundings).
- Both packages refuse an enc-dec prefill without frames, and neither
  dense loop serves one.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.models import nn as jnn
from repro.serve.loop import ServeLoop as JServeLoop

from repro_torch import convert
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.models import nn as tnn
from repro_torch.serve.loop import ServeLoop

import _torch_families as F

SE = 12          # encoder frames


def _t(a):
    return convert.to_torch(np.asarray(a), "cpu")


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _equal(got, want):
    want = _t(want)
    return (got.dtype == want.dtype and got.shape == want.shape
            and torch.equal(_bits(got), _bits(want)))


def _frames(B=2, seed=2):
    return np.random.default_rng(seed).standard_normal(
        (B, SE, 1024)).astype(np.float32)


def test_gelu_bit_equal_to_jitted_jax_on_every_finite_bf16():
    bits = np.arange(1 << 16, dtype=np.uint16)
    x = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    x = x[torch.isfinite(x)]
    xj = jnp.asarray(x.view(torch.int16).numpy().view(np.uint16)).view(
        jnp.bfloat16)
    want = np.asarray(jax.jit(jax.nn.gelu)(xj)).view(np.uint16)
    got = tnn.gelu(x).view(torch.int16).numpy().view(np.uint16)
    assert got.shape == want.shape
    assert np.array_equal(got, want), int((got != want).sum())
    assert tnn.act_fn("gelu") is tnn.gelu


@pytest.mark.parametrize("steps", ["init", "calibrated"])
@pytest.mark.parametrize("layout", ["tlmac", "int8"])
def test_gelu_ffn_matches_compiled_reference(layout, steps):
    jcfg, tcfg, params, tp = F.model("seamless", layout, steps=steps)
    jffn = jax.tree.map(lambda a: a[0], params["segments"][0]["b0"]["ffn"])
    x = jnp.asarray(np.random.default_rng(1).standard_normal(
        (2, 7, jcfg.d_model)), jnp.bfloat16)
    want = jax.jit(lambda p, x: jlm.ffn_apply(
        p, x, jcfg, jnn.serve_linear_apply))(jffn, x)
    got = tlm.ffn_apply(tp.layers(0)[0]["b0"]["ffn"], _t(x), tcfg,
                        tnn.serve_linear_apply)
    assert _equal(got, want)


@pytest.mark.parametrize("qdq", [True, False], ids=["qdq", "dense"])
def test_linear_apply_matches_jax(qdq):
    """The qdq product (the serve path's: ``front`` carries ``aq``) is
    bit-equal; the plain bf16 product of unquantised operands sums K 1024
    f32 products in XLA's order against torch's, so a result may round to
    the neighbouring bf16 value (``rows_match``: a bf16 ulp in at most
    ``HEAD_ULP_SHARE`` of a row, at least one, as the vocab head)."""
    jcfg, tcfg, params, tp = F.model("seamless")
    front = params["front"]
    tfront = tp.front.tree()
    if not qdq:
        front = {"w": front["w"]}
        tfront = {"w": tfront["w"]}
    fr = _frames()
    want = jnn.linear_apply(front, jnp.asarray(fr), jcfg)
    got = tnn.linear_apply(tfront, torch.from_numpy(fr), tcfg)
    if qdq:
        assert _equal(got, want)
    else:
        assert got.dtype == torch.bfloat16
        rows = [(str(i), w, g) for i, (w, g) in enumerate(zip(
            F.to_np(want).reshape(-1, tcfg.d_model),
            got.float().numpy().reshape(-1, tcfg.d_model)))]
        bad, _ = F.rows_match(rows)
        assert not bad, bad


def _cross_inputs(seed):
    jcfg, tcfg, params, tp = F.model("seamless", steps="calibrated")
    jx = jax.tree.map(lambda a: a[0], params["segments"][0]["b0"]["xattn"])
    tx = tp.layers(0)[0]["b0"]["xattn"]
    rng = np.random.default_rng(seed)
    enc = jnp.asarray(rng.standard_normal((2, SE, jcfg.d_model)),
                      jnp.bfloat16)
    return jcfg, tcfg, jx, tx, enc, rng


def test_cross_attention_train_matches_jax():
    jcfg, tcfg, jx, tx, enc, rng = _cross_inputs(3)
    h = jnp.asarray(rng.standard_normal((2, 9, jcfg.d_model)), jnp.bfloat16)

    def ref(p, h, enc):
        kv = jlm._cross_kv(p, enc, jcfg, jnn.serve_linear_apply)
        return jattn.gqa_train(p, h, jcfg, apply_fn=jnn.serve_linear_apply,
                               cross_kv=kv), kv

    (jy, _), (jk, jv) = jax.jit(ref)(jx, h, enc)
    tk, tv = tlm._cross_kv(tx, _t(enc), tcfg, tnn.serve_linear_apply)
    ty, _ = tattn.gqa_train(tx, _t(h), tcfg, cross_kv=(tk, tv))
    assert _equal(tk, jk) and _equal(tv, jv)
    assert _equal(ty, jy)


def test_cross_attention_decode_matches_jax():
    """Every encoder position visible, no rotary, nothing written."""
    jcfg, tcfg, jx, tx, enc, rng = _cross_inputs(4)
    h = jnp.asarray(rng.standard_normal((2, 1, jcfg.d_model)), jnp.bfloat16)
    xk, xv = (jnp.asarray(rng.standard_normal((2, SE, jcfg.n_kv,
                                               jcfg.kv_head_dim)),
                          jnp.bfloat16) for _ in range(2))
    jy, jc = jax.jit(lambda p, h, k, v: jattn.gqa_decode(
        p, h, jcfg, None, jnp.int32(5), apply_fn=jnn.serve_linear_apply,
        cross_kv=(k, v)))(jx, h, xk, xv)
    assert jc is None
    ty, tc = tattn.gqa_decode(tx, _t(h), tcfg, None, 5,
                              cross_kv=(_t(xk), _t(xv)))
    assert tc is None and _equal(ty, jy)


@pytest.mark.parametrize("steps", ["init", "calibrated"])
def test_encode_matches_jax(steps):
    jcfg, tcfg, params, tp = F.model("seamless", steps=steps)
    fr = _frames(seed=5)
    want = jlm.encode(params, jnp.asarray(fr), jcfg, purpose="serve")
    assert _equal(tlm.encode(tp, torch.from_numpy(fr), tcfg), want)


@pytest.mark.parametrize("steps", ["init", "calibrated"])
def test_prefill_frames_then_decode_matches_jax(steps):
    """``prefill(tokens, frames=...)`` (S 9, s_max 16), then three jitted
    decode steps: logits, and every cache leaf (self K/V, the encoder's
    bf16 ``xk``/``xv``) after every call, bit-equal to JAX's."""
    jcfg, tcfg, params, tp = F.model("seamless", steps=steps)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, jcfg.vocab, (2, 9)).astype(np.int32)
    fr = _frames(seed=6)
    jl, jc = jlm.prefill(params, {"tokens": jnp.asarray(toks),
                                  "frames": jnp.asarray(fr)}, jcfg, S_max=16)
    tl, tc = tlm.prefill(tp, torch.from_numpy(toks), tcfg, S_max=16,
                         frames=torch.from_numpy(fr))
    assert _equal(tl, jl)
    dec = jax.jit(lambda p, c, t, pos: jlm.decode_step(p, c, t, pos, jcfg))

    def caches_equal():
        jt = convert.dense_caches_from_jax(jax.tree.map(np.asarray, jc),
                                           "cpu")
        assert set(tc[0]["b0"]) == {"k", "v", "xk", "xv"}
        return all(torch.equal(_bits(leaf), _bits(jt[0]["b0"][n]))
                   for n, leaf in tc[0]["b0"].items())

    assert caches_equal()
    for pos in (9, 10, 11):
        cur = np.asarray(jnp.argmax(jl, -1), np.int32)[:, None]
        jl, jc = dec(params, jc, jnp.asarray(cur), jnp.int32(pos))
        tl, tc = tlm.decode_step(tp, tc, torch.from_numpy(cur), pos, tcfg)
        assert _equal(tl, jl), pos
        assert caches_equal(), pos


def test_encdec_needs_frames_and_no_dense_loop_serves_it():
    jcfg, tcfg, params, tp = F.model("seamless")
    toks = np.zeros((1, 4), np.int32)
    with pytest.raises(KeyError, match="frames"):
        jlm.prefill(params, {"tokens": jnp.asarray(toks)}, jcfg)
    with pytest.raises(KeyError, match="frames"):
        tlm.prefill(tp, torch.from_numpy(toks), tcfg)
    with pytest.raises(ValueError, match="encoder-decoder"):
        ServeLoop(tp, tcfg, device="cpu")
    # the reference's loop takes the config and fails at its first prefill
    from repro.serve.loop import Request as JRequest

    loop = JServeLoop(params, jcfg)
    loop.submit(JRequest(rid=0, prompt=np.arange(4, dtype=np.int32)))
    with pytest.raises(KeyError, match="frames"):
        loop.run()


def test_caches_and_paging_match_reference():
    """``zero_cache`` of ``dec_cross`` (self K/V of s_max, cross K/V of
    the encoder length, bf16 whatever the KV dtype) equals JAX's, and no
    new family pages, in either package."""
    for kv in ("fp", "int8"):
        jcfg, tcfg = F.cfgs("seamless", kv=kv)
        want = jlm.zero_cache("dec_cross", jcfg, 2, 16, enc_len=SE)
        got = tlm.zero_cache("dec_cross", tcfg, 2, 16, device="cpu",
                             enc_len=SE)
        assert set(got) == set(want)
        for n, leaf in want.items():
            assert _equal(got[n], leaf), (kv, n)
    for fam in ("seamless", "xlstm", "recurrentgemma"):
        jcfg, tcfg = F.cfgs(fam)
        assert not tlm.supports_paged(tcfg) and not jlm.supports_paged(jcfg)
        assert [(s.pattern, s.n) for s in tlm.segments_for(tcfg)] == [
            (s.pattern, s.n) for s in jlm.segments_for(jcfg)]
        with pytest.raises(ValueError, match="paged"):
            tlm.init_caches(tcfg, F.tpaged_spec(), device="cpu")
