"""The port's quantiser gradients against the JAX reference's on the CPU
(``core/quant/quantizers.py``): the N2UQ custom VJP (G-STE ``dx``, the
per-threshold triangular ``dthr``, ``dstep``), the LSQ step gradient with
its ``1/sqrt(numel*qmax)`` scale, the straight-through rounding and
``jnp.clip``'s halved gradient at a bound, on the same numpy inputs and
cotangents.  Forward values are bit-equal; elementwise gradients are
bit-equal; gradients that sum over elements differ in f32 summation
order only and are held within ``SUM_RTOL`` of the sum of the terms'
magnitudes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant import quantizers as JQ

from repro_torch.core.quant import quantizers as TQ

import _torch_families  # noqa: F401  (one torch thread per worker)

# an f32 sum over n terms in another order: a few ulps of the magnitudes
SUM_RTOL = 1e-6


def _t(a):
    return torch.tensor(np.asarray(a))


def _close_sum(got, want, mag, what):
    """``got`` within SUM_RTOL of ``want``, relative to ``mag``, the sum of
    the summed terms' magnitudes."""
    got, want, mag = (np.asarray(v, np.float64) for v in (got, want, mag))
    err = np.abs(got - want)
    assert np.all(err <= SUM_RTOL * mag + 1e-30), (what, err.max(), mag)


def _acts(seed, shape=(6, 40)):
    """Activations spread over and past the thresholds' range, some on
    the thresholds themselves."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * 1.5 + 1.0).astype(np.float32)


@pytest.mark.parametrize("bits", [2, 3, 4])
def test_n2uq_count_vjp_matches_jax(bits):
    """``_n2uq_count``'s forward and its custom VJP (dx, dthr, dstep)."""
    n = 2**bits - 1
    rng = np.random.default_rng(bits)
    x = _acts(bits)
    thr = np.sort(rng.uniform(-0.5, 3.0, size=n)).astype(np.float32)
    x.reshape(-1)[:n] = thr                       # x exactly on T_i
    step = np.float32(0.37)
    ct = rng.normal(size=x.shape).astype(np.float32)

    jy, vjp = jax.vjp(lambda a, t, s: JQ._n2uq_count(a, t, s, bits),
                      jnp.asarray(x), jnp.asarray(thr), jnp.asarray(step))
    jdx, jdthr, jdstep = (np.asarray(g) for g in vjp(jnp.asarray(ct)))

    tx, tthr, tstep = (_t(v).requires_grad_() for v in (x, thr, step))
    ty = TQ._n2uq_count(tx, tthr, tstep, bits)
    tdx, tdthr, tdstep = torch.autograd.grad(ty, (tx, tthr, tstep),
                                             _t(ct))
    assert np.array_equal(ty.detach().numpy(), np.asarray(jy))
    assert np.array_equal(tdx.numpy(), jdx)
    assert tdthr.shape == jdthr.shape and tdstep.shape == jdstep.shape
    avg = max((thr[-1] - thr[0]) / max(n - 1, 1), 1e-6)
    _close_sum(tdthr.numpy(), jdthr, np.abs(ct).sum() * step / avg, "dthr")
    count = (x[..., None] > thr).sum(-1)
    _close_sum(tdstep.numpy(), jdstep, np.abs(ct * count).sum(), "dstep")
    assert np.abs(jdthr).max() > 0 and jdstep != 0


def test_n2uq_act_quant_grads_through_thresholds():
    """The whole activation quantiser: gradients reach the deltas through
    softplus and cumsum; codes (``dequant=False``) bit-equal."""
    bits = 3
    x = _acts(7, (4, 64))
    params = {"deltas": np.array([-2.0, -1.0, -1.5, -0.5, -2.5, -1.0, -2.0],
                                 np.float32),
              "out_step": np.float32(0.21)}
    ct = np.random.default_rng(8).normal(size=x.shape).astype(np.float32)

    def jf(a, p):
        return jnp.sum(JQ.n2uq_act_quant(a, p, bits) * ct)

    jgx, jgp = jax.grad(jf, argnums=(0, 1))(
        jnp.asarray(x), jax.tree.map(jnp.asarray, params))
    tx = _t(x).requires_grad_()
    tp = {k: _t(v).requires_grad_() for k, v in params.items()}
    tl = torch.sum(TQ.n2uq_act_quant(tx, tp, bits) * _t(ct))
    gx, gd, gs = torch.autograd.grad(tl, (tx, tp["deltas"], tp["out_step"]))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(jgx))
    _close_sum(gd.numpy(), np.asarray(jgp["deltas"]),
               np.abs(ct).sum() * 2.0, "deltas")
    _close_sum(gs.numpy(), np.asarray(jgp["out_step"]),
               np.abs(ct).sum() * 7, "out_step")
    jc = np.asarray(JQ.n2uq_act_quant(jnp.asarray(x), params, bits,
                                      dequant=False))
    tc = TQ.n2uq_act_quant(_t(x), {k: _t(v) for k, v in params.items()},
                           bits, dequant=False)
    np.testing.assert_array_equal(tc.numpy(), jc)


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("signed", [True, False])
def test_lsq_step_gradient_matches_jax(per_channel, signed):
    """LSQ fake-quant: value bit-equal; dx straight through inside the
    range (half of it on a bound, as ``jnp.clip``); the step's gradient
    scaled by ``1/sqrt(numel*qmax)``."""
    bits = 3
    rng = np.random.default_rng(int(per_channel) * 2 + int(signed))
    w = rng.normal(size=(48, 24)).astype(np.float32) * 0.3
    step = (JQ.lsq_init(jnp.asarray(w), bits, per_channel, signed=signed))
    step = np.asarray(step) * np.float32(0.8)
    ct = rng.normal(size=w.shape).astype(np.float32)

    def jf(a, s):
        return JQ.lsq_quant(a, s, bits, signed=signed)

    jy, vjp = jax.vjp(jf, jnp.asarray(w), jnp.asarray(step))
    jdw, jds = (np.asarray(g) for g in vjp(jnp.asarray(ct)))
    tw, ts = _t(w).requires_grad_(), _t(step).requires_grad_()
    ty = TQ.lsq_quant(tw, ts, bits, signed=signed)
    tdw, tds = torch.autograd.grad(ty, (tw, ts), _t(ct))
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tdw.numpy(), jdw)
    assert (jdw == 0.5 * ct).any()          # codes on a clip bound
    qmax = 2 ** (bits - 1) - 1 if signed else 2**bits - 1
    g = 1.0 / np.sqrt(w.size * qmax)
    mag = np.abs(ct).sum(axis=0 if per_channel else None) * (qmax + 1) * g
    _close_sum(tds.numpy(), jds, mag, "step")
    # the scale itself: the step's gradient is g times the unscaled one
    ts2 = _t(step).requires_grad_()
    q = TQ._clip(TQ._round_ste(_t(w) / ts2), -(qmax + 1) if signed else 0,
                 qmax) * ts2
    (raw,) = torch.autograd.grad(q, ts2, _t(ct))
    np.testing.assert_allclose(tds.numpy(), raw.numpy() * np.float32(g),
                               rtol=1e-5, atol=1e-9)


def test_uniform_and_binary_quantisers_match_jax():
    """``fake_quant_weight``/``fake_quant_act``: values and input
    gradients bit-equal; ``binary_quant``: signs bit-equal, the
    per-channel mean scale and the gradient through it within summation
    order."""
    rng = np.random.default_rng(11)
    w = rng.normal(size=(32, 16)).astype(np.float32)
    ct = rng.normal(size=w.shape).astype(np.float32)
    cfg = JQ.QuantConfig(w_bits=3, a_bits=3)
    tcfg = TQ.QuantConfig(w_bits=3, a_bits=3)
    scale = np.float32(0.45)
    for jfn, tfn in ((JQ.fake_quant_weight, TQ.fake_quant_weight),
                     (JQ.fake_quant_act, TQ.fake_quant_act)):
        jy, vjp = jax.vjp(lambda a: jfn(a, scale, cfg), jnp.asarray(w))
        (jd,) = vjp(jnp.asarray(ct))
        tw = _t(w).requires_grad_()
        ty = tfn(tw, _t(scale), tcfg)
        (td,) = torch.autograd.grad(ty, tw, _t(ct))
        np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    jy, vjp = jax.vjp(JQ.binary_quant, jnp.asarray(w))
    (jd,) = vjp(jnp.asarray(ct))
    tw = _t(w).requires_grad_()
    ty = TQ.binary_quant(tw)
    (td,) = torch.autograd.grad(ty, tw, _t(ct))
    _close_sum(ty.detach().numpy(), np.asarray(jy),
               np.abs(w).sum(0) / w.shape[0], "binary scale")
    _close_sum(td.numpy(), np.asarray(jd),
               np.abs(ct).sum(0) / w.shape[0] + np.abs(ct), "binary dw")
    np.testing.assert_array_equal(
        TQ.binary_quant(_t(w), dequant=False).numpy(),
        np.asarray(JQ.binary_quant(jnp.asarray(w), dequant=False)))
    _close_sum(TQ.n2uq_weight_init(_t(w), 3)["step"].numpy(),
               np.asarray(JQ.n2uq_weight_init(jnp.asarray(w), 3)["step"]),
               2 * np.abs(w).mean(0) / np.sqrt(3), "n2uq weight step")
