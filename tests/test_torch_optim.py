"""The port's optimizer substrate against the JAX reference's on the CPU
(``optim/`` and ``train/compress.py``), on the same numpy inputs:
AdamW at f32, bf16 and int8 state, the 8-bit block codec, global-norm
clipping, the cosine and WSD schedules, and int8 stochastic-rounding
gradient compression fed the reference's uniforms; and the port's own
properties (AdamW converging, stochastic rounding unbiased)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as JA
from repro.optim import lowbit as JL
from repro.optim import schedules as JS
from repro.train import compress as JC

from repro_torch.optim import adamw as TA
from repro_torch.optim import lowbit as TL
from repro_torch.optim import schedules as TS
from repro_torch.train import compress as TC

import _torch_families  # noqa: F401  (one torch thread per worker)

# f32 elementwise chains in another order of roundings (XLA contracts
# multiply-adds into FMAs on the CPU, its pow is not torch's): a few ulps
F32_RTOL = 2e-6


def _t(a):
    return torch.tensor(np.asarray(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _params(seed):
    """Matrices (decayed), a vector (not), leaves whose last dim is and
    is not a multiple of 256 (int8 state codes the first kind only), in
    nested dicts and a list."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return {"w": f(4, 512), "b": f(7), "blocks": [{"k": f(3, 2, 256)},
                                                  {"k": f(3, 2, 256)}],
            "s": f(12, 10)}


def _grads(seed):
    return jax.tree.map(lambda a: a * np.float32(0.3), _params(seed))


def _state_np(tree):
    """A state tree to numpy, bf16 leaves as f32 values."""
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        if np.asarray(a).dtype.name == "bfloat16"
                        else np.asarray(a), tree)


def _port_state_np(tree):
    return TA.tree_map(lambda t: t.float().numpy() if t.dtype ==
                       torch.bfloat16 else t.numpy(), tree)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_adamw_update_matches_jax(dtype):
    """Three AdamW steps: params and moments within F32_RTOL (int8 codes
    within one level, their scales within F32_RTOL), the step equal."""
    cfg_j = JA.AdamWConfig(state_dtype=dtype)
    cfg_t = TA.AdamWConfig(state_dtype=dtype)
    pj = jax.tree.map(jnp.asarray, _params(0))
    sj = JA.adamw_init(pj, cfg_j)
    pt = jax.tree.map(_t, _params(0))
    st = TA.adamw_init(pt, cfg_t)
    for i in range(3):
        g = _grads(i + 1)
        lr = np.float32(1e-2 * (i + 1))
        pj, sj = JA.adamw_update(pj, jax.tree.map(jnp.asarray, g), sj, lr,
                                 cfg_j)
        TA.adamw_update(pt, jax.tree.map(_t, g), st, _t(lr), cfg_t)
    for a, b in zip(jax.tree.leaves(_np(pj)), TA.tree_leaves(pt)):
        np.testing.assert_allclose(b.numpy(), a, rtol=F32_RTOL,
                                   atol=F32_RTOL * np.abs(a).max())
    assert int(st["step"]) == int(sj["step"]) == 3
    js, ts = _state_np({"m": sj["m"], "v": sj["v"]}), _port_state_np(
        {"m": st["m"], "v": st["v"]})
    for path, a in jax.tree_util.tree_flatten_with_path(js)[0]:
        b = ts
        for k in path:
            b = b[getattr(k, "key", getattr(k, "idx", None))]
        if a.dtype == np.int8:
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, path
        else:
            tol = 1e-2 if dtype == "bf16" else F32_RTOL   # bf16: an ulp
            np.testing.assert_allclose(b, a, rtol=tol,
                                       atol=tol * np.abs(a).max())


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_adamw_state_dtypes_track_in_port(dtype):
    """The reference's convergence check, in the port: 20 steps on a
    quadratic reduce it at every state dtype."""
    pt = {"w": _t(_params(1)["w"]), "b": _t(np.zeros(8, np.float32))}
    cfg = TA.AdamWConfig(state_dtype=dtype, weight_decay=0.0)
    st = TA.adamw_init(pt, cfg)
    loss = lambda p: float((p["w"] ** 2).sum() + (p["b"] ** 2).sum())
    l0 = loss(pt)
    for _ in range(20):
        g = {"w": 2 * pt["w"], "b": 2 * pt["b"]}
        TA.adamw_update(pt, g, st, 0.05, cfg)
    assert loss(pt) < 0.9 * l0
    if dtype == "int8":
        assert st["m"]["w"]["q"].dtype == torch.int8
        assert st["m"]["b"].dtype == torch.float32     # 8 % 256 != 0


def test_q8_codec_bit_equal():
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(3, 5, 512)) * 3).astype(np.float32)
    x[0, 0, :256] = 0.0                   # an all-zero block: scale 1e-12
    je = JL.q8_encode(jnp.asarray(x))
    te = TL.q8_encode(_t(x))
    np.testing.assert_array_equal(te["q"].numpy(), np.asarray(je["q"]))
    np.testing.assert_array_equal(te["scale"].numpy(),
                                  np.asarray(je["scale"]))
    np.testing.assert_array_equal(
        TL.q8_decode(te, x.shape).numpy(),
        np.asarray(JL.q8_decode(je, x.shape)))
    assert te["q"].shape == (3, 5, 2, 256)
    assert not TL.q8_compatible(_t(np.ones(7))) and \
        not TL.q8_compatible(_t(np.ones((4, 100))))
    with pytest.raises(ValueError):
        TL.q8_encode(_t(np.ones((4, 100), np.float32)))


@pytest.mark.parametrize("scale", [10.0, 1e-3])
def test_clip_by_global_norm_matches_jax(scale):
    g = jax.tree.map(lambda a: a * np.float32(scale), _grads(4))
    gj, nj = JA.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    gt, nt = TA.clip_by_global_norm(jax.tree.map(_t, g), 1.0)
    np.testing.assert_allclose(float(nt), float(nj), rtol=F32_RTOL)
    for a, b in zip(jax.tree.leaves(_np(gj)), TA.tree_leaves(gt)):
        np.testing.assert_allclose(b.numpy(), a, rtol=F32_RTOL,
                                   atol=F32_RTOL * np.abs(a).max())


@pytest.mark.parametrize("total,warmup", [(100, 10), (6, 0), (12, 2)])
def test_schedules_match_jax(total, warmup):
    """Cosine, WSD and linear warmup at every step 0..total, from an int32
    step as the reference's trainer passes it."""
    for s in range(total + 1):
        js = jnp.int32(s)
        pairs = [
            (JS.cosine_schedule(js, 3e-4, total, warmup),
             TS.cosine_schedule(s, 3e-4, total, warmup)),
            (JS.wsd_schedule(js, 3e-4, total, warmup),
             TS.wsd_schedule(s, 3e-4, total, warmup)),
            (JS.linear_warmup(js, 3e-4, warmup),
             TS.linear_warmup(s, 3e-4, warmup)),
        ]
        for want, got in pairs:
            assert got.dtype == torch.float32 and got.dim() == 0
            np.testing.assert_allclose(float(got), float(want),
                                       rtol=F32_RTOL, atol=0)


def test_q8_sr_and_compress_on_jax_uniforms():
    """``q8_sr`` and ``compress_grads`` (error feedback over two calls)
    fed the reference's ``jax.random.uniform`` draws: bit-equal."""
    g = _grads(5)
    key = jax.random.PRNGKey(9)
    leaves = jax.tree.leaves(g)
    keys = jax.random.split(key, len(leaves))
    us = [_t(jax.random.uniform(k, (-(-a.size // JC.BLOCK), JC.BLOCK)))
          for k, a in zip(keys, leaves)]
    np.testing.assert_array_equal(
        TC.q8_sr(_t(leaves[0]), u=us[0]).numpy(),
        np.asarray(JC.q8_sr(jnp.asarray(leaves[0]), keys[0])))
    cj, ej = JC.compress_grads(jax.tree.map(jnp.asarray, g), key)
    ct, et = TC.compress_grads(jax.tree.map(_t, g), uniforms=us)
    for a, b in zip(jax.tree.leaves(_np(cj)) + jax.tree.leaves(_np(ej)),
                    TA.tree_leaves(ct) + TA.tree_leaves(et)):
        np.testing.assert_array_equal(b.numpy(), a)
    key2 = jax.random.PRNGKey(10)
    us2 = [_t(jax.random.uniform(k, u.shape))
           for k, u in zip(jax.random.split(key2, len(leaves)), us)]
    cj2, _ = JC.compress_grads(jax.tree.map(jnp.asarray, g), key2, ej)
    ct2, _ = TC.compress_grads(jax.tree.map(_t, g), error_state=et,
                               uniforms=us2)
    for a, b in zip(jax.tree.leaves(_np(cj2)), TA.tree_leaves(ct2)):
        np.testing.assert_array_equal(b.numpy(), a)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_q8_sr_unbiased_in_port(seed):
    """E[q8_sr(x)] = x over 256 generator draws (the reference's bound),
    and the residual of ``compress_grads`` is exactly ``g - q``."""
    x = _t(np.random.default_rng(seed).normal(size=(64,)).astype(
        np.float32))
    gen = torch.Generator().manual_seed(seed)
    mean = torch.stack([TC.q8_sr(x, gen) for _ in range(256)]).mean(0)
    scale = float(x.abs().max()) / 127
    assert float((mean - x).abs().max()) < 4 * scale / np.sqrt(256) * 3 + 1e-5
    g = {"w": _t(np.array([1e-4, 5e-1, -3e-3], np.float32))}
    cg, err = TC.compress_grads(g, torch.Generator().manual_seed(seed))
    np.testing.assert_allclose(err["w"].numpy(), (g["w"] - cg["w"]).numpy(),
                               atol=1e-7)
