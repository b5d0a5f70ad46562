"""The recurrent blocks of the port (``models/xlstm.py``,
``models/rglru.py``) against the JAX package's, on the same numpy inputs
and params converted from JAX's init, each block jitted on the JAX side
as the serve path runs it.

XLA's f32 ``exp``, ``tanh``, ``sigmoid`` and ``log_sigmoid`` are its own
polynomials, not torch's: the states are held within ``STATE_RTOL`` of
their scale, and the blocks' bf16 outputs row by row: at most
``OUT_ROW_SHARE`` of the rows (tokens) may differ at all (a state's last
ulp can move one 3-bit activation code of the output linear, which moves
that row), and those within ``OUT_RTOL`` of the scale.  The RG-LRU state
gets a wider ``STATE_RTOL``: its input gain ``sqrt(1 - a^2)`` cancels
where ``a`` nears 1, so an ulp of XLA's ``exp`` against torch's becomes
up to 5e-4 of ``bx`` and about 2e-5 of the state (measured on these
inputs); the xLSTM states stay within 1e-6.
Each block runs at S = 1 from a carried state (a decode step after a
16-token prefill, the state JAX's), at S = 16 and at S = 128 (the xLSTM
scan's two chunks).  At S = 100 both packages' xLSTM scans refuse the
length.  The associative scan of the RG-LRU prefill is held against
``jax.lax.associative_scan`` of the same combine.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import smoke_config as jsmoke
from repro.models import nn as jnn
from repro.models import rglru as jrglru
from repro.models import xlstm as jxlstm

from repro_torch import convert
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.models import rglru as trglru
from repro_torch.models import xlstm as txlstm

import _torch_families  # noqa: F401  (one torch thread per worker)

STATE_RTOL = {"mlstm": 1e-5, "slstm": 1e-5, "rglru": 1e-4}
CONV_RTOL = 1e-5
OUT_RTOL = 5e-2
OUT_ROW_SHARE = 1e-2

BLOCKS = {  # kind: (arch, JAX init, JAX apply, port apply)
    "mlstm": ("xlstm-350m", jxlstm.init_mlstm, jxlstm.mlstm_apply,
              txlstm.mlstm_apply),
    "slstm": ("xlstm-350m", jxlstm.init_slstm, jxlstm.slstm_apply,
              txlstm.slstm_apply),
    "rglru": ("recurrentgemma-2b", jrglru.init_rglru_block,
              jrglru.rglru_block_apply, trglru.rglru_block_apply),
}
_params: dict = {}


def _block(kind):
    """(jcfg, tcfg, JAX params, port params) of one serve block."""
    if kind not in _params:
        arch, init, _, _ = BLOCKS[kind]
        jcfg, tcfg = jsmoke(arch), tsmoke(arch)
        jp, _ = init(jax.random.PRNGKey(1), jcfg,
                     linear_init=jnn.init_serve_linear)
        tp = convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                     device="cpu").tree()
        _params[kind] = (jcfg, tcfg, jp, tp)
    return _params[kind]


def _t(a):
    return convert.to_torch(np.asarray(a), "cpu")


def _x(cfg, S, seed):
    x = np.random.default_rng(seed).standard_normal((2, S, cfg.d_model)) * 2
    return jnp.asarray(x, jnp.bfloat16)


def _run(kind, x, jstate=None):
    jcfg, tcfg, jp, tp = _block(kind)
    _, _, japply, tapply = BLOCKS[kind]
    fn = jax.jit(lambda p, x, s: japply(p, x, jcfg, state=s,
                                        apply_fn=jnn.serve_linear_apply))
    jy, js = fn(jp, x, jstate)
    tstate = None if jstate is None else {k: _t(v) for k, v in
                                          jstate.items()}
    ty, ts = tapply(tp, _t(x), tcfg, state=tstate)
    return jy, js, ty, ts


def _assert_close(kind, jy, js, ty, ts):
    want = np.asarray(jy, np.float32)
    got = ty.float().numpy()
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= OUT_RTOL * scale
    rows = (got != want).any(-1)
    assert rows.sum() <= max(1, OUT_ROW_SHARE * rows.size), rows.sum()
    assert set(ts) == set(js)
    for name, leaf in js.items():
        w = np.asarray(leaf, np.float64)
        g = ts[name].double().numpy()
        assert g.shape == w.shape and ts[name].dtype == torch.float32, name
        tol = STATE_RTOL[kind] * max(np.abs(w).max(), 1.0)
        assert np.abs(g - w).max() <= tol, (
            name, np.abs(g - w).max(), np.abs(w).max())


@pytest.mark.parametrize("kind", sorted(BLOCKS))
@pytest.mark.parametrize("S", [16, 128])
def test_block_prefill_matches_jax(kind, S):
    jy, js, ty, ts = _run(kind, _x(_block(kind)[0], S, S))
    _assert_close(kind, jy, js, ty, ts)


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_decode_step_from_carried_state_matches_jax(kind):
    cfg = _block(kind)[0]
    _, js, _, _ = _run(kind, _x(cfg, 16, 3))
    jy, js1, ty, ts1 = _run(kind, _x(cfg, 1, 4), jstate=js)
    _assert_close(kind, jy, js1, ty, ts1)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_scan_refuses_a_ragged_length_like_jax(kind):
    """S = 100 is past one 64-step chunk and not a multiple of it."""
    x = _x(_block(kind)[0], 100, 5)
    with pytest.raises(AssertionError):
        _run(kind, x)
    jcfg, tcfg, jp, tp = _block(kind)
    with pytest.raises(AssertionError):
        BLOCKS[kind][3](tp, _t(x), tcfg)


@pytest.mark.parametrize("S", [1, 2, 16, 37, 128])
def test_depthwise_causal_conv_matches_jax(S):
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    want = np.asarray(jax.jit(jxlstm._depthwise_causal_conv)(x, w))
    got = txlstm._depthwise_causal_conv(torch.from_numpy(x),
                                        torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=CONV_RTOL, atol=1e-6)


@pytest.mark.parametrize("S", [2, 5, 16, 37, 128])
def test_associative_scan_matches_jax(S):
    """The RG-LRU combine over ``(log_a, bx)`` along the sequence axis, in
    JAX's order (odd lengths take its other branch)."""
    rng = np.random.default_rng(S)
    la = -np.abs(rng.standard_normal((2, S, 8))).astype(np.float32) * 0.1
    bx = rng.standard_normal((2, S, 8)).astype(np.float32)

    def comb(l, r):
        return (l[0] + r[0], jnp.exp(r[0]) * l[1] + r[1])

    wa, wb = jax.jit(lambda a, b: jax.lax.associative_scan(
        comb, (a, b), axis=1))(la, bx)
    ga, gb = trglru.associative_scan(
        trglru._comb, (torch.from_numpy(la), torch.from_numpy(bx)), dim=1)
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), rtol=CONV_RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=CONV_RTOL,
                               atol=1e-5)
    # the first component is the running sum of log_a
    seq = np.cumsum(la, axis=1)
    np.testing.assert_allclose(ga.numpy(), seq, rtol=1e-4, atol=1e-5)


def test_zero_states_match_jax():
    from repro.models import lm as jlm
    from repro_torch.models import lm as tlm

    for arch in ("xlstm-350m", "recurrentgemma-2b"):
        jcfg, tcfg = jsmoke(arch), tsmoke(arch)
        for kind in {k for s in jlm.segments_for(jcfg) for k in s.pattern}:
            if kind == "attn_local":
                continue
            want = jlm.zero_cache(kind, jcfg, 3, 16)
            got = tlm.zero_cache(kind, tcfg, 3, 16, device="cpu")
            assert set(got) == set(want), kind
            for name, leaf in want.items():
                assert torch.equal(got[name], _t(leaf)), (kind, name)
