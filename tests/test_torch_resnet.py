"""The port's ResNet-18 (the paper's model) vs the JAX reference on the
CPU: weights converted from the reference's init, the forward within a
stated tolerance, the compiled plans of every basic-block conv identical,
and the lookup conv bit-exact against the reference's lookup conv and
against the integer conv at strides 1 and 2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.resnet18 import CONFIG as JCONFIG
from repro.configs.resnet18 import SMOKE as JSMOKE
from repro.models import resnet as JR

from repro_torch.configs import get_config
from repro_torch.configs.resnet18 import SMOKE
from repro_torch.convert import resnet_params_from_jax
from repro_torch.kernels import ops as tops
from repro_torch.kernels import tlmac_clustered as tcl
from repro_torch.models import resnet as TR

from _torch_parity import plans_equal

# logits of the float forward: the same f32 operations, but XLA's and
# torch's convolutions and reductions sum in other orders; a flipped
# 3-bit activation code at a threshold is the worst case, and none
# occurs at these inputs
LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module")
def model():
    jp = JR.init_resnet(jax.random.PRNGKey(0), JSMOKE)
    tp = resnet_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


@pytest.fixture(scope="module")
def plans(model):
    jp, tp = model
    return (JR.compile_resnet(jp, JSMOKE, anneal_iters=200),
            TR.compile_resnet(tp, SMOKE, anneal_iters=200))


def test_configs_and_init_match_reference():
    assert get_config("resnet18") == TR.ResNetConfig(
        **{f: getattr(JCONFIG, f) for f in ("name", "num_classes", "w_bits",
                                            "a_bits", "width", "stages",
                                            "in_hw")})
    assert SMOKE.stages == JSMOKE.stages and SMOKE.width == JSMOKE.width
    jp = jax.tree.map(np.asarray, JR.init_resnet(jax.random.PRNGKey(1),
                                                 JSMOKE))
    tp = TR.init_resnet(SMOKE, torch.Generator().manual_seed(1), device="cpu")
    jl, jt = jax.tree_util.tree_flatten_with_path(jp)
    tl = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), tp))[0]
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        assert a.shape == b.shape and a.dtype == b.dtype, path
    assert TR.block_strides(SMOKE) == JR.block_strides(JSMOKE)


def test_convert_keeps_every_bit(model):
    jp, tp = model
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                            jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                                         tp))):
        assert np.array_equal(np.asarray(a), b), path


@pytest.mark.parametrize("hw", [16, 7])
def test_forward_logits_match_jax(model, hw):
    jp, tp = model
    x = np.random.default_rng(hw).normal(size=(2, hw, hw, 3)).astype(
        np.float32)
    want = np.asarray(JR.forward(jp, jnp.asarray(x), JSMOKE))
    got = TR.forward(tp, torch.from_numpy(x), SMOKE)
    assert got.shape == (2, SMOKE.num_classes)
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("stride,n,hw", [(1, 3, 8), (2, 1, 8), (2, 2, 7),
                                         (1, 1, 5)])
def test_same_conv_padding_matches_xla(stride, n, hw):
    rng = np.random.default_rng(stride * 10 + hw)
    x = rng.normal(size=(2, hw, hw, 4)).astype(np.float32)
    w = rng.normal(size=(5, 4, n, n)).astype(np.float32)
    want = np.asarray(JR._conv(jnp.asarray(x), jnp.asarray(w), stride))
    got = TR._conv(torch.from_numpy(x), torch.from_numpy(w), stride)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_compile_resnet_plans_identical(model, plans):
    jplans, tplans = plans
    assert [n for n, _ in jplans] == [n for n, _ in tplans]
    for (name, jplan), (_, tplan) in zip(jplans, tplans):
        plans_equal(tplan, jplan)
    jp, tp = model
    for blk_j, blk_t in zip(jp["blocks"], tp["blocks"]):
        for name in ("conv1", "conv2"):
            assert np.array_equal(
                TR.quantize_conv_weights(blk_t[name], SMOKE),
                JR.quantize_conv_weights(blk_j[name], JSMOKE))


def _int_conv(a, w, stride):
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(a, jnp.float32), jnp.asarray(w, jnp.float32),
        (stride, stride), "SAME", dimension_numbers=("NHWC", "OIHW", "NHWC"),
    ).astype(jnp.int32))


# (plan index, stride, input hw): block0.conv1 at stride 1, block1.conv1
# (stride 2) at even and odd maps, block1.conv2 (two output tiles)
CONV_CASES = [(0, 1, 6), (2, 2, 8), (2, 2, 7), (3, 1, 5)]


@pytest.mark.parametrize("pi,stride,hw", CONV_CASES)
def test_tlmac_conv_forward_bitexact(model, plans, pi, stride, hw):
    jp, tp = model
    (name, jplan), (_, tplan) = plans[0][pi], plans[1][pi]
    blk = jp["blocks"][pi // 2]["conv1" if pi % 2 == 0 else "conv2"]
    w_codes = JR.quantize_conv_weights(blk, JSMOKE)
    a = np.random.default_rng(pi + hw).integers(
        0, 2**SMOKE.a_bits, size=(2, hw, hw, w_codes.shape[1]))
    want = np.asarray(JR.tlmac_conv_forward(jplan, jnp.asarray(a),
                                            JSMOKE.quant, stride=stride))
    assert np.array_equal(want, _int_conv(a, w_codes, stride))
    got = TR.tlmac_conv_forward(tplan, torch.from_numpy(a.astype(np.int8)),
                                SMOKE.quant, stride=stride)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert TR.tlmac_conv_check(tplan, None, w_codes)


@pytest.mark.parametrize("pi", [0, 3])
def test_clustered_conv_rows_equal_row_gemms(plans, pi):
    """One cluster-scheduled launch over a conv plan computes all three
    kernel rows (columns oc*3 + r); de-interleaved they equal the three
    row GEMMs of the lookup conv, and the single-tile kernel agrees."""
    tplan = plans[1][pi][1]
    C = tplan.orig_shape[1]
    a = np.random.default_rng(pi).integers(0, 8, size=(2, 5, 5, C))
    win = TR.conv_windows(torch.from_numpy(a.astype(np.int8)))
    n_ot, dpc = tplan.D_s // C, tplan.D_p // 3
    multi = tcl.run_clustered_multi(tplan, win, 3, N=n_ot * tplan.D_p)
    rows = multi.reshape(-1, n_ot, dpc, 3)
    for r in range(3):
        want = tops.tlmac_matmul(win, *TR.conv_row_plan(tplan, r, "cpu"),
                                 B_a=3, G=3, N=n_ot * dpc, impl="pallas")
        assert torch.equal(rows[..., r].reshape(-1, n_ot * dpc), want)
    if n_ot == 1:
        assert torch.equal(tcl.run_clustered(tplan, win, 3), multi)
    comb = TR.combine_row_sums([rows[..., r].reshape(2, 5, 5, n_ot * dpc)
                                for r in range(3)])
    assert torch.equal(comb, TR.tlmac_conv_forward(
        tplan, torch.from_numpy(a.astype(np.int8)), SMOKE.quant))
