"""The int8 and dense serve layouts (``nn.serve_linear_apply`` dispatched
on the params, as the reference's) against the JAX package: single
linears, the swiglu pair's fallback, and the paged forwards of the four
families ``test_torch_families.py`` adds, on params converted from
``lm.init_lm(PRNGKey(0), cfg, purpose='serve')`` (int8 steps calibrated
on both sides, see ``tests/_torch_families.py``).

The int8 product is exact int32 on the CPU (no float in it), so int8 and
dense linears equal JAX's bit for bit; the forwards carry the vocab
head's allowance of ``_torch_families.HEAD_ULP_SHARE``."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.models import lm as jlm
from repro.models import nn as jnn

from repro_torch import convert
from repro_torch.models import lm as tlm
from repro_torch.models import nn as tnn

import _torch_families as F

LINEARS = [("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
           ("ffn", "wi"), ("ffn", "wg"), ("ffn", "wo")]


@pytest.mark.parametrize("M", [1, 4, 16, 17, 64])
def test_int8_product_is_exact_int32_on_cpu(M):
    rng = np.random.default_rng(M)
    a = rng.integers(-127, 128, (M, 96)).astype(np.int8)
    w = rng.integers(-127, 128, (96, 40)).astype(np.int8)
    got = tnn.int8_matmul(torch.from_numpy(a), torch.from_numpy(w))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), a.astype(np.int64) @ w.astype(np.int64))


@pytest.mark.parametrize("layout", ["int8", "dense"])
@pytest.mark.parametrize("family", ["command-r-gqa-r4", "minicpm-gqa"])
def test_serve_linears_bitexact_vs_jax(family, layout):
    """Every linear of both layers, on activations that cross code
    boundaries (and the bias of codeqwen-style qkv where configured)."""
    jcfg, tcfg, params, tp = F.model(family, layout)
    rng = np.random.default_rng(5)
    for layer in range(jcfg.n_layers):
        seg = params["segments"][0]["b0"]
        tseg = tp.layers(0)[layer]["b0"]
        for blk, name in LINEARS:
            jp = jax.tree.map(lambda a: a[layer], seg[blk][name])
            assert tnn.layout(tseg[blk][name]) == layout
            K = (jp["w8"] if layout == "int8" else jp["w"]).shape[0]
            x = jnp.asarray(rng.standard_normal((3, 5, K)) * 2, jnp.bfloat16)
            tx = convert.to_torch(np.asarray(x), "cpu")
            bias = blk == "attn" and name != "wo" and jcfg.qkv_bias
            want = F.to_np(jax.jit(lambda p, x: jnn.serve_linear_apply(
                p, x, jcfg, use_bias=bias))(jp, x))
            got = tnn.serve_linear_apply(tseg[blk][name], tx, tcfg,
                                         use_bias=bias)
            assert got.dtype == torch.bfloat16
            assert np.array_equal(got.float().numpy(), want), (layer, blk,
                                                               name)


@pytest.mark.parametrize("layout", ["int8", "dense", "mixed"])
def test_pair_apply_falls_back_unless_both_are_tlmac(layout):
    """``serve_linear_pair_apply`` runs two independent applies for any
    pair that is not two tlmac linears, as the reference's does; the FFN
    equals the jitted JAX FFN (its gated product reaches ``wo`` as XLA
    rounds it for that layout)."""
    jcfg, tcfg, params, tp = F.model("command-r-gqa-r4", layout)
    jffn = jax.tree.map(lambda a: a[0], params["segments"][0]["b0"]["ffn"])
    tffn = tp.layers(0)[0]["b0"]["ffn"]
    rng = np.random.default_rng(9)
    h = jnp.asarray(rng.standard_normal((16, jcfg.d_model)), jnp.bfloat16)
    th = convert.to_torch(np.asarray(h), "cpu")
    y1, y2 = tnn.serve_linear_pair_apply(tffn["wi"], tffn["wg"], th, tcfg)
    if layout != "mixed":
        assert torch.equal(y1, tnn.serve_linear_apply(tffn["wi"], th, tcfg))
        assert torch.equal(y2, tnn.serve_linear_apply(tffn["wg"], th, tcfg))
    apply_fn = jlm._apply_fn_for("serve")
    want = F.to_np(jax.jit(lambda p, h: jlm.ffn_apply(
        p, h, jcfg, apply_fn))(jffn, h))
    got = tlm.ffn_apply(tffn, th, tcfg, tnn.serve_linear_apply)
    assert np.array_equal(got.float().numpy(), want)


def test_unknown_serve_impl_raises():
    _, tcfg = F.cfgs("codeqwen-gqa", impl="fp8")
    with pytest.raises(ValueError, match="serve_impl"):
        tnn.init_serve_linear(torch.Generator().manual_seed(0), 8, 8, tcfg,
                              device="cpu")


@pytest.mark.parametrize("family", F.NEW_FAMILIES)
@pytest.mark.parametrize("layout", ["int8", "dense"])
def test_paged_forwards_bitexact_vs_jax(family, layout):
    kw = dict(local_window=8) if family == "window-local" else {}
    F.assert_forwards_match(family, layout, **kw)


@pytest.mark.parametrize("impl", ["int8", "dense"])
def test_init_lm_draws_each_layout(impl):
    _, tcfg = F.cfgs("command-r-gqa-r4", impl=impl)
    tree = tlm.init_lm(tcfg, torch.Generator().manual_seed(0),
                       device="cpu").tree()
    lin = tree["segments"][0]["b0"]["attn"]["wk"]
    if impl == "int8":
        assert lin["w8"].dtype == torch.int8 and lin["w8"].shape == (2, 128, 32)
        assert int(lin["w8"].min()) >= -127 and int(lin["w8"].max()) <= 126
        assert lin["w_step"].shape == (2, 32) and lin["a_step"].shape == (2,)
    else:
        assert lin["w"].dtype == torch.bfloat16 and lin["w"].shape == (2, 128, 32)
        assert 0.5 < float(lin["w"].float().std() * np.sqrt(128)) < 1.5
    assert tnn.layout(tlm.nn.tree_index(lin, 0)) == impl
