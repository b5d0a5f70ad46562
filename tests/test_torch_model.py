"""Port model vs the JAX reference on the smoke configs (codeqwen rep=1,
mistral rep=4): params come from ``lm.init_lm(PRNGKey(0), cfg,
purpose='serve')`` through ``repro_torch.convert``.  Each serve linear's
lookup GEMM is bit-exact in int32; the paged forwards' logits match the
JAX forwards run with ``serve_paged_attn_impl='lax'`` within
``LOGIT_TOL``."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import smoke_config as jsmoke
from repro.core.tlmac.compile import plan_shapes as jplan_shapes
from repro.kernels import ops as jops
from repro.kernels.paged import spec_for as jspec_for
from repro.models import lm as jlm
from repro.models import nn as jnn

from repro_torch import convert
from repro_torch.configs import get_config, smoke_config as tsmoke
from repro_torch.core.tlmac.compile import plan_shapes as tplan_shapes
from repro_torch.kernels.ops import tlmac_matmul
from repro_torch.kernels.paged import spec_for
from repro_torch.models import lm as tlm
from repro_torch.models import nn as tnn

ARCHS = ["codeqwen1.5-7b", "mistral-large-123b"]
# bf16 logits after two layers: the frameworks may round a bf16
# intermediate differently where sums are taken in another order, and a
# flipped activation code moves a logit by a few bf16 steps at most
LOGIT_TOL = 2e-2
LINEARS = [("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
           ("ffn", "wi"), ("ffn", "wg"), ("ffn", "wo")]
READ_FIELDS = ["name", "family", "n_layers", "d_model", "n_heads", "n_kv",
               "d_ff", "vocab", "head_dim", "act", "tie_embeddings",
               "qkv_bias", "tlmac_G", "tlmac_dp", "tlmac_narr_cap",
               "serve_impl", "serve_kv_dtype", "serve_shared_act_quant"]

_cache = {}


def _model(arch, kv_dtype="fp"):
    key = (arch, kv_dtype)
    if key not in _cache:
        jcfg = dataclasses.replace(jsmoke(arch), serve_paged_attn_impl="lax",
                                   serve_kv_dtype=kv_dtype)
        tcfg = dataclasses.replace(tsmoke(arch), serve_kv_dtype=kv_dtype)
        params, _ = jlm.init_lm(jax.random.PRNGKey(0), jcfg, purpose="serve")
        tp = convert.params_from_jax(jax.tree.map(np.asarray, params),
                                     device="cpu")
        _cache[key] = (jcfg, tcfg, params, tp)
    return _cache[key]


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    j, t = jsmoke(arch), tsmoke(arch)
    for f in READ_FIELDS:
        assert getattr(j, f) == getattr(t, f), f
    assert j.quant.w_bits == t.quant.w_bits and j.quant.a_bits == t.quant.a_bits
    assert j.kv_head_dim == t.kv_head_dim
    full = get_config(arch)
    assert (full.n_layers, full.d_model, full.d_ff, full.vocab) == (
        {"codeqwen1.5-7b": (32, 4096, 13440, 92416),
         "mistral-large-123b": (88, 12288, 28672, 32768)}[arch])


@pytest.mark.parametrize("K,N,want_dp", [(4096, 4096, 128), (4096, 13440, 120),
                                         (13440, 4096, 128), (64, 64, 4),
                                         (64, 128, 8)])
def test_plan_shapes_and_dp_match_reference(K, N, want_dp):
    dp = tnn._pick_dp(N, 128)
    assert dp == jnn._pick_dp(N, 128) == want_dp
    assert tplan_shapes(K, N, 4, 3, n_arr_cap=4096, d_p=dp) == jplan_shapes(
        K, N, 4, 3, n_arr_cap=4096, d_p=dp)


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_keeps_every_bit(arch):
    _, _, params, tp = _model(arch)
    flat_j = jax.tree_util.tree_flatten_with_path(params)[0]
    tree = tp.tree()
    for path, leaf in flat_j:
        t = tree
        for k in path:
            t = t[getattr(k, "key", getattr(k, "idx", None))]
        a = np.asarray(leaf)
        if path[0].key in ("embed", "head"):
            a = np.asarray(jnp.asarray(a).astype(jnp.bfloat16))
        assert tuple(t.shape) == a.shape, path
        want = convert.to_torch(a, "cpu")
        assert t.dtype == want.dtype, path
        assert torch.equal(t.view(torch.uint8) if t.dtype == torch.bfloat16
                           else t, want.view(torch.uint8)
                           if want.dtype == torch.bfloat16 else want), path


@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_matches_reference_structure(arch):
    jcfg, tcfg, params, _ = _model(arch)
    tp = tlm.init_lm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    jt = jax.tree.map(lambda x: (x.shape, str(x.dtype)), params)
    tt = tp.tree()
    for path, (shape, dt) in jax.tree_util.tree_flatten_with_path(
            jt, is_leaf=lambda x: isinstance(x, tuple))[0]:
        t = tt
        for k in path:
            t = t[getattr(k, "key", getattr(k, "idx", None))]
        assert tuple(t.shape) == tuple(shape), path
        if path[0].key not in ("embed", "head"):   # stored bf16 by design
            assert str(t.dtype).replace("torch.", "") == dt, path


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("layer", [0, 1])
def test_serve_linear_gemms_bitexact_vs_jax(arch, layer):
    jcfg, tcfg, params, tp = _model(arch)
    rng = np.random.default_rng(layer)
    seg = params["segments"][0]["b0"]
    tseg = tp.layers(0)[layer]["b0"]
    for blk, name in LINEARS:
        jp = jax.tree.map(lambda a: a[layer], seg[blk][name])
        n_tiles, kg, dp = jp["exec_idx"].shape
        K = kg * jcfg.tlmac_G
        x = (rng.standard_normal((3, 5, K)) * 2).astype(np.float32)
        jx = jnp.asarray(x, jnp.bfloat16)
        aq, _ = jnn._tlmac_quant_pack(jp["a_step"], jx, jcfg)
        want = np.asarray(jops.tlmac_matmul(
            aq, jp["table"], jp["exec_idx"].reshape(-1, dp).astype(jnp.int32),
            jp["step_cluster"].reshape(-1).astype(jnp.int32),
            B_a=3, G=4, N=n_tiles * dp, impl="ref"))
        tx = convert.to_torch(np.asarray(jx), "cpu")
        tq = tnn._tlmac_quant_pack(tseg[blk][name]["a_step"], tx, tcfg)
        assert np.array_equal(tq.numpy(), np.asarray(aq))
        got = tlmac_matmul(tq, tseg[blk][name]["table"],
                           tseg[blk][name]["exec_idx"],
                           tseg[blk][name]["step_cluster"], B_a=3, G=4,
                           N=n_tiles * dp)
        assert np.array_equal(got.numpy(), want), (blk, name)
        bias = blk == "attn" and name != "wo" and jcfg.qkv_bias
        jy = jnn.serve_linear_apply(jp, jx, jcfg, use_bias=bias)
        ty = tnn.serve_linear_apply(tseg[blk][name], tx, tcfg, use_bias=bias)
        assert np.array_equal(np.asarray(jy, np.float32), ty.float().numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_params_carry_narrow_tables_that_change_nothing(arch):
    """The converter and ``init_lm`` add each serve linear's int8 rows
    once; a forward through them is bit-identical to one through the
    int32 tables (the plain version reads either)."""
    _, tcfg, _, tp = _model(arch)
    init = tlm.init_lm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    for tree in (tp.tree(), init.tree()):
        seg = tree["segments"][0]["b0"]
        for blk, name in LINEARS:
            t, n = seg[blk][name]["table"], seg[blk][name]["table_narrow"]
            assert t.dtype == torch.int32 and n.dtype == torch.int8
            assert torch.equal(n.to(torch.int32), t), (blk, name)
    bare = convert.ParamTree(_drop_narrow(tp.tree()))
    spec = spec_for(48, 2, page_size=8)
    bt = torch.zeros((2, spec.max_blocks), dtype=torch.int32)
    bt[0, :2] = torch.tensor([3, 5])
    toks = torch.tensor([[7], [1]], dtype=torch.int32)
    pos = torch.tensor([9, 0], dtype=torch.int32)
    out = []
    for params in (tp, bare):
        caches = tlm.init_caches(tcfg, spec, device="cpu")
        logits, _ = tlm.decode_step_paged(params, caches, toks, pos, bt, tcfg)
        out.append(logits)
    assert torch.equal(out[0], out[1])


def _drop_narrow(tree):
    if isinstance(tree, dict):
        return {k: _drop_narrow(v) for k, v in tree.items()
                if k != "table_narrow"}
    if isinstance(tree, list):
        return [_drop_narrow(v) for v in tree]
    return tree


def test_norm_rotary_embed_logits_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = convert.to_torch(np.asarray(jx), "cpu")
    scale = rng.standard_normal(32).astype(np.float32)
    a = np.asarray(jnn.rmsnorm_apply({"scale": jnp.asarray(scale)}, jx),
                   np.float32)
    b = tnn.rmsnorm_apply({"scale": torch.from_numpy(scale)}, tx).float()
    np.testing.assert_allclose(b.numpy(), a, atol=1e-2, rtol=1e-2)
    pos = np.array([[0, 5, 1000]], np.int32)
    js, jc = jnn.rotary_embedding(jnp.asarray(pos), 16)
    ts, tc = tnn.rotary_embedding(torch.from_numpy(pos), 16)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-4)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4)
    q = rng.standard_normal((1, 3, 2, 16)).astype(np.float32)
    jq = jnp.asarray(q, jnp.bfloat16)
    a = np.asarray(jnn.apply_rotary(jq, js, jc), np.float32)
    b = tnn.apply_rotary(convert.to_torch(np.asarray(jq), "cpu"), ts, tc)
    np.testing.assert_allclose(b.float().numpy(), a, atol=2e-2)
    for kind in ("swiglu", "gelu", "relu"):
        a = np.asarray(jnn.act_fn(kind)(jx), np.float32)
        b = tnn.act_fn(kind)(tx).float().numpy()
        np.testing.assert_allclose(b, a, atol=2e-2, rtol=2e-2)
    emb = (rng.standard_normal((48, 32)) * 0.02).astype(np.float32)
    toks = np.array([[1, 47, 3]], np.int32)
    a = np.asarray(jnn.embed_apply({"emb": jnp.asarray(emb)}, jnp.asarray(toks)),
                   np.float32)
    temb = {"emb": torch.from_numpy(emb).bfloat16()}
    b = tnn.embed_apply(temb, torch.from_numpy(toks)).float().numpy()
    assert np.array_equal(a, b)
    a = np.asarray(jnn.logits_apply({"emb": jnp.asarray(emb)}, jx, vocab=40),
                   np.float32)
    b = tnn.logits_apply(temb, tx, vocab=40).float().numpy()
    assert (b[..., 40:] == a[..., 40:]).all()
    np.testing.assert_allclose(b, a, atol=1e-2)


def _forward_pair(arch, kv_dtype):
    """A prefill chunk for slot 0, then two decode steps with slot 1
    idle (scratch page), on both sides; returns the logits pairs."""
    jcfg, tcfg, params, tp = _model(arch, kv_dtype)
    spec = jspec_for(48, 2, page_size=8)
    jc, _ = jlm.init_caches(jcfg, 2, 48, paged=spec)
    tc = tlm.init_caches(tcfg, spec_for(48, 2, page_size=8), device="cpu")
    rng = np.random.default_rng(11)
    row = np.zeros(spec.max_blocks, np.int32)
    row[:3] = [4, 2, 7]
    out = []
    for ci, n in enumerate((8, 8)):               # two chunks: 8 + 5 tokens
        toks = rng.integers(0, jcfg.vocab, (1, 8)).astype(np.int32)
        last = 7 if ci == 0 else 4
        jl, jc = jlm.prefill_chunk(params, jc, jnp.asarray(toks),
                                   jnp.int32(ci * 8), jnp.asarray(row), jcfg,
                                   last=jnp.int32(last))
        tl, _ = tlm.prefill_chunk(tp, tc, torch.from_numpy(toks), ci * 8,
                                  torch.from_numpy(row), tcfg, last=last)
        out.append((np.asarray(jl, np.float32), tl.float().numpy()))
    bt = np.zeros((2, spec.max_blocks), np.int32)
    bt[0] = row
    for pos0 in (13, 14):
        cur = rng.integers(0, jcfg.vocab, (2, 1)).astype(np.int32)
        pos = np.array([pos0, 0], np.int32)
        jl, jc = jlm.decode_step_paged(params, jc, jnp.asarray(cur),
                                       jnp.asarray(pos), jnp.asarray(bt), jcfg)
        tl, _ = tlm.decode_step_paged(tp, tc, torch.from_numpy(cur),
                                      torch.from_numpy(pos),
                                      torch.from_numpy(bt), tcfg)
        out.append((np.asarray(jl, np.float32)[0], tl.float().numpy()[0]))
    return out, jc, tc


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_forwards_match_jax_lax(arch, kv_dtype):
    pairs, jc, tc = _forward_pair(arch, kv_dtype)
    for want, got in pairs:
        assert got.shape == want.shape
        assert np.isfinite(got).all()
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, atol=LOGIT_TOL * scale, rtol=0)
    # the live pages of the pool hold the same K/V (codes + scales)
    live = [4, 2, 7]
    jpool = convert.pool_from_jax(jax.tree.map(np.asarray, jc), device="cpu")
    for name, want in jpool[0]["b0"].items():
        got = tc[0]["b0"][name]
        assert got.dtype == want.dtype and got.shape == want.shape, name
        a = want[:, live].float().numpy()
        b = got[:, live].float().numpy()
        np.testing.assert_allclose(b, a, atol=LOGIT_TOL * max(np.abs(a).max(), 1))
