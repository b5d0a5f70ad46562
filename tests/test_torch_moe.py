"""The port's MoE serve path against the JAX package on the oracle matrix's
``moe-gqa`` family (deepseek-v3's smoke config with GQA attention: 8
experts, top 2, one shared expert, layers 2-3 ``attn_moe``), on params
from ``lm.init_lm(PRNGKey(0), cfg, purpose='serve')`` converted by
``convert.params_from_jax``, inputs drawn from numpy seeds, JAX jitted.

- Configs: deepseek-v3's fields (MoE and MLA) equal the reference's; its
  GQA variant builds, pages and segments as the reference's; the MLA
  config is refused where a block would be built.
- Routing and ``moe_apply``: which expert each (token, slot) picks and
  which assignments the capacity keeps equal the reference's lines, and
  ``y`` is bit-equal, with groups long enough that the capacity drops
  assignments, through ``MAX_GROUP_TOKENS`` groups, and on a tie (zero
  router weights: uniform probabilities, where ``lax.top_k`` takes the
  lower experts).
- ``serve_expert_linear_apply`` bit-equal for the tlmac, int8 and dense
  layouts; kernel 1's expert axis (its plain version on the CPU) equal to
  one call per expert.
- The ``attn_moe`` block through ``prefill_chunk``, ``decode_step_paged``
  and ``verify_step_paged``: pools bit-equal, every logits row bit-equal
  but for the vocab head's allowance (``_torch_families.HEAD_ULP_SHARE``),
  the flash reader within ``FLASH_LOGIT_TOL``.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jget
from repro.configs import smoke_config as jsmoke
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models import nn as jnn

from repro_torch import convert
from repro_torch.configs import get_config, smoke_config as tsmoke
from repro_torch.kernels import tlmac_fused as tf
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models import nn as tnn

import _torch_families as F

ARCH = "deepseek-v3-671b"
FIELDS = ["name", "family", "n_layers", "d_model", "n_heads", "n_kv", "d_ff",
          "vocab", "head_dim", "act", "tie_embeddings", "qkv_bias",
          "tlmac_G", "tlmac_dp", "tlmac_narr_cap", "serve_impl",
          "attn_kind", "mla_q_lora", "mla_kv_lora", "mla_rope_dim",
          "mla_nope_dim", "mla_v_dim", "n_experts", "top_k", "n_shared",
          "d_expert", "moe_layer_start", "capacity_factor"]


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _from_jax(a):
    return convert.to_torch(np.asarray(a), "cpu")


def _moe_layer(layout="tlmac", steps="init"):
    """(jcfg, tcfg, JAX params, port params) of layer 0 of the ``attn_moe``
    segment's MoE.  ``steps='calibrated'``: every lookup linear on
    ``_torch_families.calibrate_tlmac``'s steps, on both sides."""
    jcfg, tcfg, params, tp = F.model("moe-gqa", layout, steps=steps)
    jp = jax.tree.map(lambda a: a[0], params["segments"][1]["b0"]["moe"])
    return jcfg, tcfg, jp, tp.layers(1)[0]["b0"]["moe"]


def _jax_route(w, x, cfg):
    """The reference's routing lines (``repro.models.moe._moe_grouped``):
    experts picked, assignments kept."""
    G, t, _ = x.shape
    E, k = cfg.n_experts, cfg.top_k
    cap = max(int(cfg.capacity_factor * t * k / E), 1)
    logits = jnp.einsum("gtd,de->gte", x.astype(jnp.float32), w)
    probs = jax.nn.softmax(logits, axis=-1)
    _, eidx = jax.lax.top_k(probs, k)
    oh_e = jax.nn.one_hot(eidx, E, dtype=jnp.int32)
    flat = oh_e.reshape(G, t * k, E)
    pos = jnp.cumsum(flat, axis=1) - flat
    pos = jnp.sum(pos * flat, axis=-1).reshape(G, t, k)
    return eidx, pos < cap


def _x(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.standard_normal(shape) * scale, jnp.bfloat16)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def test_deepseek_config_matches_reference():
    for j, t in ((jsmoke(ARCH), tsmoke(ARCH)), (jget(ARCH), get_config(ARCH))):
        for f in FIELDS:
            assert getattr(j, f) == getattr(t, f), f
        assert (j.quant.w_bits, j.quant.a_bits) == (t.quant.w_bits,
                                                    t.quant.a_bits)
        jg = dataclasses.replace(j, attn_kind="gqa")
        tg = dataclasses.replace(t, attn_kind="gqa")
        assert jg.kv_head_dim == tg.kv_head_dim
        assert [(s.pattern, s.n) for s in tlm.segments_for(tg)] == [
            (s.pattern, s.n) for s in jlm.segments_for(jg)]
        assert tlm.supports_paged(tg) and jlm.supports_paged(jg)
        assert not tlm.supports_paged(t) and not jlm.supports_paged(j)
    assert get_config(ARCH).kv_head_dim == 56
    # the MLA config itself builds MLA blocks, in the reference's segments
    t = tsmoke(ARCH)
    assert [(s.pattern, s.n) for s in tlm.segments_for(t)] == [
        (s.pattern, s.n) for s in jlm.segments_for(jsmoke(ARCH))]
    p = tlm.init_lm(t, torch.Generator().manual_seed(0), device="cpu")
    assert "wkv_b" in p.tree()["segments"][1]["b0"]["attn"]


def test_converted_moe_tree_matches_init_lm():
    """``params_from_jax`` keeps every expert-stacked leaf ``[L, E, ...]``
    bit for bit (and adds ``table_narrow`` beside each table), and the
    port's own ``init_lm`` builds the same structure, shapes and dtypes."""
    jcfg, tcfg, params, tp = F.model("moe-gqa")
    tree = tp.tree()
    init = tlm.init_lm(tcfg, torch.Generator().manual_seed(0),
                       device="cpu").tree()
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        t, i = tree, init
        for k in keys:
            t, i = t[k], i[k]
        a = np.asarray(leaf)
        if keys[0] in ("embed", "head"):
            a = np.asarray(jnp.asarray(a).astype(jnp.bfloat16))
        want = convert.to_torch(a, "cpu")
        assert t.dtype == want.dtype == i.dtype, keys
        assert tuple(t.shape) == a.shape == tuple(i.shape), keys
        assert torch.equal(_bits(t), _bits(want)), keys
        n += "moe" in keys and keys[-2] in ("wi", "wg", "wo")
    assert n == 3 * 5                 # wi/wg/wo x five tlmac leaves
    moe = tree["segments"][1]["b0"]["moe"]
    assert moe["wi"]["exec_idx"].shape[:2] == (2, 8)        # [L, E, ...]
    assert torch.equal(moe["wi"]["table_narrow"].long(),
                       moe["wi"]["table"].long())


# ---------------------------------------------------------------------------
# routing and moe_apply
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("steps", ["init", "calibrated"])
@pytest.mark.parametrize("G,t", [(2, 48), (4, 1), (1, 8)])
def test_moe_apply_bitexact_with_capacity_drops(G, t, steps):
    """Groups of 48 (cap 15), decode groups of one token (cap 1) and a
    paged chunk of 8 (cap 2): experts picked and kept equal the
    reference's, ``y`` bit-equal; the long groups drop assignments."""
    jcfg, tcfg, jp, tp = _moe_layer(steps=steps)
    x = _x((G, t, jcfg.d_model), seed=G * 100 + t, scale=2.0)
    jy, jaux = jax.jit(lambda p, x: jmoe.moe_apply(
        p, x, jcfg, apply_fn=jnn.serve_linear_apply))(jp, x)
    jeidx, jkeep = jax.jit(lambda w, x: _jax_route(w, x, jcfg))(
        jp["router"]["w"], x)
    tx = _from_jax(x)
    ty, taux = tmoe.moe_apply(tp, tx, tcfg)
    _, _, teidx, tkeep, _, cap = tmoe.route(tp["router"]["w"], tx, tcfg)
    assert np.array_equal(teidx.numpy(), np.asarray(jeidx))
    assert np.array_equal(tkeep.numpy(), np.asarray(jkeep))
    if t == 48:
        assert cap == 15 and not tkeep.all()      # the capacity dropped some
    assert torch.equal(_bits(ty), _bits(_from_jax(jy)))
    assert abs(float(taux) - float(jaux)) <= 1e-6 * abs(float(jaux))


def test_moe_apply_cuts_long_sequences_into_groups(monkeypatch):
    """A sequence past ``MAX_GROUP_TOKENS`` routes in groups of that many
    tokens (16 here, both packages): bit-equal, and not the one-group
    result."""
    jcfg, tcfg, jp, tp = _moe_layer()
    x = _x((1, 48, jcfg.d_model), seed=5, scale=2.0)
    tx = _from_jax(x)
    whole, _ = tmoe.moe_apply(tp, tx, tcfg)
    for mod in (jmoe, tmoe):
        monkeypatch.setattr(mod, "MAX_GROUP_TOKENS", 16)
    jy, _ = jax.jit(lambda p, x: jmoe.moe_apply(
        p, x, jcfg, apply_fn=jnn.serve_linear_apply))(jp, x)
    ty, _ = tmoe.moe_apply(tp, tx, tcfg)
    assert torch.equal(_bits(ty), _bits(_from_jax(jy)))
    assert not torch.equal(ty, whole)
    with pytest.raises(ValueError, match="groups"):
        tmoe.moe_apply(tp, tx[:, :40], tcfg)


def test_router_ties_pick_the_lower_experts_as_lax_top_k():
    """Zero router weights: every expert has probability 1/E; ``lax.top_k``
    takes experts 0 and 1 for every token, and so must the port."""
    jcfg, tcfg, jp, tp = _moe_layer()
    jp = dict(jp, router={"w": jnp.zeros_like(jp["router"]["w"])})
    tp = dict(tp, router={"w": torch.zeros_like(tp["router"]["w"])})
    x = _x((2, 8, jcfg.d_model), seed=9)
    jeidx, jkeep = jax.jit(lambda w, x: _jax_route(w, x, jcfg))(
        jp["router"]["w"], x)
    assert (np.asarray(jeidx) == np.arange(jcfg.top_k)).all()
    tx = _from_jax(x)
    _, _, teidx, tkeep, _, _ = tmoe.route(tp["router"]["w"], tx, tcfg)
    assert np.array_equal(teidx.numpy(), np.asarray(jeidx))
    assert np.array_equal(tkeep.numpy(), np.asarray(jkeep))
    jy, _ = jax.jit(lambda p, x: jmoe.moe_apply(
        p, x, jcfg, apply_fn=jnn.serve_linear_apply))(jp, x)
    ty, _ = tmoe.moe_apply(tp, tx, tcfg)
    assert torch.equal(_bits(ty), _bits(_from_jax(jy)))


# ---------------------------------------------------------------------------
# expert linears
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["tlmac", "int8", "dense"])
@pytest.mark.parametrize("K,N", [(64, 32), (32, 64)])
def test_serve_expert_linear_apply_bitexact_vs_jax(layout, K, N):
    jcfg, tcfg = F.cfgs("moe-gqa", layout)
    E = jcfg.n_experts
    jp, _ = jnn.init_serve_linear(jax.random.PRNGKey(K + N), K, N, jcfg,
                                  expert=E)
    jp = F._calibrate_int8(jp)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, {"l": jp}),
                                 device="cpu").tree()["l"]
    scale = 4.0 if layout == "tlmac" else 1.0    # codes over all of 0..7
    xe = jnp.abs(_x((2, E, 3, K), seed=K, scale=scale))
    jy = jax.jit(lambda p, x: jnn.serve_expert_linear_apply(p, x, jcfg))(
        jp, xe)
    ty = tnn.serve_expert_linear_apply(tp, _from_jax(xe), tcfg)
    assert ty.shape == (2, E, 3, N) and ty.dtype == torch.bfloat16
    assert torch.equal(_bits(ty), _bits(_from_jax(jy)))


def test_int8_expert_linears_are_refused_off_the_cpu():
    """Off the CPU the int8 layout's expert stack runs only on the card,
    through one launch of the int8 expert kernel: a tensor elsewhere
    (``meta`` here) is refused by the kernel's wrapper, never served by a
    launch per expert."""
    _, tcfg = F.cfgs("moe-gqa", "int8")
    tp = tnn.init_serve_linear(torch.Generator().manual_seed(0), 64, 32,
                               tcfg, device="cpu", expert=8)
    tp = {k: v.to("meta") for k, v in tp.items()}
    xe = torch.zeros((2, 8, 3, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        tnn.serve_expert_linear_apply(tp, xe, tcfg)


def test_init_serve_linear_stacks_experts():
    """``expert=E`` gives every leaf a leading E, in the reference's dtypes
    and shapes, each layout."""
    for impl in ("tlmac", "int8", "dense"):
        jcfg, tcfg = F.cfgs("moe-gqa", impl)
        jp, _ = jnn.init_serve_linear(jax.random.PRNGKey(0), 64, 32, jcfg,
                                      expert=8)
        tp = tnn.init_serve_linear(torch.Generator().manual_seed(0), 64, 32,
                                   tcfg, device="cpu", expert=8)
        assert set(tp) - {"table_narrow"} == set(jp), impl
        for k, v in jp.items():
            assert tuple(tp[k].shape) == v.shape, (impl, k)
            assert str(tp[k].dtype).replace("torch.", "") == str(v.dtype)
        if impl == "tlmac":
            # each expert drew its own plan
            assert not torch.equal(tp["exec_idx"][0], tp["exec_idx"][1])


def test_kernel1_expert_axis_plain_equals_one_call_per_expert():
    """The lookup kernel's expert axis on the CPU (its plain version):
    ``[E, M, N]`` equal to E single-linear calls and to the one-hot
    algebra; mismatched expert counts are refused."""
    gen = torch.Generator().manual_seed(1)
    E, M, K, N, dp, n_arr, G, B_a = 3, 5, 64, 24, 8, 32, 4, 3
    a = torch.randint(0, 2**B_a, (E, M, K), dtype=torch.int8, generator=gen)
    idx = torch.randint(0, n_arr, (E, N // dp, K // G, dp),
                        dtype=torch.uint8, generator=gen)
    cl = torch.randint(0, 2, (E, N // dp, K // G), dtype=torch.int8,
                       generator=gen)
    tab = tf.narrow_table(torch.randint(-8, 8, (E, 2, n_arr, 2**G),
                                        dtype=torch.int32, generator=gen))
    got = tf.tlmac_gemm_fused(a, idx, cl, tab, B_a=B_a, G=G)
    assert got.shape == (E, M, N) and got.dtype == torch.int32
    for e in range(E):
        one = tf.tlmac_gemm_fused(a[e], idx[e], cl[e], tab[e], B_a=B_a, G=G)
        assert torch.equal(got[e], one)
        assert torch.equal(got[e], tf.tlmac_gemm_onehot_plain(
            a[e], idx[e], cl[e], tab[e], B_a=B_a, G=G))
    with pytest.raises(ValueError, match="step_cluster"):
        tf.tlmac_gemm_fused(a, idx, cl[:2], tab, B_a=B_a, G=G)
    with pytest.raises(ValueError, match="table"):
        tf.tlmac_gemm_fused(a, idx, cl, tab[:2], B_a=B_a, G=G)
    with pytest.raises(ValueError, match="a_codes"):
        tf.tlmac_gemm_fused(a[0], idx, cl, tab, B_a=B_a, G=G)


# ---------------------------------------------------------------------------
# the attn_moe block through the three paged forwards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout,kv", [("tlmac", "fp"), ("tlmac", "int8"),
                                       ("int8", "fp"), ("dense", "fp")])
def test_moe_paged_forwards_bitexact_vs_jax(layout, kv):
    F.assert_forwards_match("moe-gqa", layout, kv=kv)


@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_moe_paged_forwards_bitexact_vs_jax_on_calibrated_steps(kv):
    """The three forwards with every lookup linear on calibrated steps
    (``calibrate_tlmac``): attention, the dense FFN layers, the experts,
    the shared expert and the head then carry fractional products, so a
    bf16 rounding placed where XLA does not place it moves the next
    linear's codes.  Same tolerances as above."""
    F.assert_forwards_match("moe-gqa", "tlmac", kv=kv, steps="calibrated")
