"""The paged families of ``tests/test_serve_oracle.py`` that the port
adds (minicpm: tied head, odd vocab 257; command-r: rep 4; the internvl2
VLM backbone with its ``front`` leaf; a sliding-window ``attn_local``
family) against the JAX package, on params from ``lm.init_lm(PRNGKey(0),
cfg, purpose='serve')`` converted by ``convert.params_from_jax``.

- Configs, segments, ``supports_paged`` and the param trees (structure,
  dtypes, every bit through the converter) equal the reference's.
- The three paged forwards (two prompts chunked into pages, a decode
  step, a verify window) under the TLMAC layout and the mixed layout
  (lookup attention, int8 FFN): every pool page bit-equal to JAX's, and
  every row of logits but at most one bit-equal, that one off by a bf16
  ulp in a few logits (``HEAD_ULP_SHARE``: the vocab head's f32 sums run
  in another order); the flash reader within ``FLASH_LOGIT_TOL`` of
  JAX's gathered one.  The window family runs at ``local_window`` 8, so
  its prompt of 19 and the verify rows past it read keys inside and
  outside the window.  The int8 and dense layouts are in
  ``test_torch_layouts.py``.
"""

import dataclasses

import numpy as np
import pytest

import jax
import torch

from repro.configs import get_config as jget
from repro.configs import smoke_config as jsmoke
from repro.models import lm as jlm

from repro_torch import convert
from repro_torch.configs import get_config, smoke_config as tsmoke
from repro_torch.models import lm as tlm

import _torch_families as F

ARCHS = ["minicpm-2b", "command-r-35b", "internvl2-76b", "recurrentgemma-2b",
         "xlstm-350m", "seamless-m4t-medium"]
READ_FIELDS = ["name", "family", "n_layers", "d_model", "n_heads", "n_kv",
               "d_ff", "vocab", "head_dim", "act", "tie_embeddings",
               "qkv_bias", "tlmac_G", "tlmac_dp", "tlmac_narr_cap",
               "serve_impl", "serve_kv_dtype", "serve_shared_act_quant",
               "attn_kind", "local_window", "block_pattern", "n_enc_layers",
               "frontend", "frontend_len", "conv_width", "lru_dim"]
WINDOW = dict(local_window=8)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for j, t in ((jsmoke(arch), tsmoke(arch)), (jget(arch), get_config(arch))):
        for f in READ_FIELDS:
            assert getattr(j, f) == getattr(t, f), (arch, f)
        assert (j.quant.w_bits, j.quant.a_bits) == (t.quant.w_bits,
                                                    t.quant.a_bits)
        assert j.kv_head_dim == t.kv_head_dim


def test_configs_refuse_what_is_not_ported():
    """MLA configs build MLA blocks in the reference's segments and do
    not page, as in the reference; an unknown ``attn_kind`` is refused
    where a block would be built.  Nothing else is refused any more: the
    ``ssm``, ``audio`` and ``hybrid`` (RG-LRU) families and encoder
    layers give the reference's segments and ``supports_paged`` and
    build their params."""
    base = tsmoke("codeqwen1.5-7b")
    jbase = jsmoke("codeqwen1.5-7b")
    mla = dataclasses.replace(base, attn_kind="mla")
    assert not tlm.supports_paged(mla)
    assert [(s.pattern, s.n) for s in tlm.segments_for(mla)] == [
        (s.pattern, s.n) for s in jlm.segments_for(
            dataclasses.replace(jbase, attn_kind="mla"))]
    p = tlm.init_lm(mla, torch.Generator().manual_seed(0), device="cpu")
    assert set(p.tree()["segments"][0]["b0"]["attn"]) == {
        "wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo"}
    odd = dataclasses.replace(base, attn_kind="linear")
    with pytest.raises(ValueError, match="attn_kind"):
        tlm.segments_for(odd)
    with pytest.raises(ValueError, match="attn_kind"):
        tlm.init_lm(odd, torch.Generator().manual_seed(0), device="cpu")
    cases = [dict(family="ssm", attn_kind="none"), dict(family="audio"),
             dict(family="hybrid"), dict(n_enc_layers=2, family="audio",
                                         frontend="frames")]
    for over in cases:
        for L in (5, 8, 11):
            t = dataclasses.replace(base, n_layers=L, **over)
            j = dataclasses.replace(jbase, n_layers=L, **over)
            assert [(s.pattern, s.n) for s in tlm.segments_for(t)] == [
                (s.pattern, s.n) for s in jlm.segments_for(j)], (over, L)
            assert tlm.supports_paged(t) == jlm.supports_paged(j), over
    for over in cases:
        t = dataclasses.replace(base, n_layers=11, **over)
        tree = tlm.init_lm(t, torch.Generator().manual_seed(0),
                           device="cpu").tree()
        assert ("encoder" in tree) == bool(t.n_enc_layers), over


@pytest.mark.parametrize("family", sorted(F.FAMILIES))
@pytest.mark.parametrize("n_layers", [2, 5])
def test_segments_and_paging_match_reference(family, n_layers):
    jcfg, tcfg = F.cfgs(family, n_layers=n_layers,
                        block_pattern=("attn_local", "attn")
                        if family == "window-local" else ())
    assert [(s.pattern, s.n) for s in tlm.segments_for(tcfg)] == [
        (s.pattern, s.n) for s in jlm.segments_for(jcfg)]
    assert tlm.supports_paged(tcfg) and jlm.supports_paged(jcfg)


@pytest.mark.parametrize("family", F.NEW_FAMILIES)
@pytest.mark.parametrize("layout", F.LAYOUTS)
def test_converted_trees_keep_every_bit_and_match_init_lm(family, layout):
    """``params_from_jax`` mirrors each leaf (tlmac plans, ``w8``/steps,
    bf16 ``w``, mixed trees and the VLM ``front`` leaf) bit for bit, and
    the port's own ``init_lm`` builds the same structure, shapes and
    dtypes (embeddings stored bf16 by design)."""
    jcfg, tcfg, params, tp = F.model(family, layout)
    tree = tp.tree()
    init_cfg = tcfg if layout != "mixed" else dataclasses.replace(
        tcfg, serve_impl="tlmac")
    init = tlm.init_lm(init_cfg, torch.Generator().manual_seed(0),
                       device="cpu").tree()
    if layout == "mixed":     # the port draws one layout per tree
        init = tree
    assert ("front" in tree) == (jcfg.frontend != "none")
    assert ("head" in tree) == (not jcfg.tie_embeddings)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        t, i = tree, init
        for k in keys:
            t, i = t[k], i[k]
        a = np.asarray(leaf)
        if keys[0] in ("embed", "head"):
            a = np.asarray(jax.numpy.asarray(a).astype(jax.numpy.bfloat16))
        want = convert.to_torch(a, "cpu")
        assert t.dtype == want.dtype == i.dtype, keys
        assert tuple(t.shape) == a.shape == tuple(i.shape), keys
        if t.dtype == torch.bfloat16:
            t, want = t.view(torch.int16), want.view(torch.int16)
        assert torch.equal(t, want), keys


def test_tied_head_never_emits_a_padded_row():
    """minicpm's 257-token vocab pads the tied embedding to 272 rows: the
    logits are sliced to 257 and the padded rows, even made the largest,
    never win the argmax."""
    _, tcfg, params, _ = F.model("minicpm-gqa")
    tp = convert.params_from_jax(jax.tree.map(np.asarray, params),
                                 device="cpu")
    assert "head" not in tp.tree()
    assert tp.embed.emb.shape[0] == 272 and tcfg.vocab == 257
    with torch.no_grad():
        tp.embed.emb[257:] = 10.0
    caches = tlm.init_caches(tcfg, F.tpaged_spec(), device="cpu")
    bt = torch.zeros((2, F.tpaged_spec().max_blocks), dtype=torch.int32)
    bt[0, 0] = 1
    lg, _ = tlm.decode_step_paged(
        tp, caches, torch.tensor([[3], [0]], dtype=torch.int32),
        torch.tensor([0, 0], dtype=torch.int32), bt, tcfg)
    assert lg.shape == (2, 257)
    assert int(lg.argmax(-1).max()) < 257


@pytest.mark.parametrize("family", F.NEW_FAMILIES)
@pytest.mark.parametrize("layout", ["tlmac", "mixed"])
def test_paged_forwards_bitexact_vs_jax(family, layout):
    kw = WINDOW if family == "window-local" else {}
    F.assert_forwards_match(family, layout, **kw)


@pytest.mark.parametrize("family", ["window-local", "command-r-gqa-r4"])
def test_paged_forwards_bitexact_vs_jax_int8_pool(family):
    kw = WINDOW if family == "window-local" else {}
    F.assert_forwards_match(family, "tlmac", kv="int8", **kw)


def test_window_masks_keys_outside_it():
    """The window family's decode reads only its last ``local_window``
    keys: changing a key outside the window changes nothing, a key inside
    it changes the logits (both readers)."""
    _, tcfg, _, tp = F.model("window-local", **WINDOW)
    spec = F.tpaged_spec()
    caches = tlm.init_caches(tcfg, spec, device="cpu")
    rng = np.random.default_rng(3)
    for name, leaf in caches[0]["b0"].items():
        leaf.copy_(torch.from_numpy(rng.standard_normal(leaf.shape)).to(
            leaf.dtype))
    bt = torch.zeros((2, spec.max_blocks), dtype=torch.int32)
    bt[0, :3] = torch.tensor([1, 2, 3])
    pos = torch.tensor([20, 0], dtype=torch.int32)  # window: 13..20
    cur = torch.tensor([[5], [0]], dtype=torch.int32)

    def step(mutate, impl):
        c = [{b: {n: t.clone() for n, t in p.items()} for b, p in s.items()}
             for s in caches]
        mutate(c[0]["b0"])
        cfg = dataclasses.replace(tcfg, serve_paged_attn_impl=impl)
        return tlm.decode_step_paged(tp, c, cur, pos, bt, cfg)[0][0]

    def at(p):        # position p of slot 0: page bt[0, p // 8], row p % 8
        return lambda pool: pool["k"][:, int(bt[0, p // 8]), p % 8].mul_(-3)

    for impl in ("lax", "flash"):
        base = step(lambda pool: None, impl)
        assert torch.equal(step(at(12), impl), base), impl
        assert not torch.equal(step(at(13), impl), base), impl
