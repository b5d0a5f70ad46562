"""Sharded serving of the MoE and MLA decoders (``lm.prefill``/
``lm.decode_step`` under a ``(data, model)`` mesh: expert parallelism over
'model', the MLA latent cache sequence-sharded) on 4 gloo ranks against
the reference's 4-device run of the same jitted forwards, on the same
params and tokens (``tests/_torch_sharded.py``).

Cases (B 4 x 16 tokens into S_max 32, then 10 greedy steps):

- deepseek-v3 smoke, mesh (1, 4): MLA + MoE, 2 experts and 1 head a
  rank, the latent cache sequence-sharded;
- kimi-k2 smoke with ``fsdp``, mesh (2, 2), widened (d_model and d_expert
  128) so that its plans' reduction groups (kg 32) take ('pod', 'data')
  (gathered at use, the expert stacks' too) and the output tiles of every
  linear but the replicated ``wq_a``/``wkv_a`` divide 16;
- moe-gqa (the deepseek smoke with GQA attention), mesh (1, 4);
- the deepseek smoke in the int8 layout (calibrated steps, kernel 7's
  stacks) and the dense layout, mesh (2, 2).

Each rank's tokens, logits (its rows, its vocab block) and cache blocks
equal the reference's 4-device run bit for bit; its param blocks are the
reference's per-device blocks; its collectives a decode step are those of
``PER_STEP``; every rank of 'model' routes its rows alike.

Against the unsharded run: the reference's partitioned graph rounds the
combine's partial sum over each device's experts to bf16 before summing
the partials over 'model' (read in its compiled HLO), so its 4-device run
differs from its one-device run wherever a token's experts sit on two
devices: by bf16 ulps in the logits of every layout here, and in the
tokens of the int8 and dense layouts.  The port copies that rounding, so
its own sharded run differs from its unsharded run by the same amount:
the port's unsharded run, fed the sharded run's tokens, equals the
reference's one-device run fed them, bit for bit (one case a layout:
``SPREAD_CASES``).  On one rank the two paths are one
(``test_one_rank_mesh_is_unsharded_bit_for_bit``).
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_sharded as H
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.launch.mesh import (fake_world, make_host_mesh,
                                     make_mesh_compat, mesh_context)
from repro_torch.models import lm, moe, nn
from repro_torch.parallel.sharding import local_tree

KIMI_WIDE = dict(fsdp=True, d_model=128, d_expert=128)
CASES = {
    "deepseek-1x4": dict(arch="deepseek-v3-671b", over={}, mesh=(1, 4),
                         hlo=True),
    "kimi-fsdp-2x2": dict(arch="kimi-k2-1t", over=KIMI_WIDE, mesh=(2, 2)),
    "moe-gqa-1x4": dict(arch="deepseek-v3-671b", over=dict(attn_kind="gqa"),
                        mesh=(1, 4)),
    "deepseek-int8-2x2": dict(arch="deepseek-v3-671b",
                              over=dict(serve_impl="int8"), mesh=(2, 2)),
    "deepseek-dense-2x2": dict(arch="deepseek-v3-671b",
                               over=dict(serve_impl="dense"), mesh=(2, 2)),
}
MODEL_CASES = list(CASES)
# one case a layout runs the reference's forwards on one device too, fed
# the sharded run's tokens (the port's unsharded run is fed them alike)
SPREAD_CASES = ["deepseek-1x4", "deepseek-int8-2x2", "deepseek-dense-2x2"]
for _n in SPREAD_CASES:
    CASES[_n].update(spread=True, forced=True)
# a lookup linear of a MoE config whose plan shards its reduction groups on
# 'model' (no dp gives K 256 x N 24 output tiles a multiple of 16): the
# reference runs every serve linear of a MoE config through its fused
# N-tile GEMM with the scale inside, and its partitioned graph still sums
# the integer products before the scale, as the port does
CASES["moe-linear-k256-n24"] = dict(arch="deepseek-v3-671b", over={},
                                    mesh=(2, 2), linear=(256, 24))
# collectives a decode step on each rank (all-gathers, all-reduces, of them
# parameter gathers, their bytes).  Every step adds the embedding's sum and
# the greedy argmax's max and min (3 all-reduces).  A tlmac MLA layer
# gathers q_eff and q_rope over 'model' (every head's scores over the
# rank's positions), reduces the softmax's max, denominator and weighted
# latents, gathers the codes into wo (its output tiles sharded) and wo's
# output: 4 + 3.  A GQA layer with a sequence-sharded cache gathers q, k, v
# and wo's output: 4 + 3 (PR 26's).  The dense FFN, or the shared experts,
# gather the gated codes into wo and wo's output: 2; a MoE layer sums the
# combine's partials: 1 all-reduce.  In the int8 and dense layouts wo and
# the FFN's wo are K-sharded: each sums its partials (1 all-reduce), no
# gathers.
PER_STEP = {
    # 2 MLA + FFN layers (4 + 2, 3), 2 MLA + MoE layers (4 + 2, 3 + 1)
    "deepseek-1x4": (24, 17, 0, 0),
    # 1 MLA + FFN, 2 MLA + MoE layers, plus the FSDP plan gathers (kg 32 on
    # 'data'): the FFN's 3 linears x 2 leaves, and a MoE layer's 3 expert
    # stacks and 3 shared linears x 2 leaves
    "kimi-fsdp-2x2": (48, 14, 30, 248064),
    "moe-gqa-1x4": (24, 17, 0, 0),
    # MLA: q_eff, q_rope gathered, 3 softmax sums, wo's sum; FFN wo's sum;
    # MoE: the combine's and shared wo's sums
    "deepseek-int8-2x2": (8, 25, 0, 0),
    "deepseek-dense-2x2": (8, 25, 0, 0),
}
# the ranks run while the reference compiles ten programs beside them
RANK_TIMEOUT_S = 300


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return H.run(tmp_path_factory.mktemp("sharded_moe"), CASES,
                 rank_timeout=RANK_TIMEOUT_S)


@pytest.mark.parametrize("name", MODEL_CASES)
def test_sharded_bit_equal_to_reference(runs, name):
    out = runs[name]
    H.assert_ranks_equal(out, out["ref"], out["meta"]["cache_blocks"])


@pytest.mark.parametrize("name", SPREAD_CASES)
def test_sharded_against_unsharded(runs, name):
    """The port's unsharded run fed the sharded run's tokens equals the
    reference's one-device run fed them: prefill and last logits, every
    cache leaf, bit for bit (so the port's 4-vs-1 spread is the
    reference's own)."""
    out = runs[name]
    ref, plain = out["ref"], out["plain"]
    np.testing.assert_array_equal(plain["prefill_logits"],
                                  ref["one_prefill_logits"])
    np.testing.assert_array_equal(plain["last_logits"],
                                  ref["one_last_logits"])
    for path, leaf in H.keystr_leaves(plain["caches"]):
        np.testing.assert_array_equal(leaf, ref["one_cache" + path],
                                      err_msg=path)
    spread = np.abs(H.bf16(ref["last_logits"])
                    - H.bf16(ref["one_last_logits"])).max()
    print(f"\n{name}: the reference's own 4-vs-1 spread of the last "
          f"logits {spread}")


@pytest.mark.parametrize("name", CASES)
def test_rank_blocks_are_reference_blocks(runs, name):
    """Params as the reference's per-device blocks (the expert stacks'
    experts on 'model', an FSDP plan's reduction groups on 'data');
    ``lm.init_caches(..., mesh=)`` makes the (latent) cache blocks
    ``prefill`` fills."""
    H.assert_param_blocks(runs[name])
    for r in runs[name]["ranks"]:
        if "caches" in r:
            shapes = [{b: {k: v.shape for k, v in blk.items()}
                       for b, blk in seg.items()} for seg in r["caches"]]
            assert r["init_caches"] == shapes


@pytest.mark.parametrize("name", MODEL_CASES)
def test_collectives_per_decode_step(runs, name):
    assert H.step_counts(runs[name]) == PER_STEP[name]


def test_moe_linear_sums_int32_before_the_scale(runs):
    out = runs["moe-linear-k256-n24"]
    y = out["ref"]["y"]
    for r in out["ranks"]:
        assert r["split"]           # w_step is sharded on 'model'
        w = r["y"].shape[-1]
        np.testing.assert_array_equal(
            r["y"], y[:, r["model_index"] * w:(r["model_index"] + 1) * w])
        st = r["stats"]
        assert st.count_by_kind["all-reduce"] == 1
        assert st.bytes_by_kind["all-reduce"] == y.shape[0] * 24 * 4  # int32


def test_decode_collectives_beside_reference_hlo(runs, capsys):
    """The deepseek smoke's decode step on (1, 4): the reference's compiled
    HLO (``hlo_analysis.parse_collectives``, ops in the layer loop counted
    once) beside the port's count on rank 0 (printed with ``-s``).  GSPMD
    keeps the stream's d sharded over 'model' and gathers the fused lookup
    GEMM's f32 tiles; the port keeps the stream whole and gathers codes."""
    out = runs["deepseek-1x4"]
    hlo = out["meta"]["hlo"]
    st = out["ranks"][0]["stats"][-1]
    with capsys.disabled():
        print("\ncollectives a decode step, deepseek-v3 smoke, mesh (1, 4): "
              "kind: reference HLO count/bytes | port count/bytes")
        for k in hlo["count"]:
            print(f"  {k}: {hlo['count'][k]}/{hlo['bytes'][k]} | "
                  f"{st.count_by_kind[k]}/{st.bytes_by_kind[k]}")
    assert hlo["count"]["all-reduce"] > 0 and hlo["count"]["all-gather"] > 0
    assert st.param_count == 0


def test_dense_caches_from_jax_cut_the_latent_caches(runs):
    """``convert.dense_caches_from_jax(mesh=)`` cuts the reference's whole
    MLA latent caches (``ckv``/``kr`` ``P(b, 'model', None)``) into the
    blocks its devices 0..3 hold on (1, 4), which are the blocks the port's
    ranks filled."""
    import ml_dtypes

    out = runs["deepseek-1x4"]
    ref, blocks = out["ref"], out["meta"]["cache_blocks"]
    cfg = smoke_config("deepseek-v3-671b")
    tree = [{"b0": {k: ref[f"cache[{si}]['b0'][{k!r}]"].view(
        ml_dtypes.bfloat16) for k in ("ckv", "kr")}} for si in range(2)]
    for rank in range(4):
        with fake_world(4, rank=rank):
            mesh = make_mesh_compat((1, 4), ("data", "model"), "cpu")
            local = convert.to_numpy(convert.dense_caches_from_jax(
                tree, "cpu", mesh=mesh, cfg=cfg))
        for si in range(2):
            for k in ("ckv", "kr"):
                path = f"[{si}]['b0'][{k!r}]"
                want = H.block(ref["cache" + path], blocks[path][rank])
                np.testing.assert_array_equal(local[si]["b0"][k], want)
                np.testing.assert_array_equal(
                    out["ranks"][rank]["caches"][si]["b0"][k], want)


@pytest.mark.parametrize("name", MODEL_CASES)
def test_route_is_the_same_on_every_rank_of_model(runs, name):
    """The router is replicated: ranks holding the same batch rows (the
    same 'data' index) route them alike at every MoE call, whatever
    experts they hold."""
    ranks = runs[name]["ranks"]
    by_rows = {}
    for r in ranks:
        by_rows.setdefault(tuple(r["rows"]), []).append(r["routes"])
    assert len(by_rows) == runs[name]["case"]["mesh"][0]
    for routes in by_rows.values():
        assert len(routes) == runs[name]["case"]["mesh"][1]
        for other in routes[1:]:
            assert len(other) == len(routes[0]) > 0
            for (e0, g0), (e1, g1) in zip(routes[0], other):
                np.testing.assert_array_equal(e0, e1)
                np.testing.assert_array_equal(g0, g1)


ONE_RANK = {
    "deepseek": ("deepseek-v3-671b", {}),
    "kimi-fsdp": ("kimi-k2-1t", KIMI_WIDE),
    "moe-gqa-int8": ("deepseek-v3-671b", dict(attn_kind="gqa",
                                              serve_impl="int8")),
}


@pytest.mark.parametrize("name", ONE_RANK)
def test_one_rank_mesh_is_unsharded_bit_for_bit(name):
    """On a one-rank gloo mesh (1, 1) the sharded MoE and MLA forwards
    (every collective issued over one rank, the combine's partial the whole
    sum) equal the unsharded ones bit for bit: prefill and 4 greedy
    steps' tokens, logits and caches."""
    arch, over = ONE_RANK[name]
    cfg = dataclasses.replace(smoke_config(arch), **over)
    whole = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab, (4, 12),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    runs = []
    for sharded in (False, True):
        mesh = make_host_mesh() if sharded else None
        try:
            with mesh_context(mesh):
                params = whole if mesh is None else nn.ParamTree(local_tree(
                    whole.tree(), lm.param_axes(cfg), mesh))
                logits, caches = lm.prefill(params, tokens, cfg, S_max=16)
                outs = [logits]
                for i in range(4):
                    t = lm.greedy(logits)
                    logits, caches = lm.decode_step(
                        params, caches, t[:, None].to(torch.int32), 12 + i,
                        cfg)
                    outs.append(logits)
                runs.append((outs, convert.to_numpy(caches)))
        finally:
            if mesh is not None:
                dist.destroy_process_group()
    (o0, c0), (o1, c1) = runs
    for a, b in zip(o0, o1):
        assert torch.equal(a[..., :cfg.vocab], b[..., :cfg.vocab])
    for (p, a), (_, b) in zip(H.keystr_leaves(c0), H.keystr_leaves(c1)):
        np.testing.assert_array_equal(a, b, err_msg=p)


def test_experts_that_do_not_divide_model_are_refused():
    """6 experts over a 'model' of 4: the param blocks are refused as an
    uneven dim is (``local_shard``), and so is the MoE forward's expert
    block (``moe.local_experts``)."""
    cfg = dataclasses.replace(smoke_config("deepseek-v3-671b"), n_experts=6)
    whole = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    with fake_world(4):
        mesh = make_mesh_compat((1, 4), ("data", "model"), "cpu")
        with pytest.raises(ValueError, match="does not divide"):
            convert.params_from_jax(convert.to_numpy(whole), "cpu",
                                    mesh=mesh, cfg=cfg)
        with mesh_context(mesh):
            moe_p = whole.layers(1)[0]["b0"]["moe"]
            with pytest.raises(ValueError, match="do not divide"):
                moe.local_experts(moe_p, cfg)
