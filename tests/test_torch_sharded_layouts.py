"""The sharded dense serve path's other layouts on 4 gloo ranks against the
reference's 4-device run (``tests/_torch_sharded.py``), and one lookup
linear whose plan shards its reduction groups:

- codeqwen smoke, int8, mesh (2, 2): ``wq``/``wk``/``wv`` and the FFN's
  ``wi``/``wg`` split their columns, ``wo`` and the FFN's ``wo`` their K
  rows (``w8`` cut, then padded), the int32 partial products summed over
  'model'; calibrated steps (``_torch_families``), bit for bit with the
  reference and with the port unsharded;
- codeqwen smoke, dense bf16, mesh (2, 2): the K-sharded ``wo`` rounds each
  partial product to bf16 and sums them in f32 (the reference's
  partitioned graph, read in its compiled HLO), so the sharded run equals
  the reference's bit for bit and differs from the unsharded one as the
  reference's 4-device run differs from its one-device run: tokens
  equal, the prefill logits within ``DENSE_TOL``, the last logits and the
  caches within ``SPREAD_FACTOR`` x the reference's own 4-vs-1-device
  spread, measured in the same run (its one-device forwards fed the same
  tokens);
- minicpm-2b smoke, int8, mesh (1, 4): K and N blocks that are not
  multiples of 8 (72 / 4 = 18, 160 / 4 = 40), so each rank's ``w8`` is
  cut first and then padded (its zero rows and columns add nothing);
- a tlmac linear K 256 x N 24 (no dp gives output tiles a multiple of
  16): its ``exec_idx`` shards the reduction groups on 'model', each rank
  sums its kg slice and one int32 all-reduce assembles the product, then
  the 'model'-sharded ``w_step`` takes this rank's columns;
- ``parallel.collectives`` itself on the 4 ranks, and ``local_shard`` /
  ``convert.dense_caches_from_jax(mesh=)`` offsets on the 512-rank
  multi-pod mesh (a fake process group) against ``devices_indices_map``'s
  pod-major order.
"""

import ml_dtypes
import numpy as np
import pytest

import _torch_sharded as H

CASES = {
    "int8-2x2": dict(arch="codeqwen1.5-7b", over=dict(serve_impl="int8"),
                     mesh=(2, 2)),
    "dense-2x2": dict(arch="codeqwen1.5-7b", over=dict(serve_impl="dense"),
                      mesh=(2, 2), spread=True),
    "minicpm-int8-1x4": dict(arch="minicpm-2b", over=dict(
        serve_impl="int8"), mesh=(1, 4)),
    "linear-k256-n24": dict(arch="codeqwen1.5-7b", over={}, mesh=(2, 2),
                            linear=(256, 24)),
    "collectives": dict(mesh=(2, 2), collectives=True),
}
# the dense layout's sharded run against its unsharded one: the prefill
# logits within the reference's own 4-vs-1-device spread (0.0078); after
# 10 steps each K-sharded wo's bf16 partials have moved the stream by a
# few ulps more, so the last logits and the caches are held to twice the
# reference's own spread in this run
DENSE_TOL = 0.0078
SPREAD_FACTOR = 2
# int8 and dense a decode step (2 layers): a layer gathers q, k and v (the
# cache is sequence-sharded: every head attends over the rank's
# positions), reduces the softmax thrice and its two K-sharded products
# (wo, FFN wo) once each
# minicpm int8 on (1, 4): its wo and FFN wo are K-sharded w8 (int32 sums)
PER_STEP = {"int8-2x2": (6, 13, 0, 0), "dense-2x2": (6, 13, 0, 0),
            "minicpm-int8-1x4": (6, 13, 0, 0)}
MODEL_CASES = ["int8-2x2", "dense-2x2", "minicpm-int8-1x4"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return H.run(tmp_path_factory.mktemp("sharded_layouts"), CASES)


@pytest.mark.parametrize("name", MODEL_CASES)
def test_sharded_bit_equal_to_reference(runs, name):
    out = runs[name]
    H.assert_ranks_equal(out, out["ref"], out["meta"]["cache_blocks"])


@pytest.mark.parametrize("name", ["int8-2x2", "minicpm-int8-1x4"])
def test_int8_sharded_bit_equal_to_unsharded(runs, name):
    out = runs[name]
    H.assert_ranks_equal(out, out["plain"], out["meta"]["cache_blocks"])


def test_dense_sharded_within_the_references_own_spread(runs):
    out = runs["dense-2x2"]
    ref, plain = out["ref"], out["plain"]
    np.testing.assert_array_equal(plain["tokens"], ref["tokens"])
    spread = lambda a, b: np.abs(H.bf16(a) - H.bf16(b)).max()
    assert spread(ref["prefill_logits"], plain["prefill_logits"]) <= DENSE_TOL
    own = spread(ref["last_logits"], ref["one_last_logits"])
    assert spread(ref["last_logits"], plain["last_logits"]) <= (
        SPREAD_FACTOR * own)
    for path, leaf in H.keystr_leaves(plain["caches"]):
        own = spread(ref["cache" + path], ref["one_cache" + path])
        assert spread(ref["cache" + path], leaf) <= SPREAD_FACTOR * own, path


@pytest.mark.parametrize("name", MODEL_CASES + ["linear-k256-n24"])
def test_rank_blocks_are_reference_blocks(runs, name):
    H.assert_param_blocks(runs[name])


@pytest.mark.parametrize("name", MODEL_CASES)
def test_collectives_per_decode_step(runs, name):
    assert H.step_counts(runs[name]) == PER_STEP[name]


def test_reduction_group_linear_sums_int32_over_model(runs):
    out = runs["linear-k256-n24"]
    y = out["ref"]["y"]
    for r in out["ranks"]:
        assert r["split"]           # w_step is sharded on 'model'
        w = r["y"].shape[-1]
        np.testing.assert_array_equal(
            r["y"], y[:, r["model_index"] * w:(r["model_index"] + 1) * w])
        st = r["stats"]
        assert st.count_by_kind["all-reduce"] == 1
        assert st.bytes_by_kind["all-reduce"] == y.shape[0] * 24 * 4  # int32
        assert st.count_by_kind["all-gather"] == 0 and st.param_count == 0


def test_collectives_on_named_axes(runs):
    """Rank r = (data r // 2, model r % 2): a gather over ('data',
    'model') lands data-major, int16 moves exactly, sum/max/min and the
    reduce-scatter are over 'model' only; one count each."""
    for rank, r in enumerate(runs["collectives"]["ranks"]):
        d, m = divmod(rank, 2)
        mates = [2 * d, 2 * d + 1]
        t = [np.arange(8, dtype=np.float32) + 100 * q for q in mates]
        np.testing.assert_array_equal(r["gather"], [[0, 1, 2, 3]])
        np.testing.assert_array_equal(r["gather16"],
                                      np.repeat(np.array(mates) - 300, 2))
        np.testing.assert_array_equal(r["sum"], t[0] + t[1])
        np.testing.assert_array_equal(r["max"], t[1])
        np.testing.assert_array_equal(r["min"], t[0])
        np.testing.assert_array_equal(r["scatter"], (t[0] + t[1])[4 * m:
                                                                  4 * m + 4])
        assert r["index"] == (d, m, rank) and r["size"] == (2, 4)
        c = r["stats"].count_by_kind
        assert (c["all-gather"], c["all-reduce"], c["reduce-scatter"]) == (
            2, 3, 1)


def test_local_blocks_pod_major_on_the_production_mesh(runs):
    """On the 2x16x16 mesh (a fake 512-rank group) a rank's block of a
    ('pod', 'data') x 'model' leaf starts at ((pod * 16 + data) * rows,
    model * cols), the offsets of JAX's ``devices_indices_map`` (checked
    for these specs in ``test_torch_sharding.py``); and
    ``dense_caches_from_jax(mesh=)`` cuts the int8 case's reference caches
    into the blocks the reference's device 0..3 holds on (2, 2)."""
    import torch

    from repro_torch import convert
    from repro_torch.configs import smoke_config
    from repro_torch.launch.mesh import (fake_world, make_mesh_compat,
                                         make_production_mesh)
    from repro_torch.parallel.sharding import P, local_shard

    whole = torch.arange(1024 * 64, dtype=torch.int32).reshape(1024, 64)
    for rank in (0, 17, 300, 511):
        with fake_world(512, rank=rank):
            mesh = make_production_mesh(multi_pod=True, device_type="cpu")
            blk = local_shard(whole, P(("pod", "data"), "model"), mesh)
        pod, data, model = rank // 256, rank // 16 % 16, rank % 16
        assert blk.shape == (32, 4)
        assert torch.equal(blk, whole[(pod * 16 + data) * 32:][:32,
                                      model * 4:model * 4 + 4])
    out = runs["int8-2x2"]
    ref = out["ref"]
    tree = [{"b0": {k: ref[f"cache[0]['b0'][{k!r}]"].view(ml_dtypes.bfloat16)
                    for k in ("k", "v")}}]
    cfg = smoke_config("codeqwen1.5-7b")
    for rank in range(4):
        with fake_world(4, rank=rank):
            mesh = make_mesh_compat((2, 2), ("data", "model"), "cpu")
            local = convert.to_numpy(convert.dense_caches_from_jax(
                tree, "cpu", mesh=mesh, cfg=cfg))
        for k in ("k", "v"):
            path = f"[0]['b0'][{k!r}]"
            np.testing.assert_array_equal(local[0]["b0"][k], H.block(
                ref["cache" + path], out["meta"]["cache_blocks"][path][rank]))
