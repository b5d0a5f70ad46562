"""The sharded QAT train step (``make_train_step`` under a ``(data, model)``
mesh, on this rank's param and moment blocks and batch rows) on 4 gloo
ranks against the reference's 4-device step: ``make_train_step`` jitted
with its specs' shardings, as ``launch/dryrun.py::_lower_train`` jits it
(``tests/_torch_sharded_train.py``).  Tensor, sequence, vocab and FSDP
parallelism.

Cases (B 4 x 32 tokens, one AdamW step, params from the reference's
calibrated train init):

- codeqwen1.5-7b smoke with ``fsdp``, mesh (2, 2): TP and SP on 'model',
  FSDP of the linears' reduction dim on 'data', QKV bias, the
  vocab-parallel embedding, logits and loss, remat;
- command-r-35b smoke, mesh (1, 4): 2 KV heads over 4 'model' ranks, so
  k and v are gathered over 'model' and each rank reads its heads' group;
- mistral-large-123b smoke with ``fsdp`` and two accumulation
  microbatches, mesh (2, 2).

What holds, on every rank: the loss (the global one) the same on every
rank and within ``LOSS_RTOL`` of the reference's; the norm the f64 norm
of the gathered gradient and within twice the reference's own
4-vs-1-device spread of its norm (``hold_loss_and_norm``); every
gradient leaf, gathered from the ranks' blocks, within PR 23's
tolerances of the port's unsharded step, and against the reference's
4-device step within them or, on a leaf where the reference's own two
partitionings already differ by more (N2UQ codes that flip on a
rounding), within twice that (``hold_grads``); the update likewise
(``hold_updates``); each rank's param and moment blocks are the
reference's per-device blocks; the only parameter collectives are the
FSDP gathers the specs imply.  On a one-rank mesh the sharded step is the
unsharded one bit for bit (the MoE and MLA decoders too, with int8 and
bf16 moments and compression).  Pieces of the MoE step on 4 ranks:
compression under a mesh is the global leaf's, an expert stack's
``w_step`` is gathered whole at use; an int8 moment is decided on the
global shape.  What no reference config trains raises under a mesh (the
recurrent, enc-dec and VLM families are
``test_torch_sharded_train_recurrent.py``'s and
``test_torch_sharded_train_encdec.py``'s).
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_ranks
import _torch_sharded_train as H
import _torch_train as T

from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.launch.comm_analysis import record_collectives
from repro_torch.launch.mesh import (fake_world, make_host_mesh,
                                     make_mesh_compat, mesh_context)
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamWConfig, adamw_init, tree_leaves
from repro_torch.train.trainer import TrainConfig, make_train_step

CASES = {
    "codeqwen-fsdp-2x2": dict(arch="codeqwen1.5-7b", over={"fsdp": True},
                              mesh=(2, 2), accum=1, hlo=True),
    "command-r-1x4": dict(arch="command-r-35b", over={}, mesh=(1, 4),
                          accum=1),
    "mistral-fsdp-accum2-2x2": dict(arch="mistral-large-123b",
                                    over={"fsdp": True}, mesh=(2, 2),
                                    accum=2),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return H.run(tmp_path_factory.mktemp("sharded_train"), CASES)


@pytest.mark.parametrize("name", CASES)
def test_loss_and_norm_match_reference(runs, name):
    H.hold_loss_and_norm(runs[name])


@pytest.mark.parametrize("name", CASES)
def test_grads_match_reference_and_unsharded(runs, name):
    out = runs[name]
    got = H.assemble(out, "grads")
    H.hold_grads(out["plain"]["grads"], got)
    H.hold_grads(H.ref_grads(out), got, spread=H.ref_grads(out, "g1"))


@pytest.mark.parametrize("name", CASES)
def test_update_matches_reference(runs, name):
    H.hold_updates(runs[name])


@pytest.mark.parametrize("name", CASES)
def test_rank_blocks_are_reference_blocks(runs, name):
    H.check_blocks(runs[name])


@pytest.mark.parametrize("name", CASES)
def test_only_fsdp_gathers_move_params(runs, name):
    """Collectives a step on every rank (forward, remat recompute and
    backward): the parameter ones are exactly the FSDP gathers of the
    specs and their reduce-scatters; the backward's are counted."""
    out = runs[name]
    st = H.step_stats(out)
    cfg = dataclasses.replace(smoke_config(out["case"]["arch"]),
                              **out["case"]["over"])
    n = H.fsdp_gathers(cfg, out["case"]["mesh"], cfg.remat == "layer")
    assert st.param_count == n * out["case"]["accum"]
    assert st.count_by_kind["all-to-all"] == 0
    assert st.backward_count_by_kind["reduce-scatter"] > 0
    assert st.backward_count_by_kind["all-gather"] > 0


def test_train_collectives_beside_reference_hlo(runs, capsys):
    """The codeqwen smoke's step on (2, 2): the reference's compiled HLO
    (``parse_collectives``, the layer loop counted twice) beside the
    port's count on rank 0 (printed with ``-s``).  XLA on the CPU
    reshards through all-to-alls; the port issues Megatron-style
    gathers and reduce-scatters."""
    out = runs["codeqwen-fsdp-2x2"]
    H.print_collectives(out, "codeqwen smoke fsdp, mesh (2, 2)", capsys)
    st = H.step_stats(out)
    assert out["meta"]["hlo"]["count"]["all-gather"] > 0
    assert st.count_by_kind["all-gather"] > 0


MOE_WIDE = dict(d_model=256, d_ff=512, d_expert=64, fsdp=True)
# name: (arch, config overrides, accum_steps, moments' dtype, compress)
WORLD1 = {
    "codeqwen-fsdp": ("codeqwen1.5-7b", {"fsdp": True}, 1, "f32", False),
    "mistral-accum2-noremat": ("mistral-large-123b",
                               {"fsdp": True, "remat": "none"}, 2, "f32",
                               False),
    "deepseek-f32": ("deepseek-v3-671b", {}, 1, "f32", False),
    "deepseek-int8-fsdp-accum2": ("deepseek-v3-671b", MOE_WIDE, 2, "int8",
                                  False),
    "kimi-bf16": ("kimi-k2-1t", {}, 1, "bf16", False),
    "moe-gqa-compress": ("deepseek-v3-671b", {"attn_kind": "gqa"}, 1, "f32",
                         True),
}


@pytest.mark.parametrize("name", WORLD1)
def test_one_rank_mesh_is_unsharded_step_bit_for_bit(name):
    """On a one-rank gloo mesh (1, 1) the sharded step (every collective
    issued over one rank) equals the unsharded step: the loss, the norm,
    every gradient leaf, every param and every moment leaf after the step
    (the compression's uniforms drawn from one seed in both)."""
    arch, over, accum, dtype, compress = WORLD1[name]
    H.hold_world1(arch, over, accum, dtype=dtype, compress=compress)


def test_backward_on_another_thread_sees_the_mesh():
    """On the card autograd runs the backward, and the remat recompute
    inside it, on its own device thread: taken on another thread, the
    sharded gradient equals the one taken on the forward's thread, and
    its collectives are counted."""
    _, tcfg, p = T.model("codeqwen1.5-7b", fsdp=True)
    batch = {"tokens": torch.from_numpy(T.tokens(tcfg.vocab, b=4, s=32))}
    mesh = make_host_mesh()
    out = {}
    try:
        with mesh_context(mesh):
            params = convert.train_params_from_jax(p, "cpu", mesh=mesh,
                                                   cfg=tcfg)
            leaves = tree_leaves(params)
            same = torch.autograd.grad(lm.forward(params, batch, tcfg)[0],
                                       leaves)
            loss = lm.forward(params, batch, tcfg)[0]
            with record_collectives() as st:
                t = threading.Thread(target=lambda: out.update(
                    g=torch.autograd.grad(loss, leaves)))
                t.start()
                t.join()
    finally:
        dist.destroy_process_group()
    assert len(out["g"]) == len(same)
    for a, b in zip(same, out["g"]):
        assert torch.equal(a, b)
    assert st.backward_count_by_kind["reduce-scatter"] > 0
    assert st.param_count > 0     # the recompute's FSDP gathers


def _fake_mesh(shape):
    return make_mesh_compat(shape, ("data", "model"), "cpu")


def test_sequence_that_does_not_divide_is_refused():
    """The layer boundary is sequence-sharded on 'model': a sequence that
    does not divide over it is refused (the reference's GSPMD pads it)."""
    cfg = smoke_config("codeqwen1.5-7b")
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), "train",
                        device="cpu")
    with fake_world(4):
        mesh = _fake_mesh((1, 4))
        with mesh_context(mesh):
            local = convert.train_params_from_jax(
                convert.to_numpy(params), "cpu", mesh=mesh, cfg=cfg)
            with pytest.raises(ValueError, match="does not divide"):
                lm.forward(local, {"tokens": torch.zeros((1, 30),
                                                         dtype=torch.int32)},
                           cfg)


# what: (arch, config overrides, the refusal's words)
REFUSED = {
    "moe-pure-fsdp": ("deepseek-v3-671b", {"attn_kind": "gqa",
                                           "pure_fsdp": True}, "ROADMAP"),
    "recurrent-pure-fsdp": ("recurrentgemma-2b", {"pure_fsdp": True},
                            "no reference config"),
    "mlstm-heads-on-model": ("xlstm-350m", {"n_heads": 16},
                             "no reference config"),
}


@pytest.mark.parametrize("what", REFUSED)
def test_what_no_reference_config_trains_raises_under_a_mesh(what):
    """Under a mesh the train step refuses what no reference config
    trains: a MoE FFN under ``pure_fsdp`` (its experts would be parallel
    over 'model', which ``pure_fsdp`` gives the batch), a recurrent block
    under ``pure_fsdp`` (its plain leaves are cut on 'model'), an mLSTM
    whose heads divide the 'model' axis (the state's ``h_ok`` layout)."""
    arch, over, words = REFUSED[what]
    cfg = dataclasses.replace(smoke_config(arch), **over)
    step = make_train_step(cfg, TrainConfig())
    tokens = torch.zeros((2, 8), dtype=torch.int32)
    with fake_world(4):
        with mesh_context(_fake_mesh((2, 2))):
            with pytest.raises(NotImplementedError, match=words):
                step({}, {}, {"tokens": tokens}, 0)
            with pytest.raises(NotImplementedError, match=words):
                lm.check_sharded_train(cfg)
            with pytest.raises(NotImplementedError, match=words):
                lm.forward({}, {"tokens": tokens}, cfg)


@pytest.fixture(scope="module")
def pieces(tmp_path_factory):
    return _torch_ranks.spawn_ranks(_torch_ranks.train_pieces_rank, 4,
                                    tmp_path_factory.mktemp("pieces"))


ROUTES = [("table", "local"), ("experts", "local"), ("columns", "reduce"),
          ("long", "reduce")]


@pytest.mark.parametrize("leaf, route", ROUTES)
def test_compression_under_a_mesh_is_the_global_leafs(pieces, leaf, route):
    """int8 compression of a gradient block under a (2, 2) mesh is this
    rank's block of the unsharded compression of the global leaf with the
    same uniforms: in place where the rank's elements are runs of whole
    1024-blocks (rows of the table; an expert stack cut on its experts and
    its rows), else with each block's absmax all-reduced over the leaf's
    axes (a leaf cut on both axes into runs of 24; rows of 2500)."""
    for r in pieces:
        got, want, how = r["compress"][leaf]
        assert how == route
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("leaf", [leaf for leaf, _ in ROUTES])
def test_drawn_compression_under_a_mesh_is_the_global_leafs(pieces, leaf):
    """The same with the uniforms drawn from one seed, a chunk at a time
    (``compress.CHUNK`` set to 4096): each rank keeps its elements of the
    global draw, so its block is the unsharded compression's, bit for
    bit."""
    for r in pieces:
        got, want = r["drawn"][leaf]
        np.testing.assert_array_equal(got, want)


def test_expert_stack_step_is_gathered_whole_at_use(pieces):
    """An expert stack's train linear on this rank's experts (2 of 4)
    reads its ``w_step`` (P('model'), one step a column over every expert)
    whole, gathered over 'model' as a parameter collective, and LSQ's
    element count is the whole stack's."""
    for r in pieces:
        ws = r["w_step"]
        np.testing.assert_array_equal(ws["used"], ws["whole"])
        assert ws["numel"] == ws["whole_numel"] and ws["params"] == 1


def test_deepseek_v3_compression_routes():
    """deepseek-v3-671b's train leaves (meta tensors) on its production
    (16, 16) mesh, by compression route (rank 0's blocks under a fake
    world of 256: no collective runs): 69 leaves, 657.8 B elements,
    compressed in place, 19, 13.2 B, with each block's absmax reduced.
    The largest leaf of each route and rank 0's block of it are what
    ``PERF.md`` reckons the compression's memory a rank from: every rank
    holds a few f32 copies of its block, its uniforms and one chunk of
    the global draw, and on the reduce route a float a global block."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.parallel.sharding import local_shard, spec_of
    from repro_torch.train.compress import CHUNK, compress_route

    cfg = get_config("deepseek-v3-671b")
    tree = lm.init_tree(cfg, torch.Generator(), "train", "meta")
    routes = {}
    with fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        with mesh_context(mesh):
            for leaf in tree_leaves(tree):
                block = local_shard(leaf, spec_of(leaf), mesh)
                routes.setdefault(compress_route(block), []).append(
                    (leaf.numel(), block.numel(), tuple(leaf.shape)))
    count = {r: (len(v), sum(n for n, _, _ in v)) for r, v in routes.items()}
    assert count == {"local": (69, 657_819_451_376),
                     "reduce": (19, 13_212_461_056)}, count
    big = {r: max(v) for r, v in routes.items()}
    assert big["local"] == (58 * 256 * 7168 * 2048, 58 * 16 * 448 * 2048,
                            (58, 256, 7168, 2048))          # moe.wi
    assert big["reduce"] == (58 * 16384 * 7168, 58 * 1024 * 448,
                             (58, 16384, 7168))            # attn.wo
    assert CHUNK == 1 << 24


def test_int8_moment_decision_reads_the_global_shape():
    """Whether a moment is int8 blocks is decided on the param's global
    shape: a [64, 512] param cut to [64, 128] on 'model' (1, 4) gets an int8
    moment, replicated whole ([64, 2, 256]: 512 / 256 blocks do not divide
    4 ranks), where its local block (last dim 128) would stay f32; a [64,
    1024] one keeps its block dim sharded ([64, 1, 256] a rank)."""
    from repro_torch.parallel.sharding import P, with_spec

    with fake_world(4):
        with mesh_context(_fake_mesh((1, 4))):
            params = {"a": with_spec(torch.zeros(64, 128), P(None, "model")),
                      "b": with_spec(torch.zeros(64, 256), P(None, "model"))}
            opt = adamw_init(params, AdamWConfig(state_dtype="int8"))
    assert opt["m"]["a"]["q"].shape == (64, 2, 256)
    assert opt["v"]["a"]["scale"].shape == (64, 2)
    assert opt["m"]["b"]["q"].shape == (64, 1, 256)
