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
unsharded one bit for bit.
"""

import dataclasses
import threading

import pytest
import torch
import torch.distributed as dist

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
    hlo = out["meta"]["hlo"]
    st = H.step_stats(out)
    with capsys.disabled():
        print("\ncollectives a train step, codeqwen smoke fsdp, mesh (2, 2):"
              " kind: reference HLO count/bytes | port count/bytes (of "
              "them backward)")
        for k in hlo["count"]:
            print(f"  {k}: {hlo['count'][k]}/{hlo['bytes'][k]} | "
                  f"{st.count_by_kind[k]}/{st.bytes_by_kind[k]} "
                  f"({st.backward_count_by_kind[k]}/"
                  f"{st.backward_bytes_by_kind[k]})")
        print(f"  port parameter collectives {st.param_count}/"
              f"{st.param_bytes}")
    assert hlo["count"]["all-gather"] > 0
    assert st.count_by_kind["all-gather"] > 0


WORLD1 = {
    "codeqwen-fsdp": ("codeqwen1.5-7b", {"fsdp": True}, 1),
    "mistral-accum2-noremat": ("mistral-large-123b",
                               {"fsdp": True, "remat": "none"}, 2),
}


@pytest.mark.parametrize("name", WORLD1)
def test_one_rank_mesh_is_unsharded_step_bit_for_bit(name):
    """On a one-rank gloo mesh (1, 1) the sharded step (every collective
    issued over one rank) equals the unsharded step: the loss, every
    gradient leaf and every param after the step."""
    arch, over, accum = WORLD1[name]
    _, tcfg, p = T.model(arch, **over)
    tc = TrainConfig(accum_steps=accum, **H.TC_KW)
    step = make_train_step(tcfg, tc)
    batch = {"tokens": torch.from_numpy(T.tokens(tcfg.vocab, b=4, s=32))}
    runs = []
    for sharded in (False, True):
        mesh = make_host_mesh() if sharded else None
        try:
            with (mesh_context(mesh) if mesh else mesh_context(None)):
                params = convert.train_params_from_jax(p, "cpu", mesh=mesh,
                                                       cfg=tcfg)
                opt = adamw_init(params)
                loss, grads = step.grads(params, batch)
                params, opt, met = step(params, opt, batch, 0)
                runs.append((loss, tree_leaves(grads), met,
                             tree_leaves(params)))
        finally:
            if mesh is not None:
                dist.destroy_process_group()
    (l0, g0, m0, p0), (l1, g1, m1, p1) = runs
    assert torch.equal(l0, l1) and torch.equal(m0["loss"], m1["loss"])
    assert torch.equal(m0["gnorm"], m1["gnorm"])
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
    for a, b in zip(p0, p1):
        assert torch.equal(a, b)


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


@pytest.mark.parametrize("what", ["compress", "int8", "bf16", "xlstm",
                                  "mla", "moe", "encdec", "vlm"])
def test_out_of_scope_under_a_mesh_raises(what):
    """int8 gradient compression, int8 and bf16 moments, and every model
    but a dense GQA decoder raise under a mesh, naming the later items."""
    arch = {"xlstm": "xlstm-350m", "mla": "deepseek-v3-671b",
            "moe": "deepseek-v3-671b", "encdec": "seamless-m4t-medium",
            "vlm": "internvl2-76b"}.get(what, "codeqwen1.5-7b")
    cfg = smoke_config(arch)
    if what == "moe":
        cfg = dataclasses.replace(cfg, attn_kind="gqa")
    tc = TrainConfig(compress=what == "compress",
                     adamw=AdamWConfig(state_dtype=what if what in (
                         "int8", "bf16") else "f32"))
    step = make_train_step(cfg, tc)
    tokens = torch.zeros((2, 8), dtype=torch.int32)
    with fake_world(4):
        with mesh_context(_fake_mesh((2, 2))):
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                step({}, {}, {"tokens": tokens}, 0)
            if what not in ("compress", "int8", "bf16"):
                with pytest.raises(NotImplementedError, match="ROADMAP"):
                    lm.check_sharded_train(cfg)
                with pytest.raises(NotImplementedError, match="ROADMAP"):
                    lm.forward({}, {"tokens": tokens}, cfg)
