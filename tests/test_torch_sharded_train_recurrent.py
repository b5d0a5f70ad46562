"""The sharded QAT train step of the recurrent families (``make_train_step``
under a ``(data, model)`` mesh: the RG-LRU on each rank's lru channels and
the xLSTM cells in the serve path's layout, each over the whole sequence
of the rank's rows, under autograd and remat) on 4 gloo ranks against
the reference's 4-device step (``tests/_torch_sharded_train.py``).

Cases (B 4 x 32 tokens, one AdamW step, params from the reference's
calibrated train init):

- recurrentgemma-2b smoke with a 16-token window, mesh (1, 4): two
  query heads and one KV head over four 'model' ranks, so every rank runs
  every head of the windowed attention (past the window at S 32) and its
  rows of ``wo``; 16 lru channels a rank;
- xlstm-350m smoke, mesh (2, 2): the mLSTM's ``C`` on each rank's value
  rows, the sLSTM's state on its block of ``d``, ``h`` gathered each step.

Each holds what ``test_torch_sharded_train.py``'s cases hold, within the
recurrent train tolerances (cosine 0.999, 6%:
``test_torch_train_recurrent.py``) or twice the reference's own 4-vs-1
spread: the loss and the norm, every gradient leaf against the reference
and the port's unsharded step, the update, the moments after the step,
each rank's param and moment blocks.
The recurrentgemma step's collectives are printed beside the reference's
compiled train HLO, and on a one-rank mesh each family's step is the
unsharded one bit for bit.
"""

import pytest

import _torch_sharded_train as H

# the recurrent families' gradient tolerances of their unsharded train
# tests (``test_torch_train_recurrent.py::RG_COS``, ``RG_REL``)
REC_COS, REC_REL = 0.999, 6e-2
CASES = {
    "recurrentgemma-window16-1x4": dict(
        arch="recurrentgemma-2b", over={"local_window": 16}, mesh=(1, 4),
        accum=1, hlo=True, captured=True),
    "xlstm-2x2": dict(arch="xlstm-350m", over={}, mesh=(2, 2), accum=1,
                      captured=True),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return H.run(tmp_path_factory.mktemp("sharded_train_recurrent"), CASES)


@pytest.mark.parametrize("name", CASES)
def test_loss_and_norm_match_reference(runs, name):
    H.hold_loss_and_norm(runs[name])


@pytest.mark.parametrize("name", CASES)
def test_grads_match_reference_and_unsharded(runs, name):
    out = runs[name]
    got = H.assemble(out, "grads")
    r4, r1 = H.ref_grads(out), H.ref_grads(out, "g1")
    H.hold_grads(out["plain"]["grads"], got, spread=r1, spread_of=r4,
                 cos=REC_COS, rel=REC_REL)
    H.hold_grads(r4, got, spread=r1, cos=REC_COS, rel=REC_REL)


@pytest.mark.parametrize("name", CASES)
def test_update_matches_reference(runs, name):
    H.hold_updates(runs[name], own_spread=True)


@pytest.mark.parametrize("name", CASES)
def test_rank_blocks_are_reference_blocks(runs, name):
    H.check_blocks(runs[name])


@pytest.mark.parametrize("name", CASES)
def test_moments_match_reference(runs, name):
    H.check_moments(runs[name], own_spread=True)


def test_collectives_beside_reference_hlo(runs, capsys):
    """The recurrentgemma smoke's step on (1, 4): the reference's compiled
    HLO beside the port's count on rank 0 (printed with ``-s``).  No leaf
    is FSDP-sharded, so the port moves no parameter; the gates' f32
    partials are all-reduced over 'model' in the forward and again in the
    remat recompute."""
    out = runs["recurrentgemma-window16-1x4"]
    H.print_collectives(out, "recurrentgemma smoke, window 16, mesh (1, 4)",
                        capsys)
    st = H.step_stats(out)
    assert st.param_count == 0
    assert st.count_by_kind["all-to-all"] == 0
    assert st.count_by_kind["all-reduce"] > 0
    assert st.backward_count_by_kind["reduce-scatter"] > 0


# name: (arch, config overrides, accum_steps, the batch's other entries)
WORLD1 = {"recurrentgemma-window16-accum2": (
              "recurrentgemma-2b", {"local_window": 16}, 2, {}),
          "xlstm": ("xlstm-350m", {}, 1, {})}


@pytest.mark.parametrize("name", WORLD1)
def test_one_rank_mesh_is_unsharded_step_bit_for_bit(name):
    """On a one-rank gloo mesh (1, 1) the sharded step (every collective
    issued over one rank) equals the unsharded step: the loss, the norm,
    every gradient leaf, every param and every moment leaf after the
    step."""
    H.hold_world1(*WORLD1[name])
