"""The sharded QAT train step of the enc-dec and VLM families
(``make_train_step`` under a ``(data, model)`` mesh: the encoder
sequence-sharded and its output gathered once for every decoder block's
cross K/V, a VLM's front rows before the tokens in the sequence cut over
'model') on 4 gloo ranks against the reference's 4-device step
(``tests/_torch_sharded_train.py``).

Cases (B 4 x 32 tokens, one AdamW step, params from the reference's
calibrated train init):

- seamless-m4t-medium smoke, mesh (1, 4), 16 frames: one head and one KV
  head a rank, the encoder's 16 frames and the decoder's 32 tokens each
  cut 4 ways;
- internvl2-76b smoke with ``fsdp``, mesh (2, 2), its 8-row front: the
  front weight cut over 'data', gathered at use and its product's
  reduction cut over 'model' (as the reference's graph runs it), the 8 +
  32 rows cut in two (rank 0 of 'model' holds the 8 front rows and 12
  tokens);
- the same with two accumulation microbatches.

Each holds what ``test_torch_sharded_train.py``'s cases hold, within the
train tests' tolerances (``_torch_train``) or twice the reference's own
4-vs-1 spread: the loss and the norm, every gradient leaf against the
reference and the port's unsharded step, the update, the moments after
the step, each rank's param and moment blocks.  The seamless step's
collectives are printed beside the reference's compiled train HLO, and
on a one-rank mesh each family's step is the unsharded one bit for bit.
"""

import pytest

import _torch_sharded_train as H

CASES = {
    "seamless-1x4": dict(arch="seamless-m4t-medium", over={}, mesh=(1, 4),
                         accum=1, frames=16, hlo=True, captured=True),
    "internvl2-fsdp-2x2": dict(arch="internvl2-76b", over={"fsdp": True},
                               mesh=(2, 2), accum=1, front=True,
                               captured=True),
    "internvl2-fsdp-accum2-2x2": dict(arch="internvl2-76b",
                                      over={"fsdp": True}, mesh=(2, 2),
                                      accum=2, front=True, captured=True),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return H.run(tmp_path_factory.mktemp("sharded_train_encdec"), CASES)


@pytest.mark.parametrize("name", CASES)
def test_loss_and_norm_match_reference(runs, name):
    H.hold_loss_and_norm(runs[name])


@pytest.mark.parametrize("name", CASES)
def test_grads_match_reference_and_unsharded(runs, name):
    out = runs[name]
    got = H.assemble(out, "grads")
    r4, r1 = H.ref_grads(out), H.ref_grads(out, "g1")
    H.hold_grads(out["plain"]["grads"], got, spread=r1, spread_of=r4)
    H.hold_grads(r4, got, spread=r1)


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
    """The seamless smoke's step on (1, 4): the reference's compiled HLO
    (``parse_collectives``, the layer loops counted ``n_layers`` times)
    beside the port's count on rank 0 (printed with ``-s``).  No leaf is
    FSDP-sharded, so the port moves no parameter; the encoder's output is
    gathered once a forward (and again in no remat recompute: it is an
    input of the checkpointed decoder layers), its gradient
    reduce-scattered once."""
    out = runs["seamless-1x4"]
    H.print_collectives(out, "seamless-m4t-medium smoke, mesh (1, 4)",
                        capsys)
    st = H.step_stats(out)
    assert st.param_count == 0
    assert st.count_by_kind["all-to-all"] == 0
    assert st.backward_count_by_kind["reduce-scatter"] > 0
    assert out["meta"]["hlo"]["count"]["all-gather"] > 0


# name: (arch, config overrides, accum_steps, the batch's other entries)
WORLD1 = {"seamless": ("seamless-m4t-medium", {}, 1, {"frames": 16}),
          "internvl2-fsdp-accum2": ("internvl2-76b", {"fsdp": True}, 2,
                                    {"front": True})}


@pytest.mark.parametrize("name", WORLD1)
def test_one_rank_mesh_is_unsharded_step_bit_for_bit(name):
    """On a one-rank gloo mesh (1, 1) the sharded step (every collective
    issued over one rank; the frames and the front rows cut over one)
    equals the unsharded step: the loss, the norm, every gradient leaf,
    every param and every moment leaf after the step."""
    H.hold_world1(*WORLD1[name])
