"""The sharded QAT train step under ``pure_fsdp`` (no tensor parallelism:
every linear ZeRO-3-sharded over ('data', 'model') and gathered at use,
the batch over the same axes) on 4 gloo ranks against the reference's
4-device step, and the step's pieces on their own
(``tests/_torch_sharded_train.py``, ``_torch_ranks.train_units_rank``).

Case: minicpm-2b's smoke widened so that ``pure_fsdp`` shards every
linear 4 ways on the (1, 4) mesh (d_model 256, d_ff 512, head_dim 64), a
vocab of 500 padded to 512, tied embeddings, remat on and off.  Held as
``test_torch_sharded_train.py`` holds its cases.

The pieces: each autograd collective's backward by ``gradcheck`` in f64
on 4 ranks; the vocab-parallel ``next_token_loss`` and its gradient
against the plain one (a padded vocab); ``lsq_quant``'s step gradient on
a block with the whole weight's element count against the whole
weight's; ``clip_by_global_norm`` over blocks against the whole tree.
"""

import dataclasses

import numpy as np
import pytest
import torch

import _torch_ranks
import _torch_sharded_train as H

from repro_torch.configs import smoke_config
from repro_torch.core.quant import quantizers as Q
from repro_torch.models import lm
from repro_torch.optim.adamw import clip_by_global_norm

WIDE = dict(d_model=256, d_ff=512, head_dim=64, vocab=500, pure_fsdp=True,
            fsdp=True)
CASES = {
    "minicpm-pure-remat-1x4": dict(arch="minicpm-2b", over=WIDE,
                                   mesh=(1, 4), accum=1, hlo=True),
    "minicpm-pure-noremat-1x4": dict(arch="minicpm-2b",
                                     over=dict(WIDE, remat="none"),
                                     mesh=(1, 4), accum=1),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return H.run(tmp_path_factory.mktemp("sharded_train_fsdp"), CASES)


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
def test_only_fsdp_gathers_move_params(runs, name, capsys):
    """Every linear's blocks (``w`` over ('data', 'model'), a
    column-parallel ``w_step`` over 'model') and the tied table, gathered
    at each use (again in the remat recompute) and reduce-scattered in the
    backward, are the only parameter collectives; beside the reference's
    compiled HLO (printed with ``-s``)."""
    out = runs[name]
    st = H.step_stats(out)
    cfg = dataclasses.replace(smoke_config("minicpm-2b"),
                              **out["case"]["over"])
    n = H.fsdp_gathers(cfg, out["case"]["mesh"], cfg.remat == "layer")
    assert st.param_count == n
    assert st.count_by_kind["all-to-all"] == 0
    # pure_fsdp: nothing but the parameters' gradients is reduce-scattered
    assert (st.backward_count_by_kind["reduce-scatter"]
            == st.count_by_kind["reduce-scatter"])
    if "hlo" in out["meta"]:
        hlo = out["meta"]["hlo"]
        with capsys.disabled():
            print(f"\ncollectives a train step, {name}: kind: reference HLO "
                  "count/bytes | port count/bytes (of them backward)")
            for k in hlo["count"]:
                print(f"  {k}: {hlo['count'][k]}/{hlo['bytes'][k]} | "
                      f"{st.count_by_kind[k]}/{st.bytes_by_kind[k]} "
                      f"({st.backward_count_by_kind[k]}/"
                      f"{st.backward_bytes_by_kind[k]})")
            print(f"  port parameter collectives {st.param_count}/"
                  f"{st.param_bytes}")


@pytest.fixture(scope="module")
def units(tmp_path_factory):
    return _torch_ranks.spawn_ranks(_torch_ranks.train_units_rank, 4,
                                    tmp_path_factory.mktemp("train_units"))


@pytest.mark.parametrize("fn", ["split_ad", "all_gather_ad",
                                "reduce_scatter_ad", "all_reduce_ad",
                                "grad_all_reduce"])
def test_autograd_collective_gradcheck(units, fn):
    assert all(r[fn] is True for r in units)


def test_all_reduce_max_has_no_gradient(units):
    want = np.arange(4, dtype=np.float32) * 4
    for r in units:
        value, requires_grad = r["max"]
        np.testing.assert_array_equal(value, want)
        assert not requires_grad


def test_vocab_parallel_loss_and_gradient(units):
    """Rows over 'data', the padded vocab (257 of 272) over 'model': the
    loss on every rank is the plain mean over every row, and each rank's
    gradient is the plain gradient's block."""
    cfg = dataclasses.replace(smoke_config("minicpm-2b"), vocab=257)
    g = torch.Generator().manual_seed(2)
    logits = torch.randn(4, 6, 272, generator=g) * 3
    logits[..., cfg.vocab:] = -1e30
    tokens = torch.randint(0, cfg.vocab, (4, 6), generator=g)
    logits.requires_grad_(True)
    loss = lm.next_token_loss(logits, tokens)
    loss.backward()
    for r in units:
        value, grad, (d, m, nv) = r["loss"]
        np.testing.assert_allclose(value, loss.item(), rtol=1e-6)
        want = logits.grad[2 * d:2 * d + 2, :, m * nv:(m + 1) * nv]
        np.testing.assert_allclose(grad, want.numpy(), rtol=1e-6,
                                   atol=1e-9)


def test_clip_by_global_norm_over_blocks(units):
    norm0, _, tree = units[0]["clip"]
    whole = {k: v.clone() for k, v in tree.items()}
    clipped, norm = clip_by_global_norm(whole, 0.5)
    for r in units:
        n, blocks, _ = r["clip"]
        np.testing.assert_allclose(n, float(norm), rtol=1e-6)
    # each rank's clipped block is the clipped whole's block (mesh (2, 2):
    # 'a' rows over 'model', 'c' rows over ('data', 'model'))
    for rank, r in enumerate(units):
        d, m = rank // 2, rank % 2
        _, blocks, _ = r["clip"]
        np.testing.assert_allclose(blocks["a"], clipped["a"][4 * m:4 * m + 4],
                                   rtol=1e-6)
        np.testing.assert_allclose(blocks["b"], clipped["b"], rtol=1e-6)
        np.testing.assert_allclose(blocks["c"],
                                   clipped["c"][2 * rank:2 * rank + 2],
                                   rtol=1e-6)


@pytest.mark.parametrize("split", ["columns", "rows"])
def test_lsq_step_gradient_of_a_block_with_the_whole_count(split):
    """``lsq_quant`` on a block of a weight with the whole weight's
    element count gives the whole weight's step gradient: a column block
    its step's block (bit for bit), row blocks partial sums that add up to
    it.  With the block's own count the gradient is ``sqrt(4)`` times
    too large."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(16, 8, generator=g)
    step0 = Q.lsq_init(w, 4, per_channel=True)
    ct = torch.randn(16, 8, generator=g)

    def step_grad(block, s, numel=None):
        s = s.clone().requires_grad_(True)
        (Q.lsq_quant(block, s, 4, numel=numel) * ct_block).sum().backward()
        return s.grad

    ct_block = ct
    whole = step_grad(w, step0)
    if split == "columns":
        for j in range(4):
            cols = slice(2 * j, 2 * j + 2)
            ct_block = ct[:, cols]
            got = step_grad(w[:, cols], step0[cols], numel=w.numel())
            assert torch.equal(got, whole[cols])
            local = step_grad(w[:, cols], step0[cols])
            torch.testing.assert_close(local, 2 * got)
    else:
        parts, local = [], []
        for j in range(4):
            rows = slice(4 * j, 4 * j + 4)
            ct_block = ct[rows]
            parts.append(step_grad(w[rows], step0, numel=w.numel()))
            local.append(step_grad(w[rows], step0))
        # the partial sums add up in another order: within f32 rounding of
        # the largest entry
        tol = 1e-6 * float(whole.abs().max())
        torch.testing.assert_close(sum(parts), whole, rtol=0, atol=tol)
        torch.testing.assert_close(sum(local), 2 * whole, rtol=0,
                                   atol=2 * tol)
