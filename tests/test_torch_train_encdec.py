"""The port's train path of an enc-dec model (seamless-m4t-medium, with
``frames``) and of a VLM's frontend (internvl2-76b, with ``front``)
against the JAX reference's on the CPU, at smoke size: ``lm.forward``'s
loss, logits and every gradient leaf, remat on and off; a tokens-only
``make_train_step`` on internvl2 (its ``front`` leaf unread: a zero
gradient, as ``jax.grad`` gives); and a ``TrainLoop`` on seamless.

The loss is within ``LOSS_RTOL`` and the logits bit-equal to
``jax.jit(jax.value_and_grad(lm.forward))``: the encoder's output reaches
every ``dec_cross`` block's cross K/V, and the VLM's projected ``front``
rows are prepended to the tokens and sliced off before the head."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticLMData as JData
from repro.optim import adamw as JA
from repro.train import trainer as JT

from repro_torch import convert
from repro_torch.data.pipeline import SyntheticLMData as TData
from repro_torch.optim import adamw as TA
from repro_torch.train import trainer as TT

from _torch_train import B, LOSS_RTOL, S, forward_parity, hold_update, \
    model, tokens


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "internvl2-76b"])
def test_forward_loss_logits_and_grads_match_jax(arch):
    assert forward_parity(arch) > 0


def test_vlm_tokens_only_step_zero_front_grad():
    """internvl2-76b's smoke, one ``make_train_step`` on a batch with no
    ``front``: the step runs (every leaf gets a gradient, zeros for the
    unread ``front``), its first moments of ``front`` stay zero as JAX's
    do, and loss, lr, gradient norm and every update equal the
    reference's ``make_train_step`` on the same params and batch."""
    jcfg, tcfg, p = model("internvl2-76b")
    kw = dict(lr=1e-3, total_steps=10, warmup_steps=2)
    batch = {"tokens": tokens(jcfg.vocab, seed=6)}
    tc = JT.TrainConfig(**kw)
    jp = jax.tree.map(jnp.asarray, p)
    jp, jopt, jm = jax.jit(JT.make_train_step(jcfg, tc))(
        jp, JA.adamw_init(jp, tc.adamw),
        {"tokens": jnp.asarray(batch["tokens"])}, jnp.int32(1),
        jax.random.PRNGKey(0))
    tp = convert.train_params_from_jax(p, device="cpu")
    opt = TA.adamw_init(tp, tc.adamw)
    _, opt, m = TT.make_train_step(tcfg, TT.TrainConfig(**kw))(
        tp, opt, {"tokens": torch.from_numpy(batch["tokens"])}, 1)
    for name in ("w", "w_step"):
        assert not np.abs(np.asarray(jopt["m"]["front"][name])).max()
        assert not opt["m"]["front"][name].abs().max()
    assert np.abs(np.asarray(jopt["m"]["embed"]["emb"])).max() > 0
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    np.testing.assert_allclose(float(m["gnorm"]), float(jm["gnorm"]),
                               rtol=1e-3)
    hold_update(p, jp, tp)


LOOP_KW = dict(lr=1e-3, total_steps=3, warmup_steps=1)
LOOP_RTOL = 5e-3


def test_train_loop_with_frames_matches_jax():
    """Three ``TrainLoop`` steps on seamless-m4t-medium's smoke from the
    same params, the data pipeline's ``frames`` (``seq_len // 2``) in
    every batch: each step's loss and lr."""
    jcfg, tcfg, p = model("seamless-m4t-medium")
    kw = dict(vocab=jcfg.vocab, seq_len=S, global_batch=B, seed=2,
              enc_len=S // 2)
    jloop = JT.TrainLoop(jcfg, JT.TrainConfig(**LOOP_KW), JData(**kw),
                         donate=False)
    jp = jax.tree.map(jnp.asarray, p)
    jloop.run(jp, JA.adamw_init(jp, jloop.tc.adamw), num_steps=3)
    loop = TT.TrainLoop(tcfg, TT.TrainConfig(**LOOP_KW), TData(**kw),
                        device="cpu")
    tp = convert.train_params_from_jax(p, device="cpu")
    loop.run(tp, TA.adamw_init(tp, loop.tc.adamw), num_steps=3)
    got, want = loop.metrics_log, jloop.metrics_log
    np.testing.assert_allclose(got[0]["loss"], want[0]["loss"],
                               rtol=LOSS_RTOL)
    # later steps start from params whose updates differ: AdamW's first
    # update is about lr * sign(g), whose sign flips where a gradient is
    # at its rounding level (0.54% of seamless's elements at step 0, the
    # LSQ steps of the attention linears most), and a moved weight can
    # move its 3-bit code; measured 2.7e-3 at step 1
    np.testing.assert_allclose([m["loss"] for m in got],
                               [m["loss"] for m in want], rtol=LOOP_RTOL)
    np.testing.assert_allclose([m["lr"] for m in got],
                               [m["lr"] for m in want], rtol=1e-6)
