"""The port's train path of the MoE families against the JAX reference's
on the CPU, at smoke size: ``lm.forward``'s loss, logits and every
gradient leaf for deepseek-v3 and kimi-k2 (MLA + MoE), remat on and off
(moe-gqa, their GQA variant, is a case of
``test_torch_train_families.py``'s); ``make_train_step`` on deepseek-v3
with int8 AdamW moments and two accumulation microbatches; and one MoE
FFN's output, aux loss and gradients with capacity drops.

The loss (its 0.01 x aux included) is within ``LOSS_RTOL`` and the logits
bit-equal to ``jax.jit(jax.value_and_grad(lm.forward))``: the experts run
the train linear on their expert-stacked ``w [E, K, N]``, the stable
descending sort takes ``lax.top_k``'s lower expert on a tie, and the
router's softmax holds its max constant in the backward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models import nn as jnn
from repro.optim import adamw as JA
from repro.train import trainer as JT

from repro_torch import convert
from repro_torch.models import moe as tmoe
from repro_torch.models import nn as tnn
from repro_torch.optim import adamw as TA
from repro_torch.train import trainer as TT

from _torch_train import GRAD_COS, GRAD_REL, LOSS_RTOL, batch_for, \
    forward_parity, hold_grad, hold_grads, hold_update, model

# kimi-k2: its experts' LSQ ``w_step`` (one per output channel, summed over
# every expert's rows) reaches 2.2e-2 of its largest entry (measured; cosine
# 0.99993), past the default 2e-2
KIMI_REL = 3e-2


@pytest.mark.parametrize("arch,over,rel_max", [
    ("deepseek-v3-671b", (), GRAD_REL),
    ("kimi-k2-1t-a32b", (), KIMI_REL),
], ids=["deepseek-v3-mla", "kimi-k2-mla"])
def test_forward_loss_logits_and_grads_match_jax(arch, over, rel_max):
    assert forward_parity(arch, over, GRAD_COS, rel_max) > 0


def test_train_step_int8_state_accum_matches_jax():
    """``make_train_step`` on deepseek-v3's smoke (2 dense + 2 MoE layers,
    MLA) with int8 AdamW moments (the full config's) and two accumulation
    microbatches: loss, lr, gradient norm, the int8 state's step, and
    every leaf's update.  The dense FFN is 256 wide, so its ``wi``/``wg``
    moments are int8 blocks (a smaller last dim stays f32)."""
    jcfg, tcfg, p = model("deepseek-v3-671b", d_ff=256)
    kw = dict(lr=1e-3, total_steps=10, warmup_steps=2, accum_steps=2)
    batch = batch_for(jcfg, seed=5, b=4)
    tc = JT.TrainConfig(**kw, adamw=JA.AdamWConfig(state_dtype="int8"))
    jp = jax.tree.map(jnp.asarray, p)
    jopt0 = JA.adamw_init(jp, tc.adamw)
    jp, jopt, jm = jax.jit(JT.make_train_step(jcfg, tc))(
        jp, jopt0, {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.int32(1), jax.random.PRNGKey(0))
    ttc = TT.TrainConfig(**kw, adamw=TA.AdamWConfig(state_dtype="int8"))
    tp = convert.train_params_from_jax(p, device="cpu")
    opt = TA.adamw_init(tp, ttc.adamw)
    n_q8 = sum(isinstance(v, dict) for v in jax.tree.leaves(
        opt["m"], is_leaf=lambda x: isinstance(x, dict) and "q" in x))
    assert n_q8 > 0                         # some moments are int8 blocks
    _, opt, m = TT.make_train_step(tcfg, ttc)(
        tp, opt, {k: torch.from_numpy(v) for k, v in batch.items()}, 1)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    np.testing.assert_allclose(float(m["gnorm"]), float(jm["gnorm"]),
                               rtol=1e-3)
    assert int(opt["step"]) == int(jopt["step"]) == 1
    hold_update(p, jp, tp)


def test_moe_aux_loss_and_capacity_drops_match_jax():
    """One MoE FFN of deepseek-v3's smoke (8 experts, top 2, capacity 5 of
    a 16-token group) under the train linear: some assignments dropped,
    the output bit-equal to the reference's ``moe_apply``, the aux loss
    within f32 summation order, and the gradients of ``sum(y * ct) +
    aux`` for every leaf and the input held as the forward tests'."""
    jcfg, tcfg, p = model("deepseek-v3-671b")
    lp = jax.tree.map(lambda a: np.asarray(a[0]),
                      p["segments"][1]["b0"]["moe"])
    rng = np.random.default_rng(3)
    xb = jnp.asarray(rng.standard_normal((2, 16, jcfg.d_model)).astype(
        np.float32)).astype(jnp.bfloat16)
    x = np.asarray(xb.astype(jnp.float32))
    ct = rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)

    def jf(pp, xx):
        y, aux = jmoe.moe_apply(pp, xx, jcfg, apply_fn=jnn.linear_apply)
        return jnp.sum(y.astype(jnp.float32) * ct) + aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(jax.tree.map(jnp.asarray, lp), xb)
    tp = convert.train_params_from_jax(lp, device="cpu")
    tx = torch.from_numpy(x.copy()).to(torch.bfloat16).requires_grad_()
    _, _, _, keep, _, cap = tmoe.route(tp.router.w, tx.detach(), tcfg)
    assert cap == 5 and not bool(keep.all())
    y, aux = tmoe.moe_apply(tp.tree(), tx, tcfg, apply_fn=tnn.linear_apply)
    np.testing.assert_array_equal(y.detach().float().numpy(),
                                  np.asarray(jy, np.float32))
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)
    loss = (y.float() * torch.from_numpy(ct)).sum() + aux
    grads = torch.autograd.grad(loss, [tx] + TA.tree_leaves(tp))
    hold_grad("x", np.asarray(jgx, np.float32), grads[0].float().numpy())
    hold_grads(jgp, [g.numpy() for g in grads[1:]])
