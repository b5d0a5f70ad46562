"""The port's training stack against the JAX reference's on the CPU, at
smoke size: ``lm.forward``'s loss, logits and every gradient leaf against
``jax.jit(jax.value_and_grad(lm.forward))`` (codeqwen1.5-7b, and
minicpm-2b with tied embeddings), remat on and off; ``make_train_step``
(plain, and with two accumulation microbatches and int8 compression);
four ``TrainLoop`` steps; checkpoints across the two packages; the data
pipeline; preempt-and-resume and the train CLI in the port; ResNet-18's
QAT loss and gradients.

Params come from the reference's ``init_lm`` with every N2UQ activation
quantiser calibrated (``_torch_train.calibrate``).  The other families'
train forwards are ``test_torch_train_*.py``'s.

What holds (measured on these inputs): the loss and the logits are
bit-equal to JAX's (the forward copies XLA's fused roundings, which its
train graph keeps); the gradients are not (XLA's bf16 backward is not
torch autograd's) and are held by direction and by a max error."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.configs.resnet18 import SMOKE as JR_SMOKE
from repro.data.pipeline import SyntheticLMData as JData
from repro.models import lm as jlm
from repro.models import resnet as JR
from repro.optim import adamw as JA
from repro.train import trainer as JT

from repro_torch import convert
from repro_torch.checkpoint import latest_step, restore_checkpoint, \
    save_checkpoint
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.configs.resnet18 import SMOKE as TR_SMOKE
from repro_torch.data.pipeline import SyntheticLMData as TData
from repro_torch.launch import train as cli
from repro_torch.models import lm as tlm
from repro_torch.models import resnet as TR
from repro_torch.optim import adamw as TA
from repro_torch.train import compress as TC
from repro_torch.train import trainer as TT
from repro_torch.train.ft import FaultTolerantRunner, PreemptionSchedule

from _torch_train import B, CAL_DELTAS, CAL_OUT_STEP, GRAD_COS, GRAD_REL, \
    LOSS_RTOL, S  # noqa: F401  (shared with the other train tests)
from _torch_train import calibrate as _calibrate
from _torch_train import hold_grad as _hold_grad
from _torch_train import hold_update as _hold_update
from _torch_train import model as _model
from _torch_train import port_grads as _port_grads
from _torch_train import tokens as _tokens


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "minicpm-2b"])
def test_forward_loss_logits_and_grads_match_jax(arch):
    jcfg, tcfg, p = _model(arch)
    toks = _tokens(jcfg.vocab)
    f = jax.jit(jax.value_and_grad(
        lambda pp, b: jlm.forward(pp, b, jcfg), has_aux=True))
    (jl, jlog), jg = f(jax.tree.map(jnp.asarray, p),
                       {"tokens": jnp.asarray(toks)})
    runs = {}
    for remat in ("layer", "none"):
        cfg = dataclasses.replace(tcfg, remat=remat)
        tp = convert.train_params_from_jax(p, device="cpu")
        loss, logits = tlm.forward(tp, {"tokens": torch.from_numpy(toks)},
                                   cfg)
        runs[remat] = (loss.item(), logits.detach(), _port_grads(tp, loss))
    loss, logits, grads = runs["layer"]
    assert logits.shape == (B, S, jcfg.vocab) and logits.dtype == \
        torch.bfloat16
    np.testing.assert_allclose(loss, float(jl), rtol=LOSS_RTOL)
    np.testing.assert_array_equal(logits.float().numpy(),
                                  np.asarray(jlog, np.float32))
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(jflat) == len(grads)
    n_live = 0
    for (path, want), got in zip(jflat, grads):
        _hold_grad(jax.tree_util.keystr(path), want, got)
        n_live += bool(np.abs(np.asarray(want)).max())
    assert n_live == len(grads)          # every leaf has a gradient
    # remat recomputes the same ops: bit-identical in the port
    assert runs["none"][0] == loss
    assert torch.equal(runs["none"][1], logits)
    for a, b in zip(runs["none"][2], grads):
        np.testing.assert_array_equal(a, b)


LOOP_KW = dict(lr=1e-3, total_steps=4, warmup_steps=1, schedule="wsd")
_JAX_LOOP = {}


def _jax_loop():
    """The reference's ``TrainLoop``, four steps on minicpm-2b's smoke
    (tied embeddings, WSD): its metrics, and its params after step 0."""
    if not _JAX_LOOP:
        jcfg, _, p = _model("minicpm-2b")
        data = JData(vocab=jcfg.vocab, seq_len=S, global_batch=B, seed=2)
        loop = JT.TrainLoop(jcfg, JT.TrainConfig(**LOOP_KW), data,
                            donate=False)
        jp = jax.tree.map(jnp.asarray, p)

        def hook(step, params, opt, m):
            if step == 0:
                _JAX_LOOP["params"] = jax.tree.map(np.asarray, params)

        loop.run(jp, JA.adamw_init(jp, loop.tc.adamw), num_steps=4,
                 step_hook=hook)
        _JAX_LOOP["metrics"] = loop.metrics_log
    return _JAX_LOOP


def _port_data(vocab):
    return TData(vocab=vocab, seq_len=S, global_batch=B, seed=2)


def test_train_step_matches_jax():
    """One ``make_train_step`` from the same params and batch as the
    reference's first loop step: loss, lr and gradient norm, and the
    update of every leaf."""
    jcfg, tcfg, p = _model("minicpm-2b")
    want = _jax_loop()
    tc = TT.TrainConfig(**LOOP_KW)
    tp = convert.train_params_from_jax(p, device="cpu")
    opt = TA.adamw_init(tp, tc.adamw)
    batch = {k: torch.from_numpy(v)
             for k, v in _port_data(jcfg.vocab).batch(0).items()}
    _, opt, m = TT.make_train_step(tcfg, tc)(tp, opt, batch, 0)
    w = want["metrics"][0]
    np.testing.assert_allclose(float(m["loss"]), w["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["lr"]), w["lr"], rtol=1e-6)
    np.testing.assert_allclose(float(m["gnorm"]), w["gnorm"], rtol=1e-3)
    assert int(opt["step"]) == 1
    _hold_update(p, want["params"], tp)


def test_train_step_accum_and_compress_matches_jax(monkeypatch):
    """``make_train_step`` with two accumulation microbatches and int8
    compression (the port fed the reference's uniforms) on
    codeqwen1.5-7b's smoke: loss, lr, gradient norm and the updates."""
    jcfg, tcfg, p = _model("codeqwen1.5-7b")
    kw = dict(lr=1e-3, total_steps=10, warmup_steps=2, accum_steps=2,
              compress=True)
    batch = {"tokens": _tokens(jcfg.vocab, seed=5, b=4)}
    key = jax.random.PRNGKey(3)
    tc_j = JT.TrainConfig(**kw)
    jp = jax.tree.map(jnp.asarray, p)
    jp, jopt, jm = jax.jit(JT.make_train_step(jcfg, tc_j))(
        jp, JA.adamw_init(jp, tc_j.adamw),
        {"tokens": jnp.asarray(batch["tokens"])}, jnp.int32(1), key)
    real = TC.compress_grads

    def jax_uniforms(grads, gen=None, error_state=None):
        leaves = TA.tree_leaves(grads)
        us = [torch.from_numpy(np.array(jax.random.uniform(
            k, (-(-g.numel() // TC.BLOCK), TC.BLOCK))))
            for k, g in zip(jax.random.split(key, len(leaves)), leaves)]
        return real(grads, gen, error_state, uniforms=us)

    monkeypatch.setattr(TT, "compress_grads", jax_uniforms)
    tc = TT.TrainConfig(**kw)
    tp = convert.train_params_from_jax(p, device="cpu")
    opt = TA.adamw_init(tp, tc.adamw)
    _, opt, m = TT.make_train_step(tcfg, tc)(
        tp, opt, {"tokens": torch.from_numpy(batch["tokens"])}, 1)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    np.testing.assert_allclose(float(m["gnorm"]), float(jm["gnorm"]),
                               rtol=1e-3)
    assert int(opt["step"]) == int(jopt["step"]) == 1
    _hold_update(p, jp, tp)


def test_train_loop_losses_match_jax():
    """Four ``TrainLoop`` steps from the same params: every step's loss
    and lr."""
    jcfg, tcfg, p = _model("minicpm-2b")
    want = _jax_loop()["metrics"]
    loop = TT.TrainLoop(tcfg, TT.TrainConfig(**LOOP_KW),
                        _port_data(jcfg.vocab), device="cpu")
    tp = convert.train_params_from_jax(p, device="cpu")
    loop.run(tp, TA.adamw_init(tp, loop.tc.adamw), num_steps=4)
    got = loop.metrics_log
    # step 0 from equal params: LOSS_RTOL; later steps from params whose
    # updates differ where a gradient is near zero
    np.testing.assert_allclose(got[0]["loss"], want[0]["loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose([m["loss"] for m in got],
                               [m["loss"] for m in want], rtol=1e-3)
    np.testing.assert_allclose([m["lr"] for m in got],
                               [m["lr"] for m in want], rtol=1e-6)


def test_loss_falls_on_a_fixed_batch():
    """The reference's ``test_one_train_step_reduces_loss`` in the port:
    eight steps at lr 1e-2 on one batch lower the loss by 0.1."""
    cfg = tsmoke("codeqwen1.5-7b")
    params = tlm.init_lm(cfg, torch.Generator().manual_seed(0),
                         purpose="train", device="cpu")
    tc = TT.TrainConfig(lr=1e-2, total_steps=10, warmup_steps=1)
    step = TT.make_train_step(cfg, tc)
    opt = TA.adamw_init(params, tc.adamw)
    batch = {"tokens": torch.from_numpy(_tokens(cfg.vocab, 4, 4, 32))}
    losses = [float(step(params, opt, batch, i)[2]["loss"])
              for i in range(8)]
    assert losses[-1] < losses[0] - 0.1, losses


def test_preempt_and_resume_bit_identical(tmp_path):
    """Preempted once and resumed from the latest checkpoint, the run's
    losses equal the uninterrupted run's bit for bit (CPU)."""
    cfg = tsmoke("minicpm-2b")
    tc = TT.TrainConfig(lr=1e-3, total_steps=8, warmup_steps=2)
    data = TData(vocab=cfg.vocab, seq_len=S, global_batch=B)
    a = TT.TrainLoop(cfg, tc, data, device="cpu")
    pa, oa = a.init(0)
    a.run(pa, oa, num_steps=8)
    b = TT.TrainLoop(cfg, tc, data, ckpt_interval=3, device="cpu")
    runner = FaultTolerantRunner(b, str(tmp_path))
    runner.run(8, seed=0, step_hook=PreemptionSchedule([5]))
    assert runner.restarts == 1 and latest_step(str(tmp_path)) == 6
    got = {m["step"]: m["loss"] for m in b.metrics_log}
    assert [got[s] for s in range(8)] == [m["loss"] for m in a.metrics_log]


def _filled(state):
    """The reference's AdamW state (its structure and dtypes) as numpy,
    filled with seeded values: moments, int8 codes and scales, step 3."""
    rng = np.random.default_rng(6)

    def fill(a):
        a = np.asarray(a)
        if a.dtype == np.int8:
            return rng.integers(-127, 128, a.shape).astype(np.int8)
        if a.dtype == np.int32:
            return np.full(a.shape, 3, np.int32)
        return np.abs(rng.normal(size=a.shape)).astype(a.dtype)

    return jax.tree.map(fill, state)


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_checkpoints_cross_packages(tmp_path, dtype):
    """A checkpoint the port writes restores in the reference and the
    reference's in the port: train params and AdamW state (int8 moments
    as ``{q, scale}``, the 0-d step), every leaf bit-equal."""
    _, _, p = _model("minicpm-2b")
    jstate = _filled(JA.adamw_init(jax.tree.map(jnp.asarray, p),
                                   JA.AdamWConfig(state_dtype=dtype)))
    jtree = {"params": p, "opt": jstate}
    ttree = {"params": convert.train_params_from_jax(p, device="cpu"),
             "opt": convert.adamw_state_from_jax(jstate, device="cpu")}
    jsave(str(tmp_path / "jax"), 3, jtree, metadata={"loss": 1.5})
    got, manifest = restore_checkpoint(str(tmp_path / "jax"), ttree,
                                       device="cpu")
    assert manifest["step"] == 3 and manifest["metadata"]["loss"] == 1.5
    assert isinstance(got["params"], type(ttree["params"]))
    want_flat = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jtree))[0]
    got_leaves = TA.tree_leaves(got)
    assert len(want_flat) == len(got_leaves)
    for (path, a), b in zip(want_flat, got_leaves):
        assert b.dtype == convert.to_torch(a, "cpu").dtype, path
        np.testing.assert_array_equal(b.detach().numpy(), a)
    save_checkpoint(str(tmp_path / "port"), 4, ttree)
    back, m2 = jrestore(str(tmp_path / "port"), jtree)
    assert m2["step"] == 4
    for (path, a), b in zip(want_flat, jax.tree.leaves(back)):
        assert np.asarray(b).dtype == a.dtype, path
        np.testing.assert_array_equal(np.asarray(b), a)
    for a, b in zip(jax.tree.leaves(p),
                    jax.tree.leaves(convert.to_numpy(ttree["params"]))):
        np.testing.assert_array_equal(b, a)


def test_bf16_state_checkpoint_restores_in_port(tmp_path):
    """bf16 moments written by the reference (numpy stores them as 2-byte
    voids) restore in the port bit for bit, and the port's round trip
    keeps them."""
    _, _, p = _model("minicpm-2b")
    jstate = _filled(JA.adamw_init(jax.tree.map(jnp.asarray, p),
                                   JA.AdamWConfig(state_dtype="bf16")))
    jsave(str(tmp_path), 1, {"opt": jstate})
    like = {"opt": TA.adamw_init(convert.train_params_from_jax(
        p, device="cpu"), TA.AdamWConfig(state_dtype="bf16"))}
    got, _ = restore_checkpoint(str(tmp_path), like, device="cpu")
    want = jax.tree.leaves(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                        jstate))
    leaves = TA.tree_leaves(got["opt"])
    assert any(t.dtype == torch.bfloat16 for t in leaves)
    for a, b in zip(want, leaves):
        np.testing.assert_array_equal(b.float().numpy(), a)
    save_checkpoint(str(tmp_path / "again"), 1, got)
    again, _ = restore_checkpoint(str(tmp_path / "again"), got, device="cpu")
    for a, b in zip(TA.tree_leaves(again), leaves):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(vocab=257, seq_len=16, global_batch=4, seed=3),
    dict(vocab=1000, seq_len=8, global_batch=8, seed=0, frontend="patch",
         frontend_len=4),
    dict(vocab=512, seq_len=12, global_batch=2, seed=1, enc_len=6),
])
def test_data_batches_bit_equal(kw):
    j, t = JData(**kw), TData(**kw)
    for step in (0, 5, 17):
        for shard, n in ((0, 1), (1, 2)):
            a, b = j.batch(step, shard, n), t.batch(step, shard, n)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def test_train_cli_smoke_on_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch minicpm-2b --smoke
    --device cpu``, shortened, with and without a preemption: WSD,
    finite losses, one restart."""
    loop, params = cli.main(["--arch", "minicpm-2b", "--smoke", "--device",
                             "cpu", "--steps", "3", "--seq-len", "16",
                             "--batch", "2"])
    assert [m["step"] for m in loop.metrics_log] == [0, 1, 2]
    assert loop.tc.schedule == "wsd"
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["gnorm"])
               for m in loop.metrics_log)
    assert params.embed.emb.dtype == torch.float32
    loop, _ = cli.main(["--arch", "minicpm-2b", "--smoke", "--device", "cpu",
                        "--steps", "4", "--seq-len", "16", "--batch", "2",
                        "--ckpt-dir", str(tmp_path), "--ckpt-interval", "1",
                        "--preempt-at", "2"])
    assert "finished with 1 restarts" in capsys.readouterr().out


def test_resnet_qat_loss_and_grads_match_jax():
    """ResNet-18's smoke: ``qat_loss`` (the example's cross-entropy) and
    every gradient leaf against ``jax.grad``."""
    # jitted: the eager init dispatches its random draws op by op (~10 s)
    jp = jax.jit(JR.init_resnet, static_argnums=1)(jax.random.PRNGKey(0),
                                                    JR_SMOKE)
    npp = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, JR_SMOKE.in_hw, JR_SMOKE.in_hw, 3)).astype(
        np.float32)
    labels = rng.integers(0, JR_SMOKE.num_classes, 4).astype(np.int32)

    def jloss(p):
        logits = JR.forward(p, jnp.asarray(x), JR_SMOKE)
        oh = jax.nn.one_hot(labels, JR_SMOKE.num_classes)
        return -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * oh, -1))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    tp = convert.resnet_params_from_jax(npp, device="cpu")
    leaves = [t.requires_grad_() for t in TA.tree_leaves(tp)]
    tl = TR.qat_loss(tp, torch.from_numpy(x), torch.from_numpy(labels),
                     TR_SMOKE)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    grads = torch.autograd.grad(tl, leaves)
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(jg)[0],
                                 grads):
        # f32 throughout: convolutions and reductions summed in other
        # orders
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=jax.tree_util.keystr(path))


def test_expert_linear_and_layernorm_match_jax():
    """The train linear on an expert stack (``w [E, K, N]``, ``x [G, E,
    cap, K]``): output bit-equal and gradients held as the forward
    test's; ``layernorm_apply`` within f32 summation order."""
    from repro.models import nn as jnn
    from repro_torch.models import nn as tnn

    jcfg, tcfg, _ = _model("minicpm-2b")
    p = jax.tree.map(np.asarray, jnn.init_linear(
        jax.random.PRNGKey(2), 32, 48, jcfg, expert=3)[0])
    p["aq"] = _calibrate({"aq": p["aq"]})["aq"]
    x = np.random.default_rng(3).normal(size=(2, 3, 5, 32)).astype(np.float32)

    def jf(pp, xx):
        return jnn.linear_apply(pp, xx, jcfg).astype(jnp.float32)

    ct = np.random.default_rng(4).normal(size=(2, 3, 5, 48)).astype(
        np.float32)

    @jax.jit
    def value_and_vjp(pp, xx, cc):
        y, vjp = jax.vjp(jf, pp, xx)
        return y, vjp(cc)

    jy, (jgp, jgx) = value_and_vjp(jax.tree.map(jnp.asarray, p),
                                   jnp.asarray(x), jnp.asarray(ct))
    tp = convert.train_params_from_jax(p, device="cpu")
    tx = torch.from_numpy(x).requires_grad_()
    ty = tnn.linear_apply(tp.tree(), tx, tcfg).float()
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    grads = torch.autograd.grad(ty, [tx] + TA.tree_leaves(tp),
                                torch.from_numpy(ct))
    _hold_grad("x", jgx, grads[0].numpy())
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(jgp)[0],
                                 grads[1:]):
        _hold_grad(jax.tree_util.keystr(path), want, got.numpy())
    ln = {"scale": np.linspace(0.5, 1.5, 32).astype(np.float32),
          "bias": np.linspace(-0.1, 0.1, 32).astype(np.float32)}
    want = np.asarray(jnn.layernorm_apply(ln, jnp.asarray(x)))
    got = tnn.layernorm_apply({k: torch.from_numpy(v) for k, v in ln.items()},
                              torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert tnn.init_layernorm(32, device="cpu")["bias"].shape == (32,)
