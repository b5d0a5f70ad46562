"""Shared helpers of the train-path parity tests (``test_torch_train*.py``):
the reference's train init with every N2UQ activation quantiser
calibrated, seeded batches, and the holds on gradients and updates.

Params come from the reference's ``init_lm`` with every N2UQ activation
quantiser calibrated (``CAL_DELTAS``, ``CAL_OUT_STEP``: thresholds over
0.06-0.83): at the init's thresholds (0.39-5.0) nearly every activation
is below the first one, so every gradient but the embeddings' is zero
on both sides and the comparison would show nothing."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import smoke_config as jsmoke
from repro.models import lm as jlm

from repro_torch import convert
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw as TA

import _torch_families  # noqa: F401  (one torch thread per worker)

CAL_DELTAS, CAL_OUT_STEP = -2.0, 0.1
# gradients: direction and max error relative to the leaf's largest
# entry (bf16 backward products summed in other orders)
GRAD_COS, GRAD_REL = 0.9999, 2e-2
LOSS_RTOL = 1e-6        # the mean over tokens, summed in another order
B, S = 2, 16


def calibrate(tree):
    if isinstance(tree, dict):
        if "deltas" in tree:
            return {"deltas": np.full_like(tree["deltas"], CAL_DELTAS),
                    "out_step": np.full_like(tree["out_step"], CAL_OUT_STEP)}
        return {k: calibrate(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [calibrate(v) for v in tree]
    return tree


_MODELS = {}


def model(arch, **over):
    """``(jcfg, tcfg, numpy params)``: the reference's train init,
    calibrated."""
    key = (arch, tuple(sorted(over.items())))
    if key not in _MODELS:
        jcfg = dataclasses.replace(jsmoke(arch), **over)
        tcfg = dataclasses.replace(tsmoke(arch), **over)
        # jitted: the eager init dispatches its draws op by op
        p = jax.jit(lambda k: jlm.init_lm(k, jcfg)[0])(jax.random.PRNGKey(0))
        _MODELS[key] = (jcfg, tcfg, calibrate(jax.tree.map(np.asarray, p)))
    return _MODELS[key]


def tokens(vocab, seed=1, b=B, s=S):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def hold_grad(path, want, got, cos_min=GRAD_COS, rel_max=GRAD_REL):
    """A gradient leaf by its direction and its max error relative to the
    leaf's largest entry; a leaf that is zero in JAX must be zero here."""
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    assert want.shape == got.shape, path
    scale = np.abs(want).max()
    if scale == 0:
        assert np.abs(got).max() == 0, path
        return
    cos = (want * got).sum() / np.sqrt((want ** 2).sum() * (got ** 2).sum())
    err = np.abs(want - got).max() / scale
    assert cos > cos_min and err < rel_max, (path, cos, err)


UPDATE_AGREE = 0.995


def hold_update(p0, want, got, agree_min=UPDATE_AGREE):
    """The step's update ``p1 - p0``.  AdamW's first update is about ``lr
    * sign(g)``, so where a gradient is at the level of its rounding error
    (the key bias's is zero up to rounding: softmax ignores a constant
    per query) the two signs may differ; held by the share of elements
    whose updates agree within 1% of their leaf's largest, over all
    leaves."""
    n = agree = 0
    for a0, a1, b1 in zip(jax.tree.leaves(p0), jax.tree.leaves(want),
                          TA.tree_leaves(got)):
        dw = np.asarray(a1, np.float64) - a0
        dt = b1.detach().float().numpy().astype(np.float64) - a0
        agree += int((np.abs(dw - dt) <= 1e-2 * np.abs(dw).max()).sum())
        n += dw.size
    assert agree >= agree_min * n, agree / n


# An N2UQ parameter's gradient (``aq``: ``deltas``, ``out_step``) sums
# y * dy over every activation its linear reads; where that sum cancels
# (``wq_a``'s output is normalised by ``q_norm``, so its ``out_step``'s
# gradient is zero up to rounding) the leaf's own scale is rounding noise.
# Held by its max error over the largest gradient of its kind in the model
# (measured: at most 2.6e-2 over the eight families' smokes).
AQ_REL = 5e-2
ENC_LEN = 8          # frames of an enc-dec batch


def batch_for(jcfg, seed=1, b=B, s=S):
    """A seeded train batch: ``tokens``, and ``frames`` for an enc-dec
    config or ``front`` for a VLM, standard normal f32."""
    out = {"tokens": tokens(jcfg.vocab, seed, b, s)}
    rng = np.random.default_rng(seed + 100)
    if jcfg.n_enc_layers:
        out["frames"] = rng.standard_normal((b, ENC_LEN, 1024)).astype(
            np.float32)
    elif jcfg.frontend != "none":
        out["front"] = rng.standard_normal(
            (b, jcfg.frontend_len, 1152)).astype(np.float32)
    return out


def hold_grads(jg, grads, cos_min=GRAD_COS, rel_max=GRAD_REL):
    """Every gradient leaf of the port (``grads``, in ``tree_leaves``
    order) against JAX's tree ``jg``: zero exactly where JAX's leaf is;
    the ``aq`` leaves by ``AQ_REL``, the others by ``hold_grad``."""
    flat = [(jax.tree_util.keystr(path), np.asarray(w, np.float64))
            for path, w in jax.tree_util.tree_flatten_with_path(jg)[0]]
    assert len(flat) == len(grads)
    kind_scale = {}
    for path, w in flat:
        if "['aq']" in path:
            kind = path.rsplit("[", 1)[1]
            kind_scale[kind] = max(kind_scale.get(kind, 0.0), np.abs(w).max())
    for (path, w), g in zip(flat, grads):
        g = np.asarray(g, np.float64)
        assert w.shape == g.shape, path
        if not np.abs(w).max():
            assert not np.abs(g).max(), path
        elif "['aq']" in path:
            err = np.abs(w - g).max() / kind_scale[path.rsplit("[", 1)[1]]
            assert err < AQ_REL, (path, err)
        else:
            hold_grad(path, w, g, cos_min, rel_max)


def port_grads(params, loss):
    """The gradient of every leaf of ``params`` as numpy, zeros for a leaf
    the loss does not read (as ``jax.grad`` gives)."""
    leaves = TA.tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [np.zeros(t.shape, np.float32) if g is None else g.numpy()
            for t, g in zip(leaves, grads)]


def forward_parity(arch, over=(), cos_min=GRAD_COS, rel_max=GRAD_REL):
    """``lm.forward`` of the port against ``jax.jit(jax.value_and_grad(
    lm.forward))`` on one seeded batch, remat on and off: the loss within
    ``LOSS_RTOL``, the logits bit-equal, every gradient leaf held
    (``hold_grads``), and remat bit-identical to no remat in the port.
    Returns the number of leaves JAX gives a nonzero gradient."""
    over = dict(over)
    jcfg, tcfg, p = model(arch, **over)
    batch = batch_for(jcfg)
    f = jax.jit(jax.value_and_grad(lambda pp, bb: jlm.forward(pp, bb, jcfg),
                                   has_aux=True))
    (jl, jlog), jg = f(jax.tree.map(jnp.asarray, p),
                       {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    runs = {}
    for remat in ("layer", "none"):
        cfg = dataclasses.replace(tcfg, remat=remat)
        tp = convert.train_params_from_jax(p, device="cpu")
        loss, logits = tlm.forward(tp, tb, cfg)
        runs[remat] = (loss.item(), logits.detach(), port_grads(tp, loss))
    loss, logits, grads = runs["layer"]
    assert logits.shape == (B, S, jcfg.vocab)
    np.testing.assert_allclose(loss, float(jl), rtol=LOSS_RTOL)
    np.testing.assert_array_equal(logits.float().numpy(),
                                  np.asarray(jlog, np.float32))
    hold_grads(jg, grads, cos_min, rel_max)
    assert runs["none"][0] == loss
    assert torch.equal(runs["none"][1], logits)
    for a, b in zip(runs["none"][2], grads):
        np.testing.assert_array_equal(a, b)
    return sum(bool(np.abs(np.asarray(w)).max()) for w in jax.tree.leaves(jg))
