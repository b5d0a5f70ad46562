"""The sharded QAT train step on 4 gloo ranks against the reference's
4-device step (shared by ``test_torch_sharded_train.py`` and
``test_torch_sharded_train_fsdp.py``).

``run(tmp, cases)`` builds each case's reference train params once (a
jitted ``init_lm``, every N2UQ quantiser calibrated:
``_torch_train.calibrate``) and a seeded batch of ``B`` x ``S`` tokens,
saves them under ``tmp``, then runs:

- the reference in ONE subprocess with 4 forced host devices
  (``REF_SCRIPT``): ``make_train_step`` jitted with the shardings of the
  specs, as ``launch/dryrun.py::_lower_train`` jits it (params and f32
  moments by ``lm.init_lm``'s specs, the batch over ``_batch_entry`` or
  ('data', 'model') under ``pure_fsdp``, under ``mesh_context`` so its
  ``shard_hint``s bind), one step; the step's gradient (its accumulation,
  jitted with the same shardings); the same step and gradient jitted on
  one device (the reference's own spread); every param's per-device
  block (``devices_indices_map``: device ``r`` is the port's rank
  ``r``); where a case asks, the collectives of the compiled step
  (``hlo_analysis.parse_collectives``, the layer loop counted
  ``n_layers`` times);
- the port on 4 spawned gloo ranks (``_torch_ranks.sharded_train_rank``):
  this rank's param and moment blocks (``convert``'s ``mesh=``), its
  batch rows, ``make_train_step``'s ``grads`` and one step under
  ``record_collectives``.

Each case: ``arch`` (a smoke config), ``over`` (config overrides),
``mesh`` ``(data, model)``, ``accum`` (``accum_steps``), optionally
``hlo``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import torch

import _torch_ranks
import _torch_train as T
from _torch_sharded import block, keystr_leaves

ROOT = os.path.join(os.path.dirname(__file__), "..")
WORLD, B, S = 4, 4, 32
TC_KW = dict(lr=1e-3, total_steps=4, warmup_steps=1, schedule="wsd")

REF_SCRIPT = """
import dataclasses, json, pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import smoke_config
from repro.models import lm
from repro.launch.mesh import make_mesh_compat, mesh_context
from repro.launch.dryrun import _batch_entry, _opt_axes, abstract_init
from repro.launch.hlo_analysis import parse_collectives
from repro.optim.adamw import adamw_init
from repro.parallel.sharding import make_shardings
from repro.train.trainer import TrainConfig, make_train_step

tmp, names = sys.argv[1], sys.argv[2].split(",")

def flat(tree, pre):
    return {pre + jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

def blocks(tree, shardings, mesh):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    out = {}
    for (path, leaf), sh in zip(leaves, jax.tree.leaves(shardings)):
        m = sh.devices_indices_map(leaf.shape)
        out[jax.tree_util.keystr(path)] = [
            [[s.start or 0, leaf.shape[d] if s.stop is None else s.stop]
             for d, s in enumerate(m[dev])] for dev in mesh.devices.flat]
    return out

for name in names:
    case = pickle.load(open(f"{tmp}/{name}.pkl", "rb"))
    cfg = dataclasses.replace(smoke_config(case["arch"]), **case["over"])
    mesh = make_mesh_compat(tuple(case["mesh"]), ("data", "model"))
    tc = TrainConfig(accum_steps=case["accum"], **case["tc"])
    step = make_train_step(cfg, tc)
    fwd = lambda p, b: lm.forward(p, b, cfg)[0]

    def grads(params, batch):     # the step's accumulation, unclipped
        if tc.accum_steps == 1:
            return jax.value_and_grad(fwd)(params, batch)
        mbs = jax.tree.map(lambda x: x.reshape(tc.accum_steps, -1,
                                               *x.shape[1:]), batch)
        def micro(carry, mb):
            acc, lsum = carry
            l, g = jax.value_and_grad(fwd)(params, mb)
            return (jax.tree.map(jnp.add, acc, g), lsum + l), None
        zero = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32),
                            params)
        (gsum, lsum), _ = jax.lax.scan(micro, (zero, jnp.float32(0)), mbs)
        return lsum / tc.accum_steps, jax.tree.map(
            lambda g: g / tc.accum_steps, gsum)

    params = jax.tree.map(jnp.asarray, case["params"])
    opt = adamw_init(params, tc.adamw)
    batch = {"tokens": jnp.asarray(case["tokens"])}
    _, axes = abstract_init(cfg, "train")
    opt_axes = _opt_axes(axes, opt, "f32", mesh)
    be = (("data", "model") if cfg.pure_fsdp
          else _batch_entry(case["tokens"].shape[0], mesh))
    sh_p, sh_o = make_shardings(mesh, axes), make_shardings(mesh, opt_axes)
    sh_b = {"tokens": NamedSharding(mesh, P(be, None))}
    rep = NamedSharding(mesh, P())
    args = (jnp.int32(0), jax.random.PRNGKey(0))
    out = {}
    with mesh_context(mesh):
        jstep = jax.jit(step, in_shardings=(sh_p, sh_o, sh_b, rep, rep))
        p1, _, met = jstep(params, opt, batch, *args)
        loss, g = jax.jit(grads, in_shardings=(sh_p, sh_b))(params, batch)
        if case.get("hlo"):
            txt = jstep.lower(params, opt, batch, *args).compile().as_text()
            st = parse_collectives(txt, loop_multiplier=cfg.n_layers)
            hlo = {"count": st.count_by_kind, "bytes": st.bytes_by_kind}
    out.update(flat(p1, "p1"), **flat(g, "g"))
    out.update(loss=np.asarray(loss), step_loss=np.asarray(met["loss"]),
               gnorm=np.asarray(met["gnorm"]))
    p1_one, _, met1 = jax.jit(step)(params, opt, batch, *args)
    loss1, g1 = jax.jit(grads)(params, batch)
    out.update(flat(g1, "g1"), **flat(p1_one, "q1"))
    out.update(loss1=np.asarray(loss1), gnorm1=np.asarray(met1["gnorm"]))
    meta = {"param_blocks": blocks(params, sh_p, mesh),
            "moment_blocks": blocks(opt["m"], sh_o["m"], mesh)}
    if case.get("hlo"):
        meta["hlo"] = hlo
    np.savez(f"{tmp}/{name}_ref.npz", **out)
    json.dump(meta, open(f"{tmp}/{name}_ref.json", "w"))
"""


def run(tmp, cases: dict) -> dict:
    """Every case through the reference (one subprocess), the port's 4
    ranks and the port unsharded.  Returns ``{name: {'case', 'ref',
    'meta', 'ranks', 'plain'}}``."""
    full = {}
    for name, c in cases.items():
        jcfg, _, p = T.model(c["arch"], **c["over"])
        case = dict(c, params=p, tc=TC_KW,
                    tokens=T.tokens(jcfg.vocab, seed=1, b=B, s=S))
        with open(os.path.join(tmp, f"{name}.pkl"), "wb") as f:
            pickle.dump(case, f)
        full[name] = case
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}")
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REF_SCRIPT), str(tmp),
         ",".join(cases)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        ranks = _torch_ranks.spawn_ranks(_torch_ranks.sharded_train_rank,
                                         WORLD, tmp, list(cases))
        plain = {n: plain_step(c) for n, c in full.items()}
        _, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    out = {}
    for name in cases:
        with open(os.path.join(tmp, f"{name}_ref.json")) as f:
            meta = json.load(f)
        out[name] = dict(case=full[name], meta=meta, plain=plain[name],
                         ranks=[r[name] for r in ranks],
                         ref=dict(np.load(os.path.join(
                             tmp, f"{name}_ref.npz"))))
    return out


def plain_step(case) -> dict:
    """The port's unsharded step on the whole batch: its loss and gnorm,
    and its gradient by leaf path."""
    from repro_torch import convert
    from repro_torch.configs import smoke_config
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.trainer import TrainConfig, make_train_step

    cfg = dataclasses.replace(smoke_config(case["arch"]), **case["over"])
    step = make_train_step(cfg, TrainConfig(accum_steps=case["accum"],
                                            **case["tc"]))
    params = convert.train_params_from_jax(case["params"], "cpu")
    batch = {"tokens": torch.from_numpy(case["tokens"])}
    loss, grads = step.grads(params, batch)
    params, _, met = step(params, adamw_init(params), batch, 0)
    return dict(loss=loss.item(), gnorm=met["gnorm"].item(),
                grads=dict(keystr_leaves(convert.to_numpy(grads))),
                p1=dict(keystr_leaves(convert.to_numpy(params))))


def assemble(out, key: str) -> dict:
    """The whole leaves of the ranks' blocks ``key`` (``grads`` or
    ``p1``): each rank's block written at its device's slices, and a
    slice written twice (a replicated leaf) the same on every rank."""
    slices = out["meta"]["param_blocks"]
    whole = dict(keystr_leaves(out["case"]["params"]))
    got = {}
    for rank, r in enumerate(out["ranks"]):
        for path, leaf in keystr_leaves(r[key]):
            sl = tuple(slice(a, b) for a, b in slices[path][rank])
            if path not in got:
                got[path] = np.full(whole[path].shape, np.nan, np.float32)
            prev = got[path][sl]
            if not np.isnan(prev).all():
                np.testing.assert_array_equal(prev, leaf, err_msg=path)
            got[path][sl] = leaf
    for path, v in got.items():
        assert not np.isnan(v).any(), path
    return got


def _errors(want, got):
    """``(cosine, max error over want's largest entry)`` in f64."""
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    scale = np.abs(want).max()
    cos = (want * got).sum() / np.sqrt((want ** 2).sum() * (got ** 2).sum())
    return cos, np.abs(want - got).max() / scale


def _kind_scale(want: dict) -> dict:
    """The largest gradient of each ``aq`` kind (``deltas``,
    ``out_step``) over the model."""
    out = {}
    for path, w in want.items():
        if "['aq']" in path:
            kind = path.rsplit("[", 1)[1]
            out[kind] = max(out.get(kind, 0.0), np.abs(w).max())
    return out


def hold_grads(want: dict, got: dict, spread: dict = None) -> dict:
    """Every gradient leaf ``got`` (by path) against ``want``: zero where
    it is zero; an ``aq`` leaf by its max error over the largest gradient
    of its kind (``AQ_REL``), every other by its cosine and its max error
    over its largest entry (``GRAD_COS``, ``GRAD_REL``).  ``spread`` (the
    reference's own one-device gradient): where the reference's two
    partitionings of one step already differ beyond those tolerances on a
    leaf (N2UQ codes that flip on a rounding), the leaf is held to twice
    that difference instead.  Returns the error of each live leaf."""
    kinds = _kind_scale(want)
    worst = {}
    for path, g in got.items():
        w = np.asarray(want[path], np.float64)
        if not np.abs(w).max():
            assert not np.abs(g).max(), path
            continue
        cos_min, rel_max = T.GRAD_COS, T.GRAD_REL
        if "['aq']" in path:
            scale = kinds[path.rsplit("[", 1)[1]]
            err = np.abs(w - g).max() / scale
            if spread is not None:
                rel_max = max(T.AQ_REL,
                              2 * np.abs(w - spread[path]).max() / scale)
            else:
                rel_max = T.AQ_REL
            assert err < rel_max, (path, err, rel_max)
        else:
            cos, err = _errors(w, g)
            if spread is not None:
                cos1, err1 = _errors(w, spread[path])
                cos_min = min(cos_min, 1 - 2 * (1 - cos1))
                rel_max = max(rel_max, 2 * err1)
            assert cos > cos_min and err < rel_max, (path, cos, cos_min,
                                                     err, rel_max)
        worst[path] = err
    return worst


def hold_loss_and_norm(out):
    """The loss and the norm: the same on every rank; the loss within
    ``LOSS_RTOL`` of the reference's 4-device step's; the norm the f64
    norm of the gradient gathered from the ranks' blocks (``rtol``
    1e-6: the clip summed every shard once), and within twice the
    reference's own spread of its 4-device norm.  The spread is the
    distance between the reference's 4-device and one-device gradients,
    which bounds the difference of their norms: the difference of the
    norms alone is a near-cancelling sum (scalar ``aq`` leaves whose
    gradients are rounding noise) and came out smaller than the port's
    own rounding spread on the mistral case (``CHANGES.md``)."""
    ref = out["ref"]
    r = out["ranks"][0]
    for q in out["ranks"]:
        assert q["loss"] == r["loss"] == q["step_loss"]
        assert q["gnorm"] == r["gnorm"]
    np.testing.assert_allclose(r["loss"], float(ref["loss"]),
                               rtol=T.LOSS_RTOL)
    got = assemble(out, "grads")
    norm = np.sqrt(sum((np.asarray(g, np.float64) ** 2).sum()
                       for g in got.values()))
    np.testing.assert_allclose(r["gnorm"], norm, rtol=1e-6)
    g4, g1 = ref_grads(out), ref_grads(out, "g1")
    spread = np.sqrt(sum(((np.asarray(g4[p], np.float64) - g1[p]) ** 2).sum()
                         for p in g4))
    assert abs(r["gnorm"] - float(ref["gnorm"])) <= 2 * spread, (
        r["gnorm"], float(ref["gnorm"]), spread)


def _agree(p0, want, got) -> float:
    """``hold_update``'s share: the elements whose updates ``got - p0`` and
    ``want - p0`` agree within 1% of their leaf's largest."""
    n = agree = 0
    for path, a0 in p0.items():
        dw = np.asarray(want[path], np.float64) - a0
        dt = np.asarray(got[path], np.float64) - a0
        agree += int((np.abs(dw - dt) <= 1e-2 * np.abs(dw).max()).sum())
        n += dw.size
    return agree / n


def hold_updates(out):
    """The step's update ``p1 - p0``, gathered from the ranks' blocks: by
    ``hold_update``'s share (``UPDATE_AGREE``) against the port's
    unsharded step; against the reference's 4-device step by that share
    or, where the reference's own one-device update already agrees with
    its 4-device one on fewer elements (a first AdamW step is about ``lr
    * sign(g)``, so every gradient at its rounding level may flip), with
    at most twice as many disagreeing."""
    got = assemble(out, "p1")
    p0 = {p: np.asarray(v, np.float64)
          for p, v in keystr_leaves(out["case"]["params"])}
    assert _agree(p0, out["plain"]["p1"], got) >= T.UPDATE_AGREE
    ref = out["ref"]
    want = {p: ref["p1" + p] for p in p0}
    own = _agree(p0, want, {p: ref["q1" + p] for p in p0})
    share = _agree(p0, want, got)
    assert share >= min(T.UPDATE_AGREE, 1 - 2 * (1 - own)), (share, own)


def ref_grads(out, prefix: str = "g") -> dict:
    """The reference's gradient by leaf path: its sharded step's (``g``)
    or its one-device step's (``g1``)."""
    return {p[len(prefix):]: v for p, v in out["ref"].items()
            if p.startswith(prefix + "[")}


def check_blocks(out):
    """Each rank's param and moment blocks: the shapes of the reference's
    per-device blocks, and before the step the whole leaf's contents
    there."""
    whole = dict(keystr_leaves(out["case"]["params"]))
    pb, mb = out["meta"]["param_blocks"], out["meta"]["moment_blocks"]
    for rank, r in enumerate(out["ranks"]):
        p0, m1 = dict(keystr_leaves(r["p0"])), dict(keystr_leaves(r["m1"]))
        assert set(p0) == set(whole) == set(m1), rank
        for path, leaf in p0.items():
            np.testing.assert_array_equal(
                leaf, block(whole[path], pb[path][rank]), err_msg=path)
            shape = tuple(b - a for a, b in mb[path][rank])
            assert m1[path].shape == shape, (path, m1[path].shape, shape)


def step_stats(out):
    """The collectives of one step on rank 0, asserted the same on every
    rank: ``CollectiveStats``."""
    stats = [r["stats"] for r in out["ranks"]]
    for st in stats[1:]:
        assert st == stats[0]
    return stats[0]


def _spec_leaves(tree, path=""):
    """``(path, spec)`` of a spec tree (a spec is a tuple: a leaf here)."""
    from repro_torch.parallel.sharding import PartitionSpec

    if isinstance(tree, PartitionSpec):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_leaves(tree[k], f"{path}[{k!r}]")
    else:
        for i, v in enumerate(tree):
            yield from _spec_leaves(v, f"{path}[{i}]")


def fsdp_gathers(cfg, mesh, remat: bool) -> int:
    """The parameter collectives one step's forward and backward must
    issue, from the specs alone: each train leaf block gathered at use
    (under tensor parallelism a ``w`` sharded on ('pod', 'data'); under
    ``pure_fsdp`` every sharded leaf, the tied table twice) counts one
    gather a layer (two under remat: the recompute gathers again) and one
    reduce-scatter in the backward."""
    from repro_torch.models import lm

    axes = lm.param_axes(cfg, "train")
    n = 0
    names = {"data": mesh[0], "model": mesh[1]}

    def sharded(spec):
        return [a for e in spec if e is not None
                for a in (e if isinstance(e, tuple) else (e,))
                if a in names and (cfg.pure_fsdp or a != "model")]

    for path, spec in _spec_leaves(axes):
        if not sharded(spec) or ("['w']" not in path and not cfg.pure_fsdp):
            continue
        if path.startswith("['segments']"):
            n += cfg.n_layers * (3 if remat else 2)
        else:   # the table: the embedding and the tied head
            uses = 1 if "head" in axes else 2
            n += uses * 2
    return n
