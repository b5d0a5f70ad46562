"""The sharded QAT train step on 4 gloo ranks against the reference's
4-device step (shared by the ``test_torch_sharded_train*.py`` files).

``run(tmp, cases)`` builds each case's reference train params once (a
jitted ``init_lm``, every N2UQ quantiser calibrated:
``_torch_train.calibrate``) and a seeded batch of ``B`` x ``S`` tokens,
saves them under ``tmp``, then runs:

- the reference in two subprocesses with 4 forced host devices
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
``S`` (tokens a row, default 32), ``frames`` (an enc-dec case's frames a
row) or ``front`` (a VLM case's front rows), ``captured`` (one reference
program a mesh: the step alone, its gradient read where it is clipped,
the 4-device and one-device programs each compiled in a subprocess of
its own), ``hlo``, ``state_dtype`` (the moments': f32, bf16 or int8), ``compress``
(int8 gradient compression: the port fed the reference's uniforms, one
``jax.random.uniform`` draw over each global leaf's blocks, key
``PRNGKey(0)`` split per leaf) and ``aux`` (the MoE aux loss of the
4-device forward, the CE taken out).  The reference also dumps its
moments after the step (``m1``/``v1``; one device ``n1``/``w1``) and
their per-device blocks under its ``_opt_axes``; each rank converts a
seeded state of the reference's moment structure
(``convert.adamw_state_from_jax(..., mesh=)``) for ``check_moments``.
"""

from __future__ import annotations

import contextlib
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
from _torch_ranks import fed_uniforms, train_config
from _torch_sharded import bf16, block, keystr_leaves

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
from repro.models import lm as L
from repro.optim.adamw import AdamWConfig, adamw_init
from repro.parallel.sharding import make_shardings
from repro.train import trainer as TR
from repro.train.trainer import TrainConfig, make_train_step

tmp, names = sys.argv[1], sys.argv[2].split(",")
part = sys.argv[3]      # all | mesh (the 4-device step) | one (1 device)

def flat(tree, pre):
    out = {}
    for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        v = np.asarray(v)
        if v.dtype == jnp.bfloat16:
            v = v.astype(np.float32)
        out[pre + jax.tree_util.keystr(p)] = v
    return out

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
    dtype = case.get("state_dtype", "f32")
    tc = TrainConfig(accum_steps=case["accum"], adamw=AdamWConfig(
        state_dtype=dtype), compress=case.get("compress", False),
        **case["tc"])
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
    batch = {k: jnp.asarray(case[k]) for k in ("tokens", "frames", "front")
             if k in case}
    _, axes = abstract_init(cfg, "train")
    opt_axes = _opt_axes(axes, opt, dtype, mesh)
    be = (("data", "model") if cfg.pure_fsdp
          else _batch_entry(case["tokens"].shape[0], mesh))
    sh_p, sh_o = make_shardings(mesh, axes), make_shardings(mesh, opt_axes)
    sh_b = {k: NamedSharding(mesh, P(be, *([None] * (v.ndim - 1))))
            for k, v in batch.items()}
    rep = NamedSharding(mesh, P())
    args = (jnp.int32(0), jax.random.PRNGKey(0))
    def aux_of(p, b):      # 0.01 x the aux loss: the CE taken out
        real = L.next_token_loss
        L.next_token_loss = lambda logits, tokens: jnp.float32(0)
        try:
            return fwd(p, b)
        finally:
            L.next_token_loss = real

    def both(p, o, b, s, k):    # one compile for the step and its gradient
        return (step(p, o, b, s, k), grads(p, b),
                aux_of(p, b) if case.get("aux") else jnp.float32(0))

    def captured(p, o, b, s, k):    # the step alone, its gradient read
        seen, real = [], TR.clip_by_global_norm    # where it is clipped
        def clip(g, c):
            seen.append(g)
            return real(g, c)
        TR.clip_by_global_norm = clip
        try:
            p1, o1, met = step(p, o, b, s, k)
        finally:
            TR.clip_by_global_norm = real
        return (p1, o1, met), (met["loss"], seen[0]), jnp.float32(0)

    if case.get("captured"):
        assert not (case.get("compress") or case.get("aux")), name
        both = captured
    one = ((lambda p, o, b, s, k: captured(p, o, b, s, k)[:2])
           if case.get("captured") else
           (lambda p, o, b, s, k: (step(p, o, b, s, k), grads(p, b))))
    if part != "mesh":
        (p1_one, o1_one, met1), (loss1, g1) = jax.jit(one)(params, opt,
                                                           batch, *args)
        out1 = dict(flat(g1, "g1"), **flat(p1_one, "q1"))
        out1.update(flat(o1_one["m"], "n1"), **flat(o1_one["v"], "w1"))
        out1.update(loss1=np.asarray(loss1), gnorm1=np.asarray(met1["gnorm"]))
        np.savez(f"{tmp}/{name}_ref1.npz", **out1)
    if part == "one":
        continue
    out = {}
    with mesh_context(mesh):
        if case.get("hlo") and not case.get("captured"):
            jstep = jax.jit(step, in_shardings=(sh_p, sh_o, sh_b, rep, rep))
            txt = jstep.lower(params, opt, batch, *args).compile().as_text()
        prog = jax.jit(both, in_shardings=(sh_p, sh_o, sh_b, rep, rep)).lower(
            params, opt, batch, *args).compile()
        if case.get("hlo"):
            txt = prog.as_text() if case.get("captured") else txt
            st = parse_collectives(txt, loop_multiplier=cfg.n_layers)
            hlo = {"count": st.count_by_kind, "bytes": st.bytes_by_kind}
        (p1, o1, met), (loss, g), aux = prog(params, opt, batch, *args)
    out.update(flat(p1, "p1"), **flat(g, "g"))
    out.update(flat(o1["m"], "m1"), **flat(o1["v"], "v1"))
    out.update(loss=np.asarray(loss), step_loss=np.asarray(met["loss"]),
               gnorm=np.asarray(met["gnorm"]), aux=np.asarray(aux))
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
                    tokens=T.tokens(jcfg.vocab, seed=1, b=B,
                                    s=c.get("S", S)),
                    state=seeded_state(p, c.get("state_dtype", "f32")))
        case.update(extra_batch(c, jcfg))
        if c.get("compress"):
            case["uniforms"] = ref_uniforms(p)
        with open(os.path.join(tmp, f"{name}.pkl"), "wb") as f:
            pickle.dump(case, f)
        full[name] = case
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}")
    names = list(cases)     # XLA compiles on one core: two subprocesses,
    # and a captured case's two programs each in its own
    single = [n for n in names if not cases[n].get("captured")]
    jobs = [(",".join(part), "all") for part in (single[::2], single[1::2])
            if part]
    jobs += [(n, part) for n in names if cases[n].get("captured")
             for part in ("mesh", "one")]
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REF_SCRIPT), str(tmp), job,
         part], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for job, part in jobs]
    try:
        ranks = _torch_ranks.spawn_ranks(_torch_ranks.sharded_train_rank,
                                         WORLD, tmp, names)
        plain = {n: plain_step(c) for n, c in full.items()}
        errs = [p.communicate(timeout=600)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    out = {}
    for name in cases:
        with open(os.path.join(tmp, f"{name}_ref.json")) as f:
            meta = json.load(f)
        ref = {k: v for f in ("ref", "ref1") for k, v in np.load(
            os.path.join(tmp, f"{name}_{f}.npz")).items()}
        out[name] = dict(case=full[name], meta=meta, plain=plain[name],
                         ranks=[r[name] for r in ranks], ref=ref)
    return out


def extra_batch(c, cfg) -> dict:
    """A case's batch entries beside its tokens, seeded: an enc-dec case's
    ``frames [B, c['frames'], 1024]``, a VLM case's ``front [B, F, 1152]``
    (its config's ``frontend_len`` rows), f32 as the reference's
    ``data/pipeline.py`` makes them."""
    rng = np.random.default_rng(2)
    out = {}
    if c.get("frames"):
        out["frames"] = rng.standard_normal((B, c["frames"], 1024)).astype(
            np.float32)
    if c.get("front"):
        out["front"] = rng.standard_normal(
            (B, cfg.frontend_len, 1152)).astype(np.float32)
    return out


def batch_of(case, rows=slice(None)) -> dict:
    """The case's batch as tensors (``rows`` of each entry)."""
    return {k: torch.from_numpy(case[k][rows])
            for k in ("tokens", "frames", "front") if k in case}


def seeded_state(params, dtype: str):
    """An AdamW state of the reference's structure for ``params`` (its
    ``adamw_init``: int8 moments ``{'q', 'scale'}`` where the last dim
    takes blocks) filled with seeded values, as numpy."""
    import jax

    from repro.optim.adamw import AdamWConfig, adamw_init

    state = adamw_init(jax.tree.map(np.asarray, params),
                       AdamWConfig(state_dtype=dtype))
    rng = np.random.default_rng(3)

    def fill(a):
        a = np.asarray(a)
        if a.dtype == np.int8:
            return rng.integers(-127, 128, a.shape).astype(np.int8)
        return rng.standard_normal(a.shape).astype(a.dtype)

    return jax.tree.map(fill, state)


def ref_uniforms(params) -> list:
    """The reference's compression uniforms of a step with key
    ``PRNGKey(0)``: one ``[n_blocks, 1024]`` draw a leaf, over the global
    leaf, in leaf order."""
    import jax

    leaves = jax.tree.leaves(params)
    keys = jax.random.split(jax.random.PRNGKey(0), len(leaves))
    return [np.asarray(jax.random.uniform(k, (-(-np.size(g) // 1024), 1024)))
            for k, g in zip(keys, leaves)]


def plain_step(case) -> dict:
    """The port's unsharded step on the whole batch: its loss and gnorm,
    and its gradient, params and moments by leaf path."""
    from repro_torch import convert
    from repro_torch.configs import smoke_config
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.trainer import make_train_step

    cfg = dataclasses.replace(smoke_config(case["arch"]), **case["over"])
    tc = train_config(case)
    step = make_train_step(cfg, tc)
    params = convert.train_params_from_jax(case["params"], "cpu")
    batch = batch_of(case)
    loss, grads = step.grads(params, batch)
    with fed_uniforms(case):
        params, opt, met = step(params, adamw_init(params, tc.adamw), batch,
                                0)
    return dict(loss=loss.item(), gnorm=met["gnorm"].item(),
                grads=dict(keystr_leaves(convert.to_numpy(grads))),
                p1=dict(keystr_leaves(convert.to_numpy(params))),
                m1=dict(keystr_leaves(convert.to_numpy(opt["m"]))))


def assemble(out, key: str, blocks: str = "param_blocks",
             shapes: dict = None) -> dict:
    """The whole leaves of the ranks' blocks ``key`` (``grads``, ``p1``;
    with ``blocks='moment_blocks'`` and the whole ``shapes``, ``m1`` or
    ``v1``): each rank's block written at its device's slices, and a
    slice written twice (a replicated leaf) the same on every rank.  bf16
    blocks (uint16 bits) as their values; all in f64."""
    slices = out["meta"][blocks]
    if shapes is None:
        shapes = {p: v.shape for p, v in keystr_leaves(out["case"]["params"])}
    got = {}
    for rank, r in enumerate(out["ranks"]):
        for path, leaf in keystr_leaves(r[key]):
            leaf = bf16(leaf) if leaf.dtype == np.uint16 else leaf
            sl = tuple(slice(a, b) for a, b in slices[path][rank])
            if path not in got:
                got[path] = np.full(shapes[path], np.nan, np.float64)
            prev = got[path][sl]
            if not np.isnan(prev).all():
                np.testing.assert_array_equal(prev, leaf, err_msg=path)
            got[path][sl] = leaf
    for path, v in got.items():
        assert not np.isnan(v).any(), path
    return got


def _errors(want, got, outliers: int = 0):
    """``(cosine, max error over want's largest entry)`` in f64; the max
    taken over all but the ``outliers`` largest errors."""
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    scale = np.abs(want).max()
    cos = (want * got).sum() / np.sqrt((want ** 2).sum() * (got ** 2).sum())
    err = np.sort(np.abs(want - got).ravel())
    return cos, err[len(err) - 1 - outliers] / scale


def _kind_scale(want: dict) -> dict:
    """The largest gradient of each ``aq`` kind (``deltas``,
    ``out_step``) over the model."""
    out = {}
    for path, w in want.items():
        if "['aq']" in path:
            kind = path.rsplit("[", 1)[1]
            out[kind] = max(out.get(kind, 0.0), np.abs(w).max())
    return out


def hold_grads(want: dict, got: dict, spread: dict = None,
               rel: float = T.GRAD_REL, spread_of: dict = None,
               outliers: dict = None, cos: float = T.GRAD_COS) -> dict:
    """Every gradient leaf ``got`` (by path) against ``want``: zero where
    it is zero; an ``aq`` leaf by its max error over the largest gradient
    of its kind (``AQ_REL``), every other by its cosine and its max error
    over its largest entry (``cos``, ``rel``: ``GRAD_COS``, ``GRAD_REL``,
    or the model's own where its unsharded tests set them).  ``spread`` (the reference's own
    one-device gradient): where the reference's two partitionings of one
    step already differ beyond those tolerances on a leaf (N2UQ codes that
    flip on a rounding), the leaf is held to twice that difference
    instead; ``spread_of`` the other partitioning (default ``want``).
    ``outliers``: by path, how many of a leaf's largest errors the max
    leaves out.  Returns the error of each live leaf."""
    kinds = _kind_scale(want)
    worst = {}
    spread_of = want if spread_of is None else spread_of
    for path, g in got.items():
        w = np.asarray(want[path], np.float64)
        if not np.abs(w).max():
            assert not np.abs(g).max(), path
            continue
        cos_min, rel_max = cos, rel
        if "['aq']" in path:
            scale = kinds[path.rsplit("[", 1)[1]]
            err = np.abs(w - g).max() / scale
            if spread is not None:
                rel_max = max(T.AQ_REL, 2 * np.abs(np.asarray(
                    spread_of[path], np.float64) - spread[path]).max() / scale)
            else:
                rel_max = T.AQ_REL
            assert err < rel_max, (path, err, rel_max)
        else:
            c, err = _errors(w, g, (outliers or {}).get(path, 0))
            if spread is not None:
                cos1, err1 = _errors(spread_of[path], spread[path])
                cos_min = min(cos_min, 1 - 2 * (1 - cos1))
                rel_max = max(rel_max, 2 * err1)
            assert c > cos_min and err < rel_max, (path, c, cos_min, err,
                                                   rel_max)
        worst[path] = err
    return worst


def hold_compression(out):
    """Under compression: the compressed gradient that each rank's step
    gives, gathered from the ranks' blocks, is the unsharded compression
    (``q8_sr``) of the gathered gradient with the reference's uniforms,
    bit for bit."""
    from repro_torch.train.compress import q8_sr

    got = assemble(out, "compressed")
    grads = assemble(out, "grads")
    for (path, g), u in zip(sorted(grads.items(), key=lambda kv: _order(
            out, kv[0])), out["case"]["uniforms"]):
        want = q8_sr(torch.from_numpy(g.astype(np.float32)),
                     u=torch.from_numpy(u)).numpy()
        np.testing.assert_array_equal(got[path], want, err_msg=path)


def _order(out, path) -> int:
    """A leaf path's index in the reference's leaf order."""
    paths = [p for p, _ in keystr_leaves(out["case"]["params"])]
    return paths.index(path)


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
    got = assemble(out, "compressed" if out["case"].get("compress")
                   else "grads")      # the gradient that the clip reads
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


def hold_updates(out, own_spread: bool = False):
    """The step's update ``p1 - p0``, gathered from the ranks' blocks: by
    ``hold_update``'s share (``UPDATE_AGREE``) against the port's
    unsharded step; against the reference's 4-device step by that share
    or, where the reference's own one-device update already agrees with
    its 4-device one on fewer elements (a first AdamW step is about ``lr
    * sign(g)``, so every gradient at its rounding level may flip), with
    at most twice as many disagreeing.  ``own_spread``: the hold against
    the port's unsharded step takes that allowance too (the recurrent,
    enc-dec and VLM cases, whose sharded step departs from the unsharded
    one as the reference's own two steps do: sums in other orders, and
    the partitioned graph's roundings copied)."""
    got = assemble(out, "p1")
    p0 = {p: np.asarray(v, np.float64)
          for p, v in keystr_leaves(out["case"]["params"])}
    ref = out["ref"]
    want = {p: ref["p1" + p] for p in p0}
    own = _agree(p0, want, {p: ref["q1" + p] for p in p0})
    least = min(T.UPDATE_AGREE, 1 - 2 * (1 - own))
    plain = _agree(p0, out["plain"]["p1"], got)
    assert plain >= (least if own_spread else T.UPDATE_AGREE), (plain, own)
    share = _agree(p0, want, got)
    assert share >= least, (share, own)


def ref_grads(out, prefix: str = "g") -> dict:
    """The reference's gradient by leaf path: its sharded step's (``g``)
    or its one-device step's (``g1``)."""
    return {p[len(prefix):]: v for p, v in out["ref"].items()
            if p.startswith(prefix + "[")}


def check_blocks(out):
    """Each rank's param and moment blocks: the shapes of the reference's
    per-device blocks (the moments ``adamw_init``'s under the mesh, an
    int8 moment's ``q`` and ``scale`` apart), and before the step the
    whole param's contents there."""
    whole = dict(keystr_leaves(out["case"]["params"]))
    pb, mb = out["meta"]["param_blocks"], out["meta"]["moment_blocks"]
    for rank, r in enumerate(out["ranks"]):
        p0 = dict(keystr_leaves(r["p0"]))
        assert set(p0) == set(whole) and set(r["m0_shapes"]) == set(mb), rank
        for path, leaf in p0.items():
            np.testing.assert_array_equal(
                leaf, block(whole[path], pb[path][rank]), err_msg=path)
        for path, shape in r["m0_shapes"].items():
            want = tuple(b - a for a, b in mb[path][rank])
            assert shape == want, (path, shape, want)


def check_moments(out, own_spread: bool = False):
    """The moments: the seeded state's blocks that each rank converts
    (``adamw_state_from_jax(..., mesh=)``) are the reference's per-device
    blocks of it, the step whole; after the step each moment leaf
    (``m`` and ``v``; an int8 moment's ``q`` and ``scale``), gathered from
    the ranks' blocks, is held as ``hold_updates`` holds the params:
    against the port's unsharded step by ``UPDATE_AGREE`` (``m``; under
    ``own_spread`` by ``hold_updates``' allowance), and against the
    reference's 4-device step by that share or twice the reference's own
    4-vs-1 disagreement."""
    mb, state = out["meta"]["moment_blocks"], out["case"]["state"]
    for rank, r in enumerate(out["ranks"]):
        for k in ("m", "v"):
            whole = dict(keystr_leaves(state[k]))
            got = dict(keystr_leaves(r["state"][k]))
            assert set(got) == set(whole) == set(mb), (rank, k)
            for path, leaf in got.items():
                want = block(np.asarray(whole[path]), mb[path][rank])
                if leaf.dtype == np.uint16:
                    want = want.view(np.uint16)
                np.testing.assert_array_equal(leaf, want, err_msg=path)
        np.testing.assert_array_equal(r["state"]["step"], state["step"])
    ref = out["ref"]
    for k, own in (("m1", "n1"), ("v1", "w1")):
        shapes = {p: ref[k + p].shape for p in mb}
        got = assemble(out, k, "moment_blocks", shapes)
        zero = {p: np.zeros(shapes[p]) for p in mb}
        want = {p: ref[k + p] for p in mb}
        spread = _agree(zero, want, {p: ref[own + p] for p in mb})
        least = min(T.UPDATE_AGREE, 1 - 2 * (1 - spread))
        if k == "m1":
            plain = {p: (bf16(v) if v.dtype == np.uint16 else v)
                     for p, v in out["plain"]["m1"].items()}
            share = _agree(zero, plain, got)
            assert share >= (least if own_spread else T.UPDATE_AGREE), (
                k, share, spread)
        share = _agree(zero, want, got)
        assert share >= least, (k, share, spread)


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


def print_collectives(out, label: str, capsys):
    """The case's step collectives on rank 0 (``step_stats``) beside the
    reference's compiled HLO (``parse_collectives``), printed with
    ``-s``: kind, count and bytes, backward and parameter ones apart."""
    hlo = out["meta"]["hlo"]
    st = step_stats(out)
    with capsys.disabled():
        print(f"\ncollectives a train step, {label}: kind: reference HLO "
              "count/bytes | port count/bytes (of them backward)")
        for k in hlo["count"]:
            print(f"  {k}: {hlo['count'][k]}/{hlo['bytes'][k]} | "
                  f"{st.count_by_kind[k]}/{st.bytes_by_kind[k]} "
                  f"({st.backward_count_by_kind[k]}/"
                  f"{st.backward_bytes_by_kind[k]})")
        print(f"  port parameter collectives {st.param_count}/"
              f"{st.param_bytes}")


def hold_world1(arch: str, over: dict, accum: int, extra: dict = None,
                dtype: str = "f32", compress: bool = False):
    """On a one-rank gloo mesh (1, 1) the sharded step (every collective
    issued over one rank) equals the unsharded step bit for bit: the loss,
    the norm, every gradient leaf, every param and every moment leaf
    after the step (the moments in ``dtype``; under ``compress`` the
    uniforms drawn from one seed in both).  ``extra``: a case's
    ``frames``/``front``, the batch's other entries."""
    import torch.distributed as dist

    from repro_torch import convert
    from repro_torch.launch.mesh import make_host_mesh, mesh_context
    from repro_torch.optim.adamw import adamw_init, tree_leaves
    from repro_torch.train.trainer import make_train_step

    jcfg, tcfg, p = T.model(arch, **over)
    tc = train_config(dict(accum=accum, tc=TC_KW, state_dtype=dtype,
                           compress=compress))
    step = make_train_step(tcfg, tc)
    batch = batch_of(dict(extra_batch(extra or {}, jcfg),
                          tokens=T.tokens(tcfg.vocab, b=B, s=S)))
    runs = []
    for sharded in (False, True):
        mesh = make_host_mesh() if sharded else None
        try:
            with mesh_context(mesh):
                params = convert.train_params_from_jax(p, "cpu", mesh=mesh,
                                                       cfg=tcfg)
                opt = adamw_init(params, tc.adamw)
                loss, grads = step.grads(params, batch)
                params, opt, met = step(params, opt, batch, 0,
                                        torch.Generator().manual_seed(7))
                runs.append((loss, tree_leaves(grads), met,
                             tree_leaves(params), tree_leaves(opt)))
        finally:
            if mesh is not None:
                dist.destroy_process_group()
    (l0, g0, m0, p0, o0), (l1, g1, m1, p1, o1) = runs
    assert torch.equal(l0, l1) and torch.equal(m0["loss"], m1["loss"])
    assert torch.equal(m0["gnorm"], m1["gnorm"])
    assert len(g0) == len(g1) and len(o0) == len(o1)
    if dtype != "f32":
        assert {t.dtype for t in o1} >= {getattr(torch, {
            "int8": "int8", "bf16": "bfloat16"}[dtype])}
    for a, b in [*zip(g0, g1), *zip(p0, p1), *zip(o0, o1)]:
        assert torch.equal(a, b)
