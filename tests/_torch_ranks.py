"""Spawned gloo ranks for the port's parallel tests (imported by the
spawned children by name, so it imports no JAX).

``spawn_ranks(fn, world, tmp, *args)`` starts ``world`` processes that
join one gloo group on a ``file://`` store under ``tmp`` (no TCP port,
so parallel test workers cannot collide) and run ``fn(rank, world, tmp,
*args)``; each rank writes what it returns to ``tmp/rank{r}.pkl``.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 120


def _entry(rank, fn, world, tmp, args):
    torch.set_num_threads(1)    # one core a rank; the test runs in parallel
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        out = fn(rank, world, tmp, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn_ranks(fn, world: int, tmp, *args, timeout: float = TIMEOUT_S
                ) -> list:
    """Run ``fn`` on ``world`` gloo ranks; returns their results by rank.
    ``timeout``: seconds the ranks may take together."""
    tmp = str(tmp)
    ctx = mp.start_processes(_entry, args=(fn, world, tmp, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5):      # raises if a rank raised
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} ranks did not finish in "
                               f"{timeout} s")
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def parallel_rank(rank, world, tmp, inputs):
    """The rings and the pipeline on this rank, under
    ``record_collectives`` each: returns numpy results and the stats."""
    from repro_torch.launch.comm_analysis import record_collectives
    from repro_torch.parallel.overlap import ring_ag_matmul, ring_rs_matmul
    from repro_torch.parallel.pipeline import pipeline_apply

    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    out = {}
    M = t["x"].shape[0]
    m = M // world
    with record_collectives() as st:
        out["ag"] = ring_ag_matmul(t["x"][rank * m:(rank + 1) * m],
                                   t["w"]).numpy()
    out["ag_stats"] = st
    k = t["w"].shape[0] // world
    with record_collectives() as st:
        out["rs"] = ring_rs_matmul(t["x"], t["w"][rank * k:(rank + 1) * k]
                                   ).numpy()
    out["rs_stats"] = st
    with record_collectives() as st:
        out["pipe"] = pipeline_apply(lambda w, x: torch.tanh(x @ w),
                                     t["params"][rank], t["xs"]).numpy()
    out["pipe_stats"] = st
    return out


def sharded_serve_rank(rank, world, tmp, names):
    """The sharded dense serve path on this rank for each case of
    ``names`` (``tmp/{name}.pkl``: arch, config overrides, mesh shape, the
    reference's params as numpy, tokens, ``S_max``, steps): this rank's
    param blocks (``convert.params_from_jax(mesh=)``), ``lm.prefill`` of
    its batch rows, then greedy ``lm.decode_step``s, each step under
    ``record_collectives``.  A single-linear case runs
    ``nn.tp_linear_apply`` on its blocks instead.  Returns numpy results
    by case."""
    import dataclasses

    from repro_torch import convert
    from repro_torch.configs import smoke_config
    from repro_torch.launch.comm_analysis import record_collectives
    from repro_torch.launch.mesh import make_mesh_compat, mesh_context
    from repro_torch.models import lm, nn
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.sharding import (batch_entry, block_range,
                                               local_tree)

    meshes, out = {}, {}
    for name in names:
        with open(os.path.join(tmp, f"{name}.pkl"), "rb") as f:
            case = pickle.load(f)
        shape = tuple(case["mesh"])
        if shape not in meshes:
            meshes[shape] = make_mesh_compat(shape, ("data", "model"), "cpu")
        mesh = meshes[shape]
        res = out[name] = {}
        if case.get("collectives"):
            res.update(_collectives_on(mesh))
            continue
        cfg = dataclasses.replace(smoke_config(case["arch"]), **case["over"])
        if "linear" in case:
            specs = case["specs"]
            p = local_tree(convert._tree(case["linear"], "cpu"), specs, mesh)
            convert._serve_leaves(p)        # table_narrow from the block
            x = torch.from_numpy(case["x"])
            with mesh_context(mesh), record_collectives() as st:
                y, split = nn.tp_linear_apply(p, x, cfg)
                res["model_index"] = coll.index("model")
            res.update(y=convert.to_numpy(y), split=split, stats=st,
                       blocks=convert.to_numpy(p))
            continue
        params = convert.params_from_jax(case["params"], "cpu", mesh=mesh,
                                         cfg=cfg)
        tokens = torch.from_numpy(case["tokens"])
        B, S = tokens.shape
        r0, nr = block_range(B, batch_entry(B, mesh), mesh)
        routes = res["routes"] = []
        with mesh_context(mesh), _recorded_routes(routes):
            logits, caches = lm.prefill(params, tokens[r0:r0 + nr], cfg,
                                        S_max=case["S_max"])
            res["prefill_logits"] = convert.to_numpy(logits)
            t = lm.greedy(logits)
            toks, stats = [t], []
            for i in range(case["steps"]):
                with record_collectives() as st:
                    logits, caches = lm.decode_step(
                        params, caches, t[:, None].to(torch.int32), S + i,
                        cfg)
                    t = lm.greedy(logits)
                toks.append(t)
                stats.append(st)
            res["model_index"] = coll.index("model")
        res["init_caches"] = [
            {b: {k: tuple(v.shape) for k, v in blk.items()}
             for b, blk in seg.items()}
            for seg in lm.init_caches(cfg, device="cpu", B=B,
                                      S_max=case["S_max"], mesh=mesh)]
        res.update(rows=(r0, nr), tokens=torch.stack(toks).numpy(),
                   last_logits=convert.to_numpy(logits), stats=stats,
                   caches=convert.to_numpy(caches),
                   blocks=convert.to_numpy(params))
    return out


@contextlib.contextmanager
def _recorded_routes(routes: list):
    """Every ``moe.route`` call's ``(eidx, gates)`` appended to ``routes``
    as numpy while inside."""
    from repro_torch.models import moe

    real = moe.route

    def recording(*args, **kwargs):
        out = real(*args, **kwargs)
        routes.append((out[2].numpy(), out[1].numpy()))
        return out

    moe.route = recording
    try:
        yield routes
    finally:
        moe.route = real


def _collectives_on(mesh):
    """``parallel.collectives`` on this rank: a gather over ('data',
    'model') (data-major), an int16 gather (moved as bytes), sum, max and
    min over 'model', a reduce-scatter over 'model'; with the counts."""
    from repro_torch.launch.comm_analysis import record_collectives
    from repro_torch.launch.mesh import mesh_context
    from repro_torch.parallel import collectives as coll

    rank = torch.distributed.get_rank()
    with mesh_context(mesh), record_collectives() as st:
        t = torch.arange(8, dtype=torch.float32) + 100 * rank
        out = dict(
            gather=coll.all_gather(torch.tensor([[rank]]), ("data", "model"),
                                   dim=1).numpy(),
            gather16=coll.all_gather(torch.full((2,), rank - 300,
                                                dtype=torch.int16),
                                     "model", dim=0).numpy(),
            sum=coll.all_reduce(t, "model").numpy(),
            max=coll.all_reduce(t, "model", "max").numpy(),
            min=coll.all_reduce(t, "model", "min").numpy(),
            scatter=coll.reduce_scatter(t, "model").numpy(),
            index=(coll.index("data"), coll.index("model"),
                   coll.index(("data", "model"))),
            size=(coll.size("data"), coll.size(("data", "model"))))
    out["stats"] = st
    return out


def sharded_train_rank(rank, world, tmp, names):
    """The sharded train step on this rank for each case of ``names``
    (``tmp/{name}.pkl``: arch, config overrides, mesh shape, accumulation,
    the reference's train params as numpy, tokens, the ``TrainConfig``
    fields): this rank's param and f32 moment blocks
    (``convert.train_params_from_jax``/``adamw_state_from_jax`` with
    ``mesh=``), its batch rows, the step's gradient
    (``make_train_step(...).grads``), then one step under
    ``record_collectives``.  Returns numpy results by case."""
    import dataclasses

    from repro_torch import convert
    from repro_torch.configs import smoke_config
    from repro_torch.launch.comm_analysis import record_collectives
    from repro_torch.launch.mesh import make_mesh_compat, mesh_context
    from repro_torch.models import nn
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.parallel.sharding import block_range
    from repro_torch.train.trainer import TrainConfig, make_train_step

    meshes, out = {}, {}
    for name in names:
        with open(os.path.join(tmp, f"{name}.pkl"), "rb") as f:
            case = pickle.load(f)
        shape = tuple(case["mesh"])
        if shape not in meshes:
            meshes[shape] = make_mesh_compat(shape, ("data", "model"), "cpu")
        mesh = meshes[shape]
        cfg = dataclasses.replace(smoke_config(case["arch"]), **case["over"])
        tc = TrainConfig(accum_steps=case["accum"], adamw=AdamWConfig(),
                         **case["tc"])
        params = convert.train_params_from_jax(case["params"], "cpu",
                                               mesh=mesh, cfg=cfg)
        p0 = _copied(convert.to_numpy(params))   # the step works in place
        tokens = torch.from_numpy(case["tokens"])
        r0, nr = block_range(tokens.shape[0], nn.train_batch_axes(cfg), mesh)
        batch = {"tokens": tokens[r0:r0 + nr]}
        step = make_train_step(cfg, tc)
        with mesh_context(mesh):
            opt = adamw_init(params, tc.adamw)
            loss, grads = step.grads(params, batch)
            with record_collectives() as st:
                params, opt, met = step(params, opt, batch, 0)
        out[name] = dict(
            rows=(r0, nr), p0=p0, loss=loss.item(),
            step_loss=met["loss"].item(), gnorm=met["gnorm"].item(),
            grads=convert.to_numpy(grads), p1=convert.to_numpy(params),
            m1=convert.to_numpy(opt["m"]), stats=st)
    return out


def _copied(tree):
    """A tree of numpy arrays, each copied."""
    if isinstance(tree, dict):
        return {k: _copied(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copied(v) for v in tree]
    return tree.copy()


def train_units_rank(rank, world, tmp):
    """The sharded train step's pieces on this rank (``world`` 4):

    - ``gradcheck`` (f64) of each autograd collective of
      ``parallel.collectives`` on the 'model' axis of a (1, 4) mesh, each
      inside a function of one input ``X`` that is the same on every rank
      (so every rank perturbs the same element in step), whose output is
      a global scalar: ``all_gather_ad``, ``reduce_scatter_ad`` and
      ``split_ad`` between ``split_ad`` of ``X`` and the sum of the
      products with this rank's weights, summed over 'model' by
      ``all_reduce_ad``; ``all_reduce_ad`` read by weights the same on
      every rank; ``grad_all_reduce`` of ``X`` itself;
    - ``all_reduce_max``'s value and that it carries no gradient;
    - the vocab-parallel ``next_token_loss`` on a (2, 2) mesh (rows over
      'data', the padded vocab over 'model') and its gradient;
    - ``clip_by_global_norm`` of a tree of blocks on the (2, 2) mesh.

    Returns numpy results; the test holds them against the plain ones."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.launch.mesh import make_mesh_compat, mesh_context
    from repro_torch.models import lm
    from repro_torch.optim.adamw import clip_by_global_norm
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.sharding import P, local_shard, with_spec

    f64 = torch.float64
    out = {}
    line = make_mesh_compat((1, world), ("data", "model"), "cpu")
    mine = torch.Generator().manual_seed(100 + rank)
    X = torch.randn(world * 8, 3, dtype=f64,
                    generator=torch.Generator().manual_seed(0))
    W2 = torch.randn(2, 3, dtype=f64, generator=mine)
    W8 = torch.randn(8, 3, dtype=f64, generator=mine)
    W2same = torch.randn(2, 3, dtype=f64,
                         generator=torch.Generator().manual_seed(1))
    total = lambda y, w: coll.all_reduce_ad((y * w).sum(), "model")
    fns = {
        "split_ad": (lambda x: total(coll.split_ad(x, "model", 0), W2),
                     X[:world * 2]),
        "all_gather_ad": (lambda x: total(coll.all_gather_ad(
            coll.split_ad(x, "model", 0), "model", 0), W8), X[:world * 2]),
        "reduce_scatter_ad": (lambda x: total(coll.reduce_scatter_ad(
            coll.split_ad(x, "model", 0), "model", 0), W2), X),
        "all_reduce_ad": (lambda x: (coll.all_reduce_ad(
            coll.split_ad(x, "model", 0), "model") * W2same).sum(),
            X[:world * 2]),
        "grad_all_reduce": (lambda x: total(
            coll.grad_all_reduce(x, "model"), W2), X[:2]),
    }
    with mesh_context(line):
        for name, (fn, x) in fns.items():
            x = x.clone().requires_grad_(True)
            out[name] = torch.autograd.gradcheck(fn, (x,))
        t = torch.arange(4, dtype=torch.float32) * (rank + 1)
        t.requires_grad_(True)
        mx = coll.all_reduce_max(t, "model")
        out["max"] = (mx.numpy(), mx.requires_grad)

    square = make_mesh_compat((2, world // 2), ("data", "model"), "cpu")
    cfg = dataclasses.replace(smoke_config("minicpm-2b"), vocab=257)
    B, S, V = 4, 6, 272
    g = torch.Generator().manual_seed(2)
    logits = torch.randn(B, S, V, generator=g) * 3
    logits[..., cfg.vocab:] = -1e30
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=g)
    with mesh_context(square):
        d, m = coll.index("data"), coll.index("model")
        nv = V // coll.size("model")
        lg = logits[2 * d:2 * d + 2, :, m * nv:(m + 1) * nv].clone()
        lg.requires_grad_(True)
        loss = lm.next_token_loss(lg, tokens[2 * d:2 * d + 2], cfg,
                                  start=m * nv)
        loss.backward()
        out["loss"] = (loss.item(), lg.grad.numpy(), (d, m, nv))
        tree = {"a": torch.randn(8, 4, generator=g), "b": torch.randn(
            4, generator=g), "c": torch.randn(8, 6, generator=g)}
        specs = {"a": P("model", None), "b": P(None),
                 "c": P(("data", "model"), None)}
        local = {k: local_shard(v, specs[k], square) for k, v in tree.items()}
        local = {k: with_spec(v.clone(), specs[k]) for k, v in local.items()}
        clipped, norm = clip_by_global_norm(local, 0.5)
        out["clip"] = (float(norm), {k: v.numpy() for k, v in clipped.items()},
                       tree)
    return out
