"""Spawned gloo ranks for the port's parallel tests (imported by the
spawned children by name, so it imports no JAX).

``spawn_ranks(fn, world, tmp, *args)`` starts ``world`` processes that
join one gloo group on a ``file://`` store under ``tmp`` (no TCP port,
so parallel test workers cannot collide) and run ``fn(rank, world, tmp,
*args)``; each rank writes what it returns to ``tmp/rank{r}.pkl``.
"""

from __future__ import annotations

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


def spawn_ranks(fn, world: int, tmp, *args) -> list:
    """Run ``fn`` on ``world`` gloo ranks; returns their results by rank."""
    tmp = str(tmp)
    ctx = mp.start_processes(_entry, args=(fn, world, tmp, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=5):      # raises if a rank raised
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} ranks did not finish in "
                               f"{TIMEOUT_S} s")
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
        with mesh_context(mesh):
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
