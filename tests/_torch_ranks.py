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
