"""Spawned gloo ranks for the port's parallel tests (imported by the
spawned children by name, so it imports no JAX).

``spawn_ranks(fn, world, tmp, *args)`` starts ``world`` processes that
join one gloo group on a ``file://`` store under ``tmp`` (no TCP port,
so parallel test workers cannot collide) and run ``fn(rank, world, tmp,
*args)``; each rank writes what it returns to ``tmp/rank{r}.pkl``.
"""

from __future__ import annotations

import contextlib
import copy
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
    reference's params as numpy, tokens, ``S_max``, steps; an enc-dec
    case's ``frames``, a VLM case's ``front`` and its first decode
    position ``pos0``, a teacher-forced case's ``feed``; a ``ring`` case
    also keeps its caches after prefill): this rank's
    param blocks (``convert.params_from_jax(mesh=)``), ``lm.prefill`` of
    its batch rows, then greedy (or fed) ``lm.decode_step``s, the prefill
    and each step under ``record_collectives``.  A single-linear case runs
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
        extra = {k: torch.from_numpy(case[k][r0:r0 + nr])
                 for k in ("frames", "front") if k in case}
        feed = case.get("feed")
        with mesh_context(mesh), _recorded_routes(routes):
            with record_collectives() as st:
                logits, caches = lm.prefill(params, tokens[r0:r0 + nr], cfg,
                                            S_max=case["S_max"], **extra)
            res["prefill_stats"] = st
            res["prefill_logits"] = convert.to_numpy(logits)
            if case.get("ring"):    # copied: decode writes into the caches
                res["prefill_caches"] = copy.deepcopy(
                    convert.to_numpy(caches))
            t = lm.greedy(logits)
            toks, stats = [t], []
            for i in range(case["steps"]):
                if feed is not None:    # teacher-forced: the case's tokens
                    t = torch.from_numpy(feed[i][r0:r0 + nr]).long()
                with record_collectives() as st:
                    logits, caches = lm.decode_step(
                        params, caches, t[:, None].to(torch.int32),
                        case.get("pos0", S) + i, cfg)
                    t = lm.greedy(logits)
                toks.append(t)
                stats.append(st)
            res["model_index"] = coll.index("model")
        res["init_caches"] = [
            {b: {k: tuple(v.shape) for k, v in blk.items()}
             for b, blk in seg.items()}
            for seg in lm.init_caches(
                cfg, device="cpu", B=B, S_max=case["S_max"], mesh=mesh,
                enc_len=case["frames"].shape[1] if "frames" in case else 0)]
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
        routes.append((out[2].numpy(), out[1].detach().numpy()))
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


def train_config(case):
    """The case's port ``TrainConfig``."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import TrainConfig

    return TrainConfig(accum_steps=case["accum"], adamw=AdamWConfig(
        state_dtype=case.get("state_dtype", "f32")),
        compress=case.get("compress", False), **case["tc"])


@contextlib.contextmanager
def fed_uniforms(case, record: list = None):
    """``trainer.compress_grads`` fed the case's reference uniforms while
    inside (no change without compression); each call's compressed
    gradient appended to ``record`` as numpy."""
    from repro_torch.convert import to_numpy
    from repro_torch.train import trainer

    if not case.get("compress"):
        yield
        return
    real = trainer.compress_grads
    us = [torch.from_numpy(u.copy()) for u in case["uniforms"]]

    def fed(grads, gen=None, error_state=None):
        out = real(grads, gen, error_state, uniforms=us)
        if record is not None:
            record.append(to_numpy(out[0]))
        return out

    trainer.compress_grads = fed
    try:
        yield
    finally:
        trainer.compress_grads = real


def sharded_train_rank(rank, world, tmp, names):
    """The sharded train step on this rank for each case of ``names``
    (``tmp/{name}.pkl``: arch, config overrides, mesh shape, accumulation,
    the reference's train params as numpy, tokens (and an enc-dec case's
    ``frames``, a VLM case's ``front``), the ``TrainConfig``
    fields, the moments' dtype, compression and its uniforms, a seeded
    AdamW state): this rank's param blocks
    (``convert.train_params_from_jax`` with ``mesh=``) and moments
    (``adamw_init`` under the mesh), its batch rows, the aux loss of the
    forward (a MoE case), the step's gradient (``make_train_step(...)
    .grads``), then one step under ``record_collectives``, and the seeded
    state's blocks (``convert.adamw_state_from_jax`` with ``mesh=``).
    Returns numpy results by case."""
    import dataclasses

    from repro_torch import convert
    from repro_torch.configs import smoke_config
    from repro_torch.launch.comm_analysis import record_collectives
    from repro_torch.launch.mesh import make_mesh_compat, mesh_context
    from repro_torch.models import lm, nn
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.parallel.sharding import block_range
    from repro_torch.train.trainer import make_train_step

    meshes, out = {}, {}
    for name in names:
        with open(os.path.join(tmp, f"{name}.pkl"), "rb") as f:
            case = pickle.load(f)
        shape = tuple(case["mesh"])
        if shape not in meshes:
            meshes[shape] = make_mesh_compat(shape, ("data", "model"), "cpu")
        mesh = meshes[shape]
        cfg = dataclasses.replace(smoke_config(case["arch"]), **case["over"])
        tc = train_config(case)
        params = convert.train_params_from_jax(case["params"], "cpu",
                                               mesh=mesh, cfg=cfg)
        p0 = _copied(convert.to_numpy(params))   # the step works in place
        r0, nr = block_range(case["tokens"].shape[0],
                             nn.train_batch_axes(cfg), mesh)
        batch = {k: torch.from_numpy(case[k][r0:r0 + nr])
                 for k in ("tokens", "frames", "front") if k in case}
        step = make_train_step(cfg, tc)
        res = out[name] = {}
        with mesh_context(mesh):
            if case.get("aux"):     # 0.01 x the aux loss: the CE taken out
                real = lm.next_token_loss
                lm.next_token_loss = lambda *a, **k: torch.zeros(())
                try:
                    with torch.no_grad():
                        res["aux"] = lm.forward(params, batch, cfg)[0].item()
                finally:
                    lm.next_token_loss = real
            opt = adamw_init(params, tc.adamw)
            m0 = {p: tuple(v.shape) for p, v in keystr_leaves(
                convert.to_numpy(opt["m"]))}
            with _recorded_routes(res.setdefault("routes", [])):
                loss, grads = step.grads(params, batch)
            comp = []
            with record_collectives() as st, fed_uniforms(case, comp):
                params, opt, met = step(params, opt, batch, 0)
            if comp:
                res["compressed"] = comp[0]
        state = convert.adamw_state_from_jax(case["state"], "cpu", mesh=mesh,
                                             cfg=cfg)
        res.update(
            rows=(r0, nr), p0=p0, loss=loss.item(),
            step_loss=met["loss"].item(), gnorm=met["gnorm"].item(),
            grads=convert.to_numpy(grads), p1=convert.to_numpy(params),
            m0_shapes=m0, m1=convert.to_numpy(opt["m"]),
            v1=convert.to_numpy(opt["v"]), state=convert.to_numpy(state),
            stats=st)
    return out


def keystr_leaves(tree, path=""):
    """``(path, leaf)`` in ``jax.tree_util.keystr`` form (sorted keys)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from keystr_leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from keystr_leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


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


def train_pieces_rank(rank, world, tmp):
    """Pieces of the sharded MoE train step on this rank of a (2, 2) mesh:

    - ``compress``: ``train.compress.compress_grads`` of blocks of four
      global leaves under the mesh, each block tagged with its spec, fed
      the global uniforms (the table ``[256, 64]`` on 'model' by rows and
      an expert stack ``[2, 4, 64, 64]`` on 'model' by experts and on
      'data' by rows, both runs of whole 1024-blocks; a ``[64, 48]`` on
      ('data', 'model') and a ``[6, 2500]`` on 'data' by rows, whose runs
      are not): this rank's blocks, its blocks of the unsharded
      compression of the global leaves, and each leaf's route;
    - ``drawn``: the same with the uniforms drawn from one seeded
      generator, sharded and unsharded, 4096 at a time (``CHUNK``, so
      each leaf's draw is several chunks: the table's and the long rows'
      runs are longer than a chunk, the others' shorter);
    - ``w_step``: ``nn._train_leaves`` of this rank's block of an expert
      stack's train linear (4 experts, ``w_step`` P('model')): the step
      it reads, the element count, the parameter collectives.

    Every rank builds the same global tensors from one seed."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.launch.comm_analysis import record_collectives
    from repro_torch.launch.mesh import make_mesh_compat, mesh_context
    from repro_torch.models import nn
    from repro_torch.parallel.sharding import (P, local_shard, local_tree,
                                               spec_tree)
    from repro_torch.train import compress as C

    mesh = make_mesh_compat((2, world // 2), ("data", "model"), "cpu")
    g = torch.Generator().manual_seed(0)
    leaves = {"table": (torch.randn(256, 64, generator=g), P("model", None)),
              "experts": (torch.randn(2, 4, 64, 64, generator=g),
                          P(None, "model", "data", None)),
              "columns": (torch.randn(64, 48, generator=g),
                          P("data", "model")),
              "long": (torch.randn(6, 2500, generator=g), P("data", None))}
    us = {k: torch.rand(-(-t.numel() // C.BLOCK), C.BLOCK, generator=g)
          for k, (t, _) in leaves.items()}
    chunk, C.CHUNK = C.CHUNK, 4 * C.BLOCK
    drawn, _ = C.compress_grads({k: t for k, (t, _) in leaves.items()},
                                torch.Generator().manual_seed(5))
    C.CHUNK = chunk
    out = {}
    with mesh_context(mesh):
        blocks = {k: local_shard(t, spec, mesh)
                  for k, (t, spec) in leaves.items()}
        q, _ = C.compress_grads(blocks, uniforms=[us[k] for k in sorted(us)])
        out["compress"] = {
            k: (q[k].numpy(), local_shard(C.q8_sr(t, u=us[k]), spec,
                                          mesh).numpy(),
                C.compress_route(blocks[k]))
            for k, (t, spec) in leaves.items()}
        C.CHUNK = 4 * C.BLOCK
        q, _ = C.compress_grads(blocks, torch.Generator().manual_seed(5))
        out["drawn"] = {k: (q[k].numpy(),
                            local_shard(drawn[k], spec, mesh).numpy())
                        for k, (_, spec) in leaves.items()}
        C.CHUNK = chunk
        cfg = smoke_config("deepseek-v3-671b")
        lin = nn.init_linear(torch.Generator().manual_seed(1), 32, 64, cfg,
                             device="cpu", expert=4)
        local = local_tree(lin, spec_tree(lin), mesh)
        with record_collectives() as st:
            used, numel = nn._train_leaves(local, cfg)
        out["w_step"] = dict(whole=lin["w_step"].numpy(),
                             used=used["w_step"].detach().numpy(),
                             numel=numel, whole_numel=lin["w"].numel(),
                             params=st.param_count)
    return out
