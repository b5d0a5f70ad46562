"""Multi-pod dry run (port of ``repro.launch.dryrun``).

For every (architecture x input shape) cell, build the production mesh
(one pod 16x16 = 256 devices, or two pods 2x16x16 = 512) over a fake
process group in this one process, make the step's arguments abstract on
the ``meta`` device (params, AdamW state, caches, batch: the counterpart
of ``jax.eval_shape``), and record:

- ``memory_analysis.argument_size_in_bytes``: the bytes rank 0 holds of
  the step's arguments (each leaf distributed with DTensor placements,
  its local shard checked against its spec), over the reference's
  argument set in the reference's dtypes, and
  ``port_argument_size_in_bytes``: what the port's own params hold
  (``PORT_ONLY_LEAVES``, ``REFERENCE_DTYPES``);
- what the reference reads from XLA's compiled step, from a trace of
  rank 0's own sharded step on its ``meta`` blocks
  (``launch.comm_analysis.trace_step``): the step the port runs on cards
  (``make_train_step(cfg, tc)`` with the config's ``train_accum`` and
  ``opt_state_dtype``, ``lm.prefill`` or ``lm.decode_step``) on the
  reference's ``_lower_*`` arguments cut to rank 0's blocks
  (``parallel.sharding.local_tree``), every collective issued through the
  fake group and every kernel through its shape-only path.  It gives
  ``memory_analysis``' output, temp and alias bytes and
  ``total_nonalias_bytes`` (``_mem_dict``'s formula; output and alias
  bytes over the reference's leaves in its dtypes, ``port_*`` beside
  them), ``cost_analysis`` (flops, bytes accessed, transcendentals) and
  ``hlo_collectives`` (the collectives the step issues; every layer runs,
  so ``loop_multiplier`` is 1; an xLSTM scan runs a few of its steps and
  counts the rest, ``models.xlstm.chunked_scan``, so its cells count
  every step too), and ``trace_s``.  ``--skip-hlo`` skips the trace:
  those fields are then null, with reason "skipped";
- the analytic roofline (``launch/analytic.py``) under the H100's data
  sheet (``launch/comm_analysis.Roofline``), and the traced one
  (``roofline_from_trace``).

Fields with no counterpart (``compile_s``: the port compiles no step;
XLA's generated code size; the HLO text's length) are null, each with its
reason.  A cell is not ``ok`` where a spec does not divide its dim (the
reference's lowering refuses such a leaf) or its trace raises.

Usage:
  python -m repro_torch.launch.dryrun --arch codeqwen1.5-7b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both --out experiments/dryrun
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.data.pipeline import batch_specs
from repro_torch.launch import analytic
from repro_torch.launch.comm_analysis import (Roofline, leaves,
                                              roofline_from_trace, trace_step)
from repro_torch.launch.mesh import (fake_world, make_production_mesh,
                                     mesh_context)
from repro_torch.models import lm, nn
from repro_torch.optim.adamw import AdamWConfig, adamw_init, opt_axes
from repro_torch.parallel.sharding import (P, batch_entry, fix_batch_axes,
                                           local_tree, make_shardings,
                                           spec_tree)
from repro_torch.train.trainer import TrainConfig, make_train_step

ENC_LEN_DECODE = 4096  # enc-dec decode cells: cached encoder length
# Where the port's params differ from the reference's: ``table_narrow``
# (the narrow copy of each lookup table that the kernels read) has no
# reference leaf, and the reference keeps f32 embeddings when serving
# where the port draws them in bf16, the dtype every use casts them to.
PORT_ONLY_LEAVES = ("table_narrow",)
REFERENCE_DTYPES = {"emb": torch.float32}

NO_COMPILE = ("read from XLA's compiled step; the port compiles no sharded "
              "step (it traces rank 0's eager step), so it has no "
              "counterpart")
TRACED_MEMORY = ("output_size_in_bytes", "temp_size_in_bytes",
                 "alias_size_in_bytes", "total_nonalias_bytes")
COST_KEYS = ("flops", "bytes accessed", "transcendentals")
# every field left null, by its path in the cell's JSON, and why
NULL_REASONS = {
    "compile_s": NO_COMPILE,
    "memory_analysis.generated_code_size_in_bytes":
        "the size of XLA's generated code; the port runs torch's eager "
        "ops and its kernels, built apart",
    "hlo_collectives.hlo_chars": "the length of XLA's optimized HLO text; "
                                 "the port has no HLO",
}
SKIPPED = "skipped: --skip-hlo skips the trace of the step"
# the fields the trace fills, null under --skip-hlo
TRACED_FIELDS = ("trace_s", "trace_ops",
                 *(f"memory_analysis.{k}" for k in TRACED_MEMORY),
                 "cost_analysis", "hlo_collectives")


def abstract_init(cfg, purpose, gen=None):
    """Meta params and their spec tree (the reference's ``eval_shape`` of
    ``init_lm``); with ``gen``, params drawn from it on its device."""
    tree = lm.init_tree(cfg, gen or torch.Generator(), purpose,
                        "meta" if gen is None else gen.device)
    return tree, spec_tree(tree)


def abstract_caches(cfg, B, S_max, enc_len=0, gen=None):
    caches = lm.init_caches(cfg, device="meta" if gen is None else gen.device,
                            B=B, S_max=S_max, enc_len=enc_len)
    return caches, lm.cache_axes_tree(cfg)


def _batch(cfg, shape, gen):
    """``batch_specs``; with ``gen``, drawn from it on its device (token
    ids in the vocab, normal floats)."""
    specs = batch_specs(cfg, shape)
    if gen is None:
        return specs
    return {k: (torch.randint(0, cfg.vocab, v.shape, generator=gen,
                              dtype=v.dtype, device=gen.device)
                if k == "tokens" else
                torch.randn(v.shape, generator=gen, dtype=v.dtype,
                            device=gen.device))
            for k, v in specs.items()}


def _leaves(tree, axes, path=()):
    """(path, tensor, spec) of a tree and its spec tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, axes[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, (v, a) in enumerate(zip(tree, axes)):
            yield from _leaves(v, a, path + (i,))
    else:
        yield path, tree, axes


def _local_bytes(args, mesh) -> dict:
    """Rank 0's bytes of each argument ``{name: (tree, spec tree)}``:
    every leaf distributed on the mesh (DTensor on meta), its local shard
    checked against the spec's shard shape (which refuses a dim that does
    not divide).  ``by_argument`` counts the reference's leaves in the
    reference's dtypes; ``port_by_argument`` what the port holds."""
    ref, port, leaves = {}, {}, {}
    for name, (tree, axes) in args.items():
        shardings = make_shardings(mesh, axes)
        ref[name] = port[name] = leaves[name] = 0
        for path, t, sh in _leaves(tree, shardings):
            shape = sh.shard_shape(t.shape)
            local = sh.distribute(t).to_local()
            if tuple(local.shape) != shape:
                raise AssertionError(f"{name}{list(path)}: DTensor holds "
                                     f"{tuple(local.shape)}, spec {shape}")
            port[name] += local.numel() * local.element_size()
            if path[-1] in PORT_ONLY_LEAVES:
                continue
            itemsize = REFERENCE_DTYPES.get(path[-1], local.dtype).itemsize
            ref[name] += local.numel() * itemsize
            leaves[name] += 1
    return {"argument_size_in_bytes": sum(ref.values()),
            "by_argument": ref, "leaves": leaves,
            "port_argument_size_in_bytes": sum(port.values()),
            "port_by_argument": port}


def _scalar(dtype, *shape):
    return torch.empty(shape, dtype=dtype, device="meta")


def _train_args(cfg, shape, mesh, gen):
    params, axes = abstract_init(cfg, "train", gen)
    with mesh_context(None):      # the whole (abstract) moments
        opt = adamw_init(params, AdamWConfig(
            state_dtype=cfg.opt_state_dtype))
    o_axes = opt_axes(axes, opt["m"], cfg.opt_state_dtype, mesh)
    bspecs = _batch(cfg, shape, gen)
    bentry = (("data", "model") if cfg.pure_fsdp
              else batch_entry(shape.global_batch, mesh))
    batch_axes = {k: P(bentry, *([None] * (v.dim() - 1)))
                  for k, v in bspecs.items()}
    scalars = {"step": _scalar(torch.int32), "key": _scalar(torch.int32, 2)}
    return {"params": (params, axes), "opt_state": (opt, o_axes),
            "batch": (bspecs, batch_axes),
            "scalars": (scalars, {"step": P(), "key": P()})}


def _prefill_args(cfg, shape, mesh, gen):
    params, axes = abstract_init(cfg, "serve", gen)
    bspecs = _batch(cfg, shape, gen)
    bentry = batch_entry(shape.global_batch, mesh)
    batch_axes = {k: P(bentry, *([None] * (v.dim() - 1)))
                  for k, v in bspecs.items()}
    return {"params": (params, axes), "batch": (bspecs, batch_axes)}


def _decode_args(cfg, shape, mesh, gen):
    B, S = shape.global_batch, shape.seq_len
    params, axes = abstract_init(cfg, "serve", gen)
    enc_len = ENC_LEN_DECODE if cfg.n_enc_layers else 0
    caches, cache_axes = abstract_caches(cfg, B, S, enc_len, gen)
    tokens = _scalar(torch.int32, B, 1)
    if gen is not None:
        tokens = torch.randint(0, cfg.vocab, (B, 1), generator=gen,
                               dtype=torch.int32, device=gen.device)
    cache_axes = fix_batch_axes(cache_axes, B, mesh)
    bentry = batch_entry(B, mesh)
    return {"params": (params, axes), "caches": (caches, cache_axes),
            "tokens": ({"tokens": tokens}, {"tokens": P(bentry, None)}),
            "scalars": ({"pos": _scalar(torch.int32)}, {"pos": P()})}


def step_args(cfg, shape, mesh, gen=None) -> dict:
    """The cell's abstract step arguments ``{name: (tree, spec tree)}``,
    the reference's jit arguments and in_shardings.  With ``gen``: the
    same arguments with values drawn from it on its device (a real step
    for the trace to be held against)."""
    if shape.kind == "train":
        return _train_args(cfg, shape, mesh, gen)
    if shape.kind == "prefill":
        return _prefill_args(cfg, shape, mesh, gen)
    return _decode_args(cfg, shape, mesh, gen)


def cell_step(cfg, shape, mesh, args):
    """The cell's step as rank 0 runs it: ``(fn, its arguments, the
    indices donated)``, the arguments this rank's blocks of ``args``
    (``step_args``), donated as the reference's jit donates them (params
    and the optimiser state in training, the caches in decode)."""
    local = {k: local_tree(tree, axes, mesh)
             for k, (tree, axes) in args.items()}
    if shape.kind == "train":
        step = make_train_step(cfg, TrainConfig(
            adamw=AdamWConfig(state_dtype=cfg.opt_state_dtype),
            accum_steps=cfg.train_accum))
        return ((lambda p, o, b: step(p, o, b, 0)),
                (nn.ParamTree(local["params"], trainable=True),
                 local["opt_state"], local["batch"]), (0, 1))
    params = nn.ParamTree(local["params"])
    if shape.kind == "prefill":
        return ((lambda p, b: lm.prefill(
            p, b["tokens"], cfg, S_max=shape.seq_len, frames=b.get("frames"),
            front=b.get("front"))), (params, local["batch"]), ())
    # decode at the cache's last position (the reference's step reads the
    # whole cache at any position)
    return ((lambda p, c, t: lm.decode_step(p, c, t, shape.seq_len - 1,
                                            cfg)),
            (params, local["caches"], local["tokens"]["tokens"]), (1,))


def trace_cell(cfg, shape, mesh, args):
    """Rank 0's step (``cell_step``) traced under the active mesh
    (``comm_analysis.trace_step``)."""
    fn, step_args_, donated = cell_step(cfg, shape, mesh, args)
    return trace_step(fn, *step_args_, donated=donated)


def traced_fields(trace) -> dict:
    """The cell's fields from a step's trace: ``memory_analysis``' output
    and alias bytes over the reference's leaves in its dtypes (``port_*``:
    the port's own) and temp bytes, ``cost_analysis``,
    ``hlo_collectives`` and the kernels' calls."""
    mem = dict.fromkeys(("output_size_in_bytes", "alias_size_in_bytes",
                         "port_output_size_in_bytes",
                         "port_alias_size_in_bytes"), 0)
    for path, t in leaves(trace.outputs):
        n = t.numel() * t.element_size()
        alias = trace.aliased(t)
        mem["port_output_size_in_bytes"] += n
        mem["port_alias_size_in_bytes"] += n * alias
        name = path[-1] if path else None
        if name in PORT_ONLY_LEAVES:
            continue
        ref = t.numel() * REFERENCE_DTYPES.get(name, t.dtype).itemsize
        mem["output_size_in_bytes"] += ref
        mem["alias_size_in_bytes"] += ref * alias
    mem["temp_size_in_bytes"] = trace.temp_bytes
    st = trace.collectives
    return {"memory_analysis": mem, "cost_analysis": trace.cost(),
            "hlo_collectives": {
                "bytes_by_kind": st.bytes_by_kind,
                "count_by_kind": st.count_by_kind,
                "total_bytes": st.total_bytes, "loop_multiplier": 1,
                "param_count": st.param_count, "param_bytes": st.param_bytes,
                "backward_count_by_kind": st.backward_count_by_kind,
                "backward_bytes_by_kind": st.backward_bytes_by_kind,
                "hlo_chars": None},
            "kernel_calls": trace.kernels}


def _total(mem: dict, port: str = "") -> int:
    """``_mem_dict``'s total: arguments + outputs + temp - aliases."""
    return (mem[f"{port}argument_size_in_bytes"]
            + mem[f"{port}output_size_in_bytes"] + mem["temp_size_in_bytes"]
            - mem[f"{port}alias_size_in_bytes"])


def run_cell(arch: str, shape_name: str, multi_pod: bool, skip_hlo=False):
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    result = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "ok": False,
    }
    if shape.kind == "long-decode" and not cfg.supports_long:
        result.update(ok=True, skipped="by-design: full-attention arch has "
                      "no sub-quadratic path")
        return result

    n_chips = 1
    for n in mesh_shape:
        n_chips *= n
    mf = analytic.model_flops_6nd(cfg, shape)
    t0 = time.time()
    try:
        with fake_world(n_chips):
            mesh = make_production_mesh(multi_pod=multi_pod,
                                            device_type="cpu")
            with mesh_context(mesh):
                args = step_args(cfg, shape, mesh)
                mem = _local_bytes(args, mesh)
                # the port's lowering: the abstract arguments and shards
                result["lower_s"] = time.time() - t0
                result["compile_s"] = None
                trace = None if skip_hlo else trace_cell(cfg, shape, mesh,
                                                         args)
        reasons = dict(NULL_REASONS)
        if trace is None:
            result["trace_s"] = result["trace_ops"] = None
            result["memory_analysis"] = dict(
                mem, **dict.fromkeys(TRACED_MEMORY),
                generated_code_size_in_bytes=None)
            result["cost_analysis"] = dict.fromkeys(COST_KEYS)
            result["hlo_collectives"] = None
            reasons.update(dict.fromkeys(TRACED_FIELDS, SKIPPED))
            del reasons["hlo_collectives.hlo_chars"]
        else:
            result["trace_s"] = trace.seconds
            result["trace_ops"] = trace.ops
            fields = traced_fields(trace)
            mem.update(fields.pop("memory_analysis"))
            mem["total_nonalias_bytes"] = _total(mem)
            mem["port_total_nonalias_bytes"] = _total(mem, "port_")
            result["memory_analysis"] = dict(
                mem, generated_code_size_in_bytes=None)
            result.update(fields)
            result["traced"] = roofline_from_trace(trace, n_chips,
                                                   mf).as_dict()
        result["reasons"] = reasons
        result["ok"] = True
    except Exception as e:  # a cell's failure is its result, not the run's
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-4000:]
        return result

    ana = analytic.analyze(cfg, shape, mesh_shape)
    rl = Roofline(flops=ana.flops, hbm_bytes=ana.hbm_bytes,
                  collective_bytes=ana.collective_bytes, n_chips=n_chips,
                  model_flops=mf)
    result["analytic"] = {**rl.as_dict(), "detail": ana.detail}
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", type=str, default="pod",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", type=str, default="experiments/dryrun")
    ap.add_argument("--skip-hlo", action="store_true",
                    help="skip the trace of the step (its memory, cost "
                         "and collective fields are then null)")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = [a for a in list_archs() if a != "resnet18"] if (
        args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}_{shape}_{'multipod' if mp else 'pod'}"
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    print(f"skip {tag} (exists)")
                    continue
                res = run_cell(arch, shape, mp, skip_hlo=args.skip_hlo)
                with open(path, "w") as f:
                    json.dump(res, f, indent=1, default=str)
                status = "OK" if res["ok"] else "FAIL"
                n_fail += not res["ok"]
                extra = res.get("skipped", res.get("error", ""))
                ma = res.get("memory_analysis", {})
                print(f"{status} {tag} args/dev="
                      f"{ma.get('argument_size_in_bytes')} mem/dev="
                      f"{ma.get('total_nonalias_bytes')} trace_s="
                      f"{res.get('trace_s')} ops={res.get('trace_ops')} "
                      f"{extra}", flush=True)
    return n_fail


if __name__ == "__main__":
    main()
