"""Multi-pod dry run (port of ``repro.launch.dryrun``).

For every (architecture x input shape) cell, build the production mesh
(one pod 16x16 = 256 devices, or two pods 2x16x16 = 512) over a fake
process group in this one process, make the step's arguments abstract on
the ``meta`` device (params, AdamW state, caches, batch: the counterpart
of ``jax.eval_shape``), shard each leaf by its partition spec with
DTensor placements, and record:

- ``memory_analysis.argument_size_in_bytes``: the bytes rank 0 holds of
  the step's arguments (the sum of its local shard bytes) over the
  reference's argument set in the reference's dtypes, and
  ``port_argument_size_in_bytes``: what the port's own params hold
  (``PORT_ONLY_LEAVES``, ``REFERENCE_DTYPES``);
- the analytic roofline (``launch/analytic.py``) under the H100's data
  sheet (``launch/comm_analysis.Roofline``).

What the reference reads from XLA's compiled step (output, temp and
alias bytes, the HLO cost analysis, the parsed collectives) cannot be had
without compiling a sharded step, which the port does not do: those
fields are null, each with its reason.  A cell is not ``ok`` where a spec
does not divide its dim (the reference's lowering refuses such a leaf).

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
from repro_torch.launch.comm_analysis import Roofline
from repro_torch.launch.mesh import (fake_world, make_production_mesh,
                                     mesh_context)
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamWConfig, adamw_init, opt_axes
from repro_torch.parallel.sharding import (P, batch_entry, fix_batch_axes,
                                           make_shardings, spec_tree)

ENC_LEN_DECODE = 4096  # enc-dec decode cells: cached encoder length
# Where the port's params differ from the reference's: ``table_narrow``
# (the narrow copy of each lookup table that the kernels read) has no
# reference leaf, and the reference keeps f32 embeddings when serving
# where the port draws them in bf16, the dtype every use casts them to.
PORT_ONLY_LEAVES = ("table_narrow",)
REFERENCE_DTYPES = {"emb": torch.float32}

NO_COMPILE = ("read from XLA's compiled step; the port compiles no sharded "
              "step, so it has no counterpart")
NULL_MEMORY = ("output_size_in_bytes", "temp_size_in_bytes",
               "alias_size_in_bytes", "generated_code_size_in_bytes",
               "total_nonalias_bytes")
# every field left null, by its path in the cell's JSON, and why
NULL_REASONS = {
    "compile_s": NO_COMPILE,
    **{f"memory_analysis.{k}": NO_COMPILE for k in NULL_MEMORY},
    "cost_analysis": NO_COMPILE + " (the analytic counts are under "
                     "'analytic')",
    "hlo_collectives": "parsed from XLA's optimized HLO text; the port has "
                       "no HLO (the analytic collective bytes are under "
                       "'analytic')",
}


def abstract_init(cfg, purpose):
    """Meta params and their spec tree (the reference's ``eval_shape`` of
    ``init_lm``)."""
    tree = lm.init_tree(cfg, torch.Generator(), purpose, "meta")
    return tree, spec_tree(tree)


def abstract_caches(cfg, B, S_max, enc_len=0):
    caches = lm.init_caches(cfg, device="meta", B=B, S_max=S_max,
                            enc_len=enc_len)
    return caches, lm.cache_axes_tree(cfg)


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


def _train_args(cfg, shape, mesh):
    params, axes = abstract_init(cfg, "train")
    with mesh_context(None):      # the whole (abstract) moments
        opt = adamw_init(params, AdamWConfig(
            state_dtype=cfg.opt_state_dtype))
    o_axes = opt_axes(axes, opt["m"], cfg.opt_state_dtype, mesh)
    bspecs = batch_specs(cfg, shape)
    bentry = (("data", "model") if cfg.pure_fsdp
              else batch_entry(shape.global_batch, mesh))
    batch_axes = {k: P(bentry, *([None] * (v.dim() - 1)))
                  for k, v in bspecs.items()}
    scalars = {"step": _scalar(torch.int32), "key": _scalar(torch.int32, 2)}
    return {"params": (params, axes), "opt_state": (opt, o_axes),
            "batch": (bspecs, batch_axes),
            "scalars": (scalars, {"step": P(), "key": P()})}


def _prefill_args(cfg, shape, mesh):
    params, axes = abstract_init(cfg, "serve")
    bspecs = batch_specs(cfg, shape)
    bentry = batch_entry(shape.global_batch, mesh)
    batch_axes = {k: P(bentry, *([None] * (v.dim() - 1)))
                  for k, v in bspecs.items()}
    return {"params": (params, axes), "batch": (bspecs, batch_axes)}


def _decode_args(cfg, shape, mesh):
    B, S = shape.global_batch, shape.seq_len
    params, axes = abstract_init(cfg, "serve")
    enc_len = ENC_LEN_DECODE if cfg.n_enc_layers else 0
    caches, cache_axes = abstract_caches(cfg, B, S, enc_len)
    cache_axes = fix_batch_axes(cache_axes, B, mesh)
    bentry = batch_entry(B, mesh)
    return {"params": (params, axes), "caches": (caches, cache_axes),
            "tokens": ({"tokens": _scalar(torch.int32, B, 1)},
                       {"tokens": P(bentry, None)}),
            "scalars": ({"pos": _scalar(torch.int32)}, {"pos": P()})}


def step_args(cfg, shape, mesh) -> dict:
    """The cell's abstract step arguments ``{name: (tree, spec tree)}``,
    the reference's jit arguments and in_shardings."""
    if shape.kind == "train":
        return _train_args(cfg, shape, mesh)
    if shape.kind == "prefill":
        return _prefill_args(cfg, shape, mesh)
    return _decode_args(cfg, shape, mesh)


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
    t0 = time.time()
    try:
        with fake_world(n_chips):
            mesh = make_production_mesh(multi_pod=multi_pod,
                                            device_type="cpu")
            with mesh_context(mesh):
                args = step_args(cfg, shape, mesh)
                mem = _local_bytes(args, mesh)
        # the port's lowering: the abstract arguments and their shards
        result["lower_s"] = time.time() - t0
        result["compile_s"] = None
        result["memory_analysis"] = dict(mem, **dict.fromkeys(NULL_MEMORY))
        result["cost_analysis"] = dict.fromkeys(
            ("flops", "bytes accessed", "transcendentals"))
        if not skip_hlo:
            result["hlo_collectives"] = dict.fromkeys(
                ("bytes_by_kind", "count_by_kind", "total_bytes"))
        result["reasons"] = {k: v for k, v in NULL_REASONS.items()
                             if not (skip_hlo and k == "hlo_collectives")}
        result["ok"] = True
    except Exception as e:  # a cell's failure is its result, not the run's
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-4000:]
        return result

    ana = analytic.analyze(cfg, shape, mesh_shape)
    rl = Roofline(flops=ana.flops, hbm_bytes=ana.hbm_bytes,
                  collective_bytes=ana.collective_bytes, n_chips=n_chips,
                  model_flops=analytic.model_flops_6nd(cfg, shape))
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
                    help="leave out the (null) HLO collectives block")
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
                arg = res.get("memory_analysis", {}).get(
                    "argument_size_in_bytes")
                print(f"{status} {tag} args/dev={arg} {extra}", flush=True)
    return n_fail


if __name__ == "__main__":
    main()
