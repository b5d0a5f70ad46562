"""The port's dry run (``repro_torch.launch.dryrun``), its analytic
roofline (``launch/analytic.py``, ``launch/comm_analysis.Roofline``) and
``data.pipeline.batch_specs`` against the reference's.

The reference's side of the shardings runs once, in a subprocess with
512 forced host devices (``jax.make_mesh`` of the production meshes):
``NamedSharding(mesh, spec).shard_shape`` of every param leaf of the ten
LM configs (both purposes, both meshes), the rows four devices hold of
deepseek-v3's train leaves, and the per-device bytes of the step
arguments of two cells (the reference dry run's own abstract arguments
and shardings).  The port's dry run runs in a subprocess with ``jax``
and ``repro`` blocked from import.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget
from repro.configs import list_archs as jlist
from repro.data.pipeline import batch_specs as jbatch_specs
from repro.launch import analytic as janalytic
from repro.launch.hlo_analysis import Roofline as JRoofline

from repro_torch.configs import SHAPES, get_config
from repro_torch.data.pipeline import batch_specs
from repro_torch.launch import analytic
from repro_torch.launch.comm_analysis import H100, V5E, Roofline
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models import lm
from repro_torch.parallel.sharding import (NamedSharding, filter_specs,
                                           spec_tree)

import _torch_families  # noqa: F401  (one torch thread per worker)

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = [a for a in jlist() if a != "resnet18"]
MESHES = {"pod": (16, 16), "multipod": (2, 16, 16)}
CELLS = [("xlstm-350m", "decode_32k"), ("deepseek-v3-671b", "train_4k")]
ROW_RANKS = (0, 17, 300, 511)
# JAX's per-device bytes from its shard shapes, before the batch and
# scalars (params, then the other state: int8 moments or caches)
TABLE = {
    ("deepseek-v3-671b", "train_4k", "pod"): (11_568_835_008, 7_269_070_724),
    ("deepseek-v3-671b", "train_4k", "multipod"): (6_233_541_056,
                                                   4_397_624_452),
    ("xlstm-350m", "decode_32k", "pod"): (160_022_296, 44_411_520),
    ("xlstm-350m", "decode_32k", "multipod"): (160_022_296, 22_205_760),
}

JAX_SCRIPT = """
import json, sys
import repro.launch.dryrun as D      # sets 512 forced host devices
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import SHAPES, get_config
from repro.launch.mesh import make_production_mesh
from repro.parallel.sharding import filter_specs

ARCHS, CELLS, RANKS = json.loads(sys.argv[1])

def flat(tree, path=()):
    if isinstance(tree, P) or hasattr(tree, "shape"):
        yield "/".join(map(str, path)), tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat(v, path + (k,))
    else:
        for i, v in enumerate(tree):
            yield from flat(v, path + (i,))

def shard_shapes(shapes, axes, mesh):
    S = dict(flat(shapes))
    A = dict(flat(filter_specs(axes, mesh)))
    out = {}
    for k, spec in A.items():
        try:
            out[k] = list(NamedSharding(mesh, spec).shard_shape(
                S[k].shape))
        except ValueError as e:
            out[k] = str(e)
    return out, S, A

def nbytes(shapes, axes, mesh):
    sh, S, _ = shard_shapes(shapes, axes, mesh)
    return sum(int(np.prod(sh[k])) * S[k].dtype.itemsize for k in sh)

res = {"shapes": {}, "rows": {}, "cells": {}}
for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    mname = "multipod" if mp else "pod"
    for arch in ARCHS:
        for purpose in ("train", "serve"):
            shapes, axes = D.abstract_init(get_config(arch), purpose)
            res["shapes"][f"{arch}|{purpose}|{mname}"] = shard_shapes(
                shapes, axes, mesh)[0]
            if mp and arch == "deepseek_v3_671b" and purpose == "train":
                S = dict(flat(shapes))
                A = dict(flat(filter_specs(axes, mesh)))
                devs = {d.id: d for d in mesh.devices.flat}
                for k, spec in A.items():
                    m = NamedSharding(mesh, spec).devices_indices_map(
                        S[k].shape)
                    res["rows"][k] = {
                        r: [s.start or 0 for s in m[devs[r]]] for r in RANKS}
    for arch, sname in CELLS:
        cfg, shape = get_config(arch), SHAPES[sname]
        with D.mesh_context(mesh):
            if shape.kind == "train":
                tc = D.TrainConfig(adamw=D.AdamWConfig(
                    state_dtype=cfg.opt_state_dtype))
                params, axes = D.abstract_init(cfg, "train")
                opt = jax.eval_shape(lambda p: D.adamw_init(p, tc.adamw),
                                     params)
                other = nbytes(opt, D._opt_axes(axes, opt,
                                                cfg.opt_state_dtype, mesh),
                               mesh)
                bs = D.batch_specs(cfg, shape)
                be = D._batch_entry(shape.global_batch, mesh)
                rest = nbytes(bs, {k: P(be, *([None] * (len(v.shape) - 1)))
                                   for k, v in bs.items()}, mesh) + 4 + 8
            else:
                B, S_ = shape.global_batch, shape.seq_len
                params, axes = D.abstract_init(cfg, "serve")
                caches, cax = D.abstract_caches(cfg, B, S_, 0)
                other = nbytes(caches, D._fix_batch_axes(cax, B, mesh),
                               mesh)
                tok = jax.ShapeDtypeStruct((B, 1), jnp.int32)
                rest = nbytes({"t": tok}, {"t": P(D._batch_entry(B, mesh),
                                                  None)}, mesh) + 4
            res["cells"][f"{arch}|{sname}|{mname}"] = [
                nbytes(params, axes, mesh), other, rest]
json.dump(res, open(sys.argv[2], "w"))
"""

BLOCKED_SCRIPT = """
import importlib, json, pkgutil, sys
sys.modules["jax"] = None        # import jax / repro raise ImportError
sys.modules["repro"] = None
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
from repro_torch.launch import dryrun
n_fail = 0
for arch, shape in json.loads(sys.argv[1]):
    n_fail += dryrun.main(["--arch", arch, "--shape", shape, "--mesh",
                           "both", "--out", sys.argv[2]])
assert all(v is None for m, v in sys.modules.items()
           if m.split(".")[0] in ("jax", "repro"))
sys.exit(n_fail)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    arg = json.dumps([ARCHS, CELLS, ROW_RANKS])
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(JAX_SCRIPT), arg,
         str(tmp / "ref.json")],
        env=env, capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(tmp / "ref.json") as f:
        return json.load(f)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (i,))
    else:
        yield "/".join(map(str, path)), tree


def _port_shard_shapes(cfg, purpose, mesh):
    tree = lm.init_tree(cfg, torch.Generator(), purpose, "meta")
    T = dict(_flat(tree))
    A = dict(_flat(filter_specs(spec_tree(tree), mesh)))
    return T, {k: list(NamedSharding(mesh, A[k]).shard_shape(T[k].shape))
               for k in T if not k.endswith("table_narrow")}


def test_rank0_shard_shapes_equal_jax(ref):
    """Rank 0's shard shape of every param leaf, ten configs at full size,
    both purposes, on 16x16 and 2x16x16."""
    n = 0
    for mname, shape in MESHES.items():
        with fake_world(int(np.prod(shape))):
            mesh = make_production_mesh(multi_pod=len(shape) == 3,
                                            device_type="cpu")
            for arch in ARCHS:
                for purpose in ("train", "serve"):
                    _, got = _port_shard_shapes(get_config(arch), purpose,
                                                mesh)
                    want = ref["shapes"][f"{arch}|{purpose}|{mname}"]
                    assert got == want, (arch, purpose, mname)
                    n += len(want)
    assert n > 2000


def test_rows_each_rank_holds_equal_jax(ref):
    """The rows (offsets) ranks 0, 17, 300 and 511 hold of every train
    leaf of deepseek-v3 on 2x16x16 are those JAX's devices hold: a
    ('pod', 'data') dim splits pod-major, as JAX's."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    cfg = get_config("deepseek-v3-671b")
    assert len(ref["rows"]) == 88       # every train leaf
    assert any(max(v[str(r)]) > 0 for v in ref["rows"].values()
               for r in ROW_RANKS)
    for rank in ROW_RANKS:
        with fake_world(512, rank=rank):
            mesh = make_production_mesh(multi_pod=True,
                                            device_type="cpu")
            tree = lm.init_tree(cfg, torch.Generator(), "train", "meta")
            T = dict(_flat(tree))
            A = dict(_flat(filter_specs(spec_tree(tree), mesh)))
            for k, want in ref["rows"].items():
                sh = NamedSharding(mesh, A[k])
                _, off = compute_local_shape_and_global_offset(
                    T[k].shape, mesh, sh.placements)
                assert list(off) == want[str(rank)], (k, rank)


def test_dry_run_without_jax_equals_jax_bytes(ref, tmp_path):
    """The dry run, with jax and repro blocked from import (every port
    module imported so), on xlstm-350m decode_32k and deepseek-v3-671b
    train_4k over both meshes: ok, and rank 0's argument bytes equal the
    sum of JAX's shard-shape bytes over the same arguments."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(BLOCKED_SCRIPT),
         json.dumps(CELLS), str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-3000:])
    for arch, sname in CELLS:
        for mname in MESHES:
            with open(tmp_path / f"{arch}_{sname}_{mname}.json") as f:
                res = json.load(f)
            assert res["ok"], res.get("error")
            mem = res["memory_analysis"]
            params, other, rest = ref["cells"][f"{arch}|{sname}|{mname}"]
            assert (params, other) == TABLE[(arch, sname, mname)]
            by = mem["by_argument"]
            assert by["params"] == params
            assert sum(v for k, v in by.items() if k in (
                "opt_state", "caches")) == other
            assert mem["argument_size_in_bytes"] == params + other + rest
            assert mem["port_argument_size_in_bytes"] >= (
                mem["argument_size_in_bytes"] - params // 2)
            for key in ("output_size_in_bytes", "temp_size_in_bytes",
                        "total_nonalias_bytes"):
                assert mem[key] is None
                assert res["reasons"][f"memory_analysis.{key}"]
            assert res["cost_analysis"]["flops"] is None
            assert res["compile_s"] is None
            assert res["hlo_collectives"]["total_bytes"] is None
            assert res["reasons"]["cost_analysis"]
            assert res["reasons"]["hlo_collectives"]
            assert res["analytic"]["n_chips"] == int(np.prod(
                MESHES[mname]))


def test_analytic_equals_reference():
    """analyze, model_flops_6nd and the Roofline (under the reference's
    v5e constants) equal the reference's for every arch x shape x mesh;
    the default hardware is the H100's data sheet."""
    for arch in ARCHS:
        jc, tc = jget(arch), get_config(arch)
        for name in JSHAPES:
            js, ts = JSHAPES[name], SHAPES[name]
            assert janalytic.model_flops_6nd(jc, js) == (
                analytic.model_flops_6nd(tc, ts))
            for shape in MESHES.values():
                j = janalytic.analyze(jc, js, shape)
                t = analytic.analyze(tc, ts, shape)
                assert dataclasses.asdict(t) == dataclasses.asdict(j)
                n = int(np.prod(shape))
                kw = dict(flops=j.flops, hbm_bytes=j.hbm_bytes,
                          collective_bytes=j.collective_bytes, n_chips=n,
                          model_flops=janalytic.model_flops_6nd(jc, js))
                want = JRoofline(**kw).as_dict()
                got = Roofline(**kw, hardware=V5E).as_dict()
                assert {k: got[k] for k in want} == want
                assert got["hardware"] != Roofline(**kw).as_dict()["hardware"]
    assert Roofline(1.0, 1.0, 1.0, 1).hardware == H100


def test_batch_specs_equal_reference():
    for arch in ARCHS:
        for name in JSHAPES:
            j = jbatch_specs(jget(arch), JSHAPES[name])
            t = batch_specs(get_config(arch), SHAPES[name])
            assert j.keys() == t.keys()
            for k in j:
                assert t[k].device.type == "meta"
                assert tuple(t[k].shape) == tuple(j[k].shape)
                assert str(t[k].dtype).replace("torch.", "") == str(
                    j[k].dtype)
