"""Production meshes over ``torch.distributed`` (port of
``repro.launch.mesh``).

Functions, not module constants, so importing touches no process group.
A mesh needs a default process group whose world size is the mesh's
device count: real ranks (NCCL on cards, gloo on the CPU), or, for the
dry run's 256- and 512-device meshes in one process, a fake group
(``fake_world``, the counterpart of the reference's
``--xla_force_host_platform_device_count``).

Mesh axes:
    pod    outer data parallelism across pod boundaries
    data   in-pod data parallelism (+ FSDP param sharding)
    model  tensor / expert / sequence parallelism

A sharded forward addresses its collectives to named axes:
``axis_group(mesh, axes)`` is the process group of the ranks that differ
only on ``axes`` (a name, or a tuple of names: one group over all of
them, the first name major, as JAX splits a dim over ``('pod',
'data')``), ``axis_index`` this rank's coordinate on them and
``axis_size`` their size.  Axes the mesh lacks are dropped, as
``parallel.sharding`` drops them from a spec.
"""

from __future__ import annotations

import contextlib
import math

import torch.distributed as dist

# ``mesh_context(mesh)`` makes ``mesh`` the active one, the reference's
# ``jax.set_mesh`` (``parallel.sharding.shard_hint`` reads it)
from repro_torch.parallel.sharding import active_mesh as mesh_context  # noqa


def make_mesh_compat(shape, axes, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    process group (ranks laid out row-major, as ``jax.make_mesh`` lays out
    host devices)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_compat(shape, axes, device_type)


def make_host_mesh():
    """One-device mesh for CPU smoke runs (same axis names, all size 1).
    Starts a one-rank gloo group on an in-memory store when no process
    group exists."""
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    return make_mesh_compat((1, 1), ("data", "model"), device_type="cpu")


def _info(mesh):
    """``(axis names, sizes, this rank's coordinate)`` of a mesh, read once
    and kept on it (``DeviceMesh.mesh`` builds its rank tensor anew on
    each access, tens of microseconds, and the sharded forward asks per
    linear)."""
    info = mesh.__dict__.get("_repro_info")
    if info is None:
        info = mesh.__dict__["_repro_info"] = (
            tuple(mesh.mesh_dim_names), tuple(int(n) for n in mesh.mesh.shape),
            tuple(mesh.get_coordinate() or ()))
    return info


def mesh_axes(mesh, axes) -> tuple:
    """``axes`` (a name, a tuple of names or None) as the tuple of the
    names ``mesh`` has, in the order given."""
    if axes is None:
        return ()
    names = axes if isinstance(axes, (tuple, list)) else (axes,)
    return tuple(a for a in names if a in _info(mesh)[0])


def axis_size(mesh, axes) -> int:
    """How many ranks the named axes hold together (1 for none)."""
    names, shape, _ = _info(mesh)
    return math.prod(shape[names.index(a)] for a in mesh_axes(mesh, axes))


def axis_index(mesh, axes) -> int:
    """This rank's coordinate on the named axes, the first name major."""
    names, shape, coord = _info(mesh)
    idx = 0
    for a in mesh_axes(mesh, axes):
        d = names.index(a)
        idx = idx * shape[d] + coord[d]
    return idx


def axis_group(mesh, axes):
    """The process group of the ranks that differ from this one only on
    the named axes (ordered by ``axis_index``).  One axis: the mesh's own
    group of that dim; several: one group over all of them, made on first
    use by every rank of the mesh (each rank creates every such group, in
    the same order, as ``new_group`` needs), then cached on the mesh."""
    axes = mesh_axes(mesh, axes)
    if not axes:
        raise ValueError("axis_group: no axis of the mesh named")
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    cache = mesh.__dict__.setdefault("_repro_axis_groups", {})
    if axes not in cache:
        names = list(mesh.mesh_dim_names)
        dims = [names.index(a) for a in axes]
        rest = [d for d in range(len(names)) if d not in dims]
        # [other coords..., axes...] -> one row of ranks per group
        ranks = mesh.mesh.permute(*rest, *dims).reshape(
            -1, math.prod(int(mesh.mesh.shape[d]) for d in dims))
        me = dist.get_rank()
        for row in ranks.tolist():
            g = dist.new_group(row)
            if me in row:
                cache[axes] = g
    return cache[axes]


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """A fake default process group of ``world_size`` ranks in this one
    process (``torch.testing``'s ``FakeStore``, backend ``'fake'``):
    meshes and DTensor placements build, no collective moves data.  For
    the dry run's abstract production meshes; destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group already exists")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
