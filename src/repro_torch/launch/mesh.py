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
"""

from __future__ import annotations

import contextlib

import torch.distributed as dist

# ``mesh_context(mesh)`` makes ``mesh`` the active one, the reference's
# ``jax.set_mesh`` (``parallel.sharding.shard_hint`` reads it)
from repro_torch.parallel.sharding import active_mesh as mesh_context  # noqa


def make_mesh_compat(shape, axes, device_type: str = "cpu"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    process group (ranks laid out row-major, as ``jax.make_mesh`` lays out
    host devices)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type="cpu"):
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
    return make_mesh_compat((1, 1), ("data", "model"))


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
