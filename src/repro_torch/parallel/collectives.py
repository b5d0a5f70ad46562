"""Collectives over named mesh axes, on plain local tensors.

The reference has no file of its own for these: it jits a step with the
shardings of its specs and GSPMD inserts the all-gathers and all-reduces
into the compiled graph.  The port's sharded serve path is explicit
per-rank code instead (``models.nn``, ``models.attention``,
``models.lm`` under ``launch.mesh.mesh_context``), and every collective it
issues goes through this module: ``torch.distributed`` on the process
group of the named axes (``launch.mesh.axis_group``), NCCL on cards and
gloo on the CPU.

Each call names a mesh axis or a tuple of them (``('pod', 'data')``: one
group over both, pod-major); axes the active mesh lacks are dropped.
Under an active mesh a call is always issued, even over an axis of size
1, so one card runs the code that a larger mesh runs.  Each call is
counted by ``launch.comm_analysis.record_collectives`` (kind, bytes,
count; ``param=True`` also counts it as a parameter collective).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.comm_analysis import note_collective
from repro_torch.parallel.sharding import current_mesh

# dtypes both NCCL and gloo move as they are; a gather moves any other as
# its bytes (a copy, so the bits are kept)
_WIRE_DTYPES = (torch.int8, torch.uint8, torch.int32, torch.int64,
                torch.float16, torch.bfloat16, torch.float32, torch.float64)
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def _mesh():
    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError("a collective needs an active mesh "
                           "(launch.mesh.mesh_context)")
    return mesh


def size(axes) -> int:
    """The size of the named axes of the active mesh."""
    return mesh_mod.axis_size(_mesh(), axes)


def index(axes) -> int:
    """This rank's coordinate on the named axes of the active mesh."""
    return mesh_mod.axis_index(_mesh(), axes)


def all_gather(t: torch.Tensor, axes, dim: int = -1,
               param: bool = False) -> torch.Tensor:
    """The blocks of ``t`` of every rank of ``axes``, concatenated along
    ``dim`` in axis order (the inverse of ``sharding.local_shard``)."""
    mesh = _mesh()
    if not mesh_mod.mesh_axes(mesh, axes):
        return t
    group = mesh_mod.axis_group(mesh, axes)
    n = dist.get_world_size(group)
    src = t.contiguous().reshape(1, *t.shape, 1)
    if src.dtype not in _WIRE_DTYPES:   # int16 plans move as their bytes
        src = src.view(torch.uint8)
    buf = torch.empty((n, *src.shape[1:]), dtype=src.dtype, device=t.device)
    dist.all_gather_into_tensor(buf, src, group=group)   # blocks along dim 0
    # the blocks' axis just before ``dim``, then merged into it: a view
    # where no reordering is needed (dim 0, or one rank), else one copy
    d = dim % t.dim()
    shape = (*t.shape[:d], n * t.shape[d], *t.shape[d + 1:])
    out = buf.view(t.dtype)[..., 0].movedim(0, d).reshape(shape)
    note_collective("all-gather", out, param)
    return out


def all_reduce(t: torch.Tensor, axes, op: str = "sum") -> torch.Tensor:
    """``t`` reduced (``'sum'``, ``'max'`` or ``'min'``) over the ranks of
    ``axes``; returns a new tensor (``t`` is left as it was)."""
    mesh = _mesh()
    if not mesh_mod.mesh_axes(mesh, axes):
        return t
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=_OPS[op], group=mesh_mod.axis_group(mesh, axes))
    note_collective("all-reduce", out)
    return out


def reduce_scatter(t: torch.Tensor, axes, dim: int = -1) -> torch.Tensor:
    """This rank's block along ``dim`` of ``t`` summed over the ranks of
    ``axes`` (``dim`` must divide by their size)."""
    mesh = _mesh()
    if not mesh_mod.mesh_axes(mesh, axes):
        return t
    group = mesh_mod.axis_group(mesh, axes)
    n = dist.get_world_size(group)
    if t.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} "
                         f"does not divide over {n} ranks")
    src = torch.stack(t.chunk(n, dim=dim)).contiguous()   # blocks on dim 0
    out = torch.empty((1, *src.shape[1:]), dtype=t.dtype, device=t.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    note_collective("reduce-scatter", src)
    return out[0]
