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
count; ``param=True`` also counts it as a parameter collective,
``backward=True`` as one a backward issued).

The sharded train step differentiates through its collectives: the
``*_ad`` forms below are ``torch.autograd.Function``s.  Their backward
follows what the forward's output feeds, as Megatron-LM's regions do:

- ``all_gather_ad``: gathers blocks whose gathered whole feeds work that
  each rank does on its own part (a column-parallel linear, this rank's
  batch rows): each rank's gradient of the whole is a partial sum, and
  the backward reduce-scatters them, in f32 (the sequence-parallel
  gather, the FSDP gather of a weight);
- ``reduce_scatter_ad``: this rank's block of a sum of partials (a
  row-parallel linear's output onto the sequence block); the backward
  all-gathers the blocks' gradients, which each partial receives whole;
- ``all_reduce_ad``: the sum of partials, replicated and read alike on
  every rank (the vocab-parallel embedding rows, the loss's sums); the
  backward passes each rank's gradient through (Megatron's ``g``);
- ``grad_all_reduce``: the identity forward of a replicated tensor whose
  users each give a partial gradient; the backward sums them
  (Megatron's ``f``);
- ``sum_partials_ad``: the sum of partials, replicated, where each rank
  then uses only its part of the sum (its rows, its channels): the
  backward sums the ranks' gradients (an all-reduce each way);
- ``split_ad``: this rank's block of a replicated tensor; the backward
  all-gathers the blocks' gradients;
- ``all_reduce_max``: a max with no gradient (the loss's max, held
  constant as the reference holds it).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.comm_analysis import collective_call, note_collective
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
               param: bool = False, backward: bool = False) -> torch.Tensor:
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
    with collective_call():     # the blocks along dim 0
        dist.all_gather_into_tensor(buf, src, group=group)
    # the blocks' axis just before ``dim``, then merged into it: a view
    # where no reordering is needed (dim 0, or one rank), else one copy
    d = dim % t.dim()
    shape = (*t.shape[:d], n * t.shape[d], *t.shape[d + 1:])
    out = buf.view(t.dtype)[..., 0].movedim(0, d).reshape(shape)
    note_collective("all-gather", out, param, backward)
    return out


def all_reduce(t: torch.Tensor, axes, op: str = "sum",
               backward: bool = False, inplace: bool = False) -> torch.Tensor:
    """``t`` reduced (``'sum'``, ``'max'`` or ``'min'``) over the ranks of
    ``axes``; returns a new tensor (``t`` is left as it was), or with
    ``inplace`` ``t`` itself reduced (a contiguous tensor the caller
    owns: no copy)."""
    mesh = _mesh()
    if not mesh_mod.mesh_axes(mesh, axes):
        return t
    out = t if inplace else t.clone(memory_format=torch.contiguous_format)
    with collective_call():
        dist.all_reduce(out, op=_OPS[op],
                        group=mesh_mod.axis_group(mesh, axes))
    note_collective("all-reduce", out, backward=backward)
    return out


def reduce_scatter(t: torch.Tensor, axes, dim: int = -1, param: bool = False,
                   backward: bool = False) -> torch.Tensor:
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
    with collective_call():
        dist.reduce_scatter_tensor(out, src, group=group)
    note_collective("reduce-scatter", src, param, backward)
    return out[0]


def split(t: torch.Tensor, axes, dim: int = -1) -> torch.Tensor:
    """This rank's block along ``dim`` of a tensor whole on every rank of
    ``axes`` (no data moves; ``dim`` must divide by their size)."""
    n = size(axes)
    if t.shape[dim] % n:
        raise ValueError(f"split: dim {dim} of {tuple(t.shape)} does not "
                         f"divide over {n} ranks")
    k = t.shape[dim] // n
    return t.narrow(dim, index(axes) * k, k)


# ---------------------------------------------------------------------------
# the same with gradients (the sharded train step)
# ---------------------------------------------------------------------------


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axes, dim, param):
        ctx.axes, ctx.dim, ctx.param = axes, dim, param
        return all_gather(t, axes, dim, param)

    @staticmethod
    def backward(ctx, g):
        # partial gradients of a bf16 whole are summed in f32, rounded once
        g32 = reduce_scatter(g.float(), ctx.axes, ctx.dim, ctx.param, True)
        return g32.to(g.dtype), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axes, dim):
        ctx.axes, ctx.dim = axes, dim
        return reduce_scatter(t, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.axes, ctx.dim, backward=True), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axes):
        return all_reduce(t, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GradAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axes):
        ctx.axes = axes
        return t

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axes, backward=True), None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axes, dim):
        ctx.axes, ctx.dim = axes, dim
        return split(t, axes, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.axes, ctx.dim, backward=True), None, None


def _live(axes) -> bool:
    """Whether the active mesh has any of ``axes`` (else the op is the
    identity and no collective is issued)."""
    return bool(mesh_mod.mesh_axes(_mesh(), axes))


def all_gather_ad(t: torch.Tensor, axes, dim: int = -1,
                  param: bool = False) -> torch.Tensor:
    """``all_gather`` whose backward reduce-scatters the gradient (each
    rank's gradient of the whole is a partial sum)."""
    return _AllGather.apply(t, axes, dim, param) if _live(axes) else t


def reduce_scatter_ad(t: torch.Tensor, axes, dim: int = -1) -> torch.Tensor:
    """``reduce_scatter`` whose backward all-gathers the gradient."""
    return _ReduceScatter.apply(t, axes, dim) if _live(axes) else t


def all_reduce_ad(t: torch.Tensor, axes) -> torch.Tensor:
    """The sum over ``axes``; the backward passes the gradient through."""
    return _AllReduce.apply(t, axes) if _live(axes) else t


def grad_all_reduce(t: torch.Tensor, axes) -> torch.Tensor:
    """``t`` itself; the backward sums the gradient over ``axes``."""
    return _GradAllReduce.apply(t, axes) if _live(axes) else t


def sum_partials_ad(t: torch.Tensor, axes) -> torch.Tensor:
    """The sum over ``axes`` of partials whose sum each rank uses only in
    part; the backward sums the gradient over ``axes`` too."""
    return grad_all_reduce(all_reduce_ad(t, axes), axes)


def split_ad(t: torch.Tensor, axes, dim: int = -1) -> torch.Tensor:
    """``split`` whose backward all-gathers the gradient."""
    return _Split.apply(t, axes, dim) if _live(axes) else t


def all_reduce_max(t: torch.Tensor, axes) -> torch.Tensor:
    """The max over ``axes``, detached: no gradient flows through it."""
    return all_reduce(t.detach(), axes, "max")
