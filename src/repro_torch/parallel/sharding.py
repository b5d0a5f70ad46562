"""Partition specs and shardings over ``torch.distributed`` (port of
``repro.parallel.sharding``).

Mesh axes are ``('pod', 'data', 'model')`` (multi-pod) or ``('data',
'model')`` (one pod).  A spec written against the multi-pod names degrades
gracefully: axes the active mesh lacks are dropped, so the same model code
runs on one device, one pod or the whole production mesh.

``PartitionSpec`` is the port's own: a tuple with one entry per tensor
dim, each ``None`` (replicated), a mesh axis name, or a tuple of names (the
dim split over all of them, the first name major, as JAX splits it).
``make_shardings`` turns specs into ``torch.distributed.tensor``
placements over a ``DeviceMesh``; a dim that does not divide its shard
count is refused, as the reference's lowering refuses it (DTensor would
split it unevenly).

Every param leaf carries its spec from the line that makes it
(``with_spec``; ``spec_tree`` reads a tree of them), so
``models.lm.param_axes`` derives from the init code itself.

The sharded serve and train paths hold plain local tensors, not DTensors:
``local_shard``/``local_tree`` cut a whole tensor (tree) into this rank's
block in JAX's order, each block tagged with its spec, which the model
code reads to pick its collectives.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch


def _entry(e):
    """A tuple of one name is that name (as JAX normalises it)."""
    if isinstance(e, (tuple, list)):
        return e[0] if len(e) == 1 else tuple(e)
    return e


class PartitionSpec(tuple):
    """``PartitionSpec('model', None)``: one entry per leading tensor dim
    (dims past the last entry are replicated)."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_entry(e) for e in entries))

    def __getnewargs__(self):       # copy and pickle rebuild entry-wise
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

# The active mesh (``launch.mesh.mesh_context``); None: no mesh.  Process
# wide, not a context variable: on the card autograd runs a backward (and
# the remat recompute inside it) on its own device thread, which must see
# the mesh its forward ran under.
_active = None


@contextlib.contextmanager
def active_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``) the one ``shard_hint`` reads."""
    global _active
    prev, _active = _active, mesh
    try:
        yield mesh
    finally:
        _active = prev


def mesh_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _active_axes() -> Optional[set]:
    """The active mesh's axis names, or None without one."""
    mesh = _active
    return None if mesh is None else set(mesh.mesh_dim_names)


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _filter_spec(spec: P, axes) -> P:
    """Drop mesh axes that don't exist in ``axes``."""
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
        elif isinstance(entry, tuple):
            kept = tuple(a for a in entry if a in axes)
            out.append(kept if kept else None)
        else:
            out.append(entry if entry in axes else None)
    return P(*out)


def tree_map_specs(fn, tree):
    """``fn`` on every spec of a tree of nested dicts and lists (a spec is
    a tuple, so it is a leaf here, never a container)."""
    if isinstance(tree, PartitionSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_specs(fn, v) for v in tree]
    raise TypeError(f"not a spec tree node: {type(tree).__name__}")


def filter_specs(tree, mesh):
    """Adapt a spec tree to a concrete mesh's axis names."""
    axes = set(mesh.mesh_dim_names)
    return tree_map_specs(lambda s: _filter_spec(s, axes), tree)


class NamedSharding:
    """A spec over a ``DeviceMesh``: its DTensor ``placements`` (a tensor
    dim split over several mesh axes is ``Shard(d)`` on each, in mesh
    order), the shard shape each rank holds, and ``distribute``."""

    def __init__(self, mesh, spec: P):
        from torch.distributed.tensor import Replicate, Shard

        self.mesh, self.spec = mesh, P(*spec)
        names = list(mesh.mesh_dim_names)
        placements = [Replicate()] * len(names)
        for d, entry in enumerate(self.spec):
            idx = []
            for a in _names(entry):
                if a not in names:
                    raise ValueError(f"spec {self.spec} names axis {a!r}, "
                                     f"not in the mesh's {tuple(names)}")
                idx.append(names.index(a))
            if idx != sorted(idx):
                # DTensor splits a dim over several mesh dims in mesh order
                raise ValueError(f"spec {self.spec}: entry {entry} splits "
                                 "a dim minor axis first; name its axes in "
                                 "the mesh's order")
            for i in idx:
                if not isinstance(placements[i], Replicate):
                    raise ValueError(f"spec {self.spec} uses mesh axis "
                                     f"{names[i]!r} twice")
                placements[i] = Shard(d)
        self.placements = tuple(placements)

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec}, {self.placements})"

    def shards(self, dim: int) -> int:
        """How many ways tensor dim ``dim`` is split."""
        if dim >= len(self.spec):
            return 1
        sizes = mesh_sizes(self.mesh)
        return math.prod(sizes[a] for a in _names(self.spec[dim]))

    def shard_shape(self, shape) -> tuple:
        """The shape every rank holds; raises where a dim does not divide
        its shard count (the reference's lowering refuses such a leaf)."""
        shape = tuple(shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than the "
                             f"shape {shape} has dims")
        out = []
        for d, n in enumerate(shape):
            k = self.shards(d)
            if n % k:
                raise ValueError(
                    f"sharding {self.spec} implies that dim {d} of shape "
                    f"{shape} divides by {k}, but it is {n}")
            out.append(n // k)
        return tuple(out)

    def distribute(self, tensor: torch.Tensor):
        """``distribute_tensor`` under these placements, after the
        divisibility check."""
        from torch.distributed.tensor import distribute_tensor

        self.shard_shape(tensor.shape)
        return distribute_tensor(tensor, self.mesh, self.placements)


def make_shardings(mesh, axes_tree):
    """Spec tree -> ``NamedSharding`` tree for a mesh."""
    return tree_map_specs(lambda s: NamedSharding(mesh, s),
                          filter_specs(axes_tree, mesh))


def current_mesh():
    """The active mesh (``launch.mesh.mesh_context``), or None."""
    return _active


def shard_hint(x, spec: P):
    """The reference's conditional ``with_sharding_constraint``: a no-op
    without an active mesh or with one whose axes all have size 1.  Under
    a larger mesh the sharded code holds its activations in the layouts
    the reference's hints name, so a hint states the layout ``x`` already
    has and returns it:

    - batch only, ``P(('pod', 'data'), None, ...)``: this rank's batch
      rows (the dense ``decode_step``'s and the train forward's
      embeddings; under ``pure_fsdp`` its rows of ('data', 'model'));
    - ``P(('pod', 'data'), 'model', None)``, the train forward's layer
      boundary: its rows and its sequence block on 'model' (Megatron-SP);
    - ``P(('data', 'model'), None, None)``, the same under ``pure_fsdp``:
      its rows of the batch split over both axes;
    - ``P(('pod', 'data'), None, 'model')``, the train logits: its rows
      and its block of the vocab (under ``pure_fsdp``, which has no
      tensor parallelism, the whole vocab of its rows).

    The MoE and MLA forwards, serve and train, and the recurrent, enc-dec
    and VLM serve forwards pass no hint of their own (the reference's pass
    none: GSPMD places their experts, latents and states by the params'
    and caches' specs), so the hints above cover them.  Any other hint
    raises: the paged forwards do not run sharded."""
    mesh = _active
    if mesh is None or mesh.size() == 1:
        return x
    spec = P(*spec)
    if ((len(spec) and spec[0] == ("pod", "data")
         and all(e is None for e in spec[1:])) or spec in _TRAIN_HINTS):
        return x
    raise NotImplementedError(
        f"shard_hint{tuple(spec)} under a mesh of {mesh.size()} devices: "
        "the port's model does not run sharded here (the paged forwards "
        "do not); the dense forwards hold their rows, the train forward "
        "its sequence and vocab blocks")


_TRAIN_HINTS = (P(("pod", "data"), "model", None),
                P(("data", "model"), None, None),
                P(("pod", "data"), None, "model"))


def batch_spec() -> P:
    return P(("pod", "data"), None)


def batch_entry(B: int, mesh):
    """The largest data-parallel axis combo of ``mesh`` that divides the
    batch ``B`` (None: the batch is replicated), as the reference's dry
    run picks it."""
    sizes = mesh_sizes(mesh)
    for c in (("pod", "data"), ("data",), ("pod",)):
        if all(a in sizes for a in c):
            n = math.prod(sizes[a] for a in c)
            if B % n == 0 and n > 1:
                return c
    return None


def fix_batch_axes(tree, B: int, mesh):
    """Replace the ``('pod', 'data')`` batch entries of a spec tree with
    ``batch_entry(B, mesh)`` (the reference's ``_fix_batch_axes``)."""
    entry = batch_entry(B, mesh)

    def fix(spec):
        return P(*(entry if isinstance(e, tuple) and set(e) == {"pod", "data"}
                   else e for e in spec))

    return tree_map_specs(fix, tree)


# ---------------------------------------------------------------------------
# this rank's blocks
# ---------------------------------------------------------------------------


def block_range(n: int, entry, mesh) -> tuple:
    """``(start, length)`` of this rank's block of a dim of size ``n`` whose
    spec entry is ``entry`` (the whole dim for None); raises where ``n``
    does not divide."""
    from repro_torch.launch.mesh import axis_index, axis_size

    k = axis_size(mesh, entry)
    if n % k:
        raise ValueError(f"a dim of {n} does not divide over {entry} "
                         f"({k} ranks)")
    return axis_index(mesh, entry) * (n // k), n // k


def local_shard(t: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` under ``spec``: each
    dim cut by its entry's axes (a tuple entry pod-major, as JAX cuts it;
    axes the mesh lacks are dropped), copied so the whole tensor can be
    freed.  The block carries ``spec`` (``with_spec``)."""
    spec = P(*spec)
    if len(spec) > t.dim():
        raise ValueError(f"spec {spec} has more entries than the shape "
                         f"{tuple(t.shape)} has dims")
    out = t
    for d, entry in enumerate(spec):
        if entry is not None:
            start, length = block_range(t.shape[d], entry, mesh)
            out = out.narrow(d, start, length)
    if out is not t:
        out = out.clone(memory_format=torch.contiguous_format)
    return with_spec(out, spec)


def local_tree(tree, specs, mesh):
    """``local_shard`` over a tree of nested dicts and lists and its spec
    tree (``lm.param_axes``, ``lm.cache_axes_tree``)."""
    if isinstance(tree, dict):
        return {k: local_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [local_tree(v, s, mesh) for v, s in zip(tree, specs)]
    return local_shard(tree, specs, mesh)


# ---------------------------------------------------------------------------
# specs carried by the leaves that get them
# ---------------------------------------------------------------------------

_SPEC_ATTR = "_partition_spec"


def with_spec(t: torch.Tensor, spec: P) -> torch.Tensor:
    """Tag a param leaf with its spec where it is made; returns ``t``.
    The tag is a plain tuple, so a saved tensor still loads under
    ``torch.load(weights_only=True)``."""
    setattr(t, _SPEC_ATTR, tuple(P(*spec)))
    return t


def spec_of(t: torch.Tensor) -> P:
    spec = getattr(t, _SPEC_ATTR, None)
    if spec is None:
        raise ValueError(f"leaf of shape {tuple(t.shape)} carries no "
                         "partition spec")
    return P(*spec)


def spec_tree(tree):
    """The spec tree of a tree of tagged tensors (nested dicts, lists)."""
    if isinstance(tree, dict):
        return {k: spec_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [spec_tree(v) for v in tree]
    return spec_of(tree)
