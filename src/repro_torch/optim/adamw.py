"""AdamW with a configurable state dtype: f32, bf16 or int8 block-quant
(port of ``repro.optim.adamw``).

Functions over a tree of tensors (nested dicts and lists, or a
``ParamTree``), leaf at a time as the reference, updating params and
state in place under ``torch.no_grad()`` (the reference returns new
arrays and donates the old).  Leaves are visited in the reference's
order (sorted dict keys), so the global norm sums in its order.  Under a
mesh (the sharded train step) every function runs on this rank's blocks,
and the moments follow the reference's shardings (``opt_axes``, the
reference's ``launch/dryrun.py::_opt_axes``): f32 and bf16 moments the
param's blocks; an int8 moment's ``q [..., N/256, 256]`` the param spec
with an unsharded block dim, each dim whose size does not divide its
shards replicated.  Where a rank holds such a whole dim of a sharded
param, ``adamw_update`` gathers the gradient over it, updates the whole
moment and applies its block of the update to the param block.  Whether a
moment is int8 is decided on the param's global shape; weight decay's
``p.dim() >= 2`` reads the local block, which keeps the global rank; and
``clip_by_global_norm`` sums the norm over the shards.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.optim.lowbit import (BLOCK, q8_compatible, q8_decode,
                                     q8_encode)
from repro_torch.parallel.sharding import (P, PartitionSpec, _names,
                                           current_mesh, mesh_sizes, spec_of,
                                           with_spec)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: str = "f32"   # f32 | bf16 | int8


def tree_leaves(tree) -> list:
    """The tensors of a tree in the reference's order (``jax.tree.leaves``:
    dict keys sorted, lists in order).  An int8 state's ``{'q', 'scale'}``
    dict is one node like any other dict."""
    if hasattr(tree, "tree"):
        tree = tree.tree()
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` on every tensor of a nested dict/list (or ``ParamTree``),
    the structure kept."""
    if hasattr(tree, "tree"):
        tree = tree.tree()
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def _param_nodes(params, state_tree):
    """``(param, state node)`` pairs: the state node of a param is a tensor
    or, for an int8 moment, its ``{'q', 'scale'}`` dict."""
    if hasattr(params, "tree"):
        params = params.tree()
    if isinstance(params, dict):
        return [x for k in sorted(params)
                for x in _param_nodes(params[k], state_tree[k])]
    if isinstance(params, (list, tuple)):
        return [x for p, s in zip(params, state_tree)
                for x in _param_nodes(p, s)]
    return [(params, state_tree)]


def _nshards(entry, sizes: dict) -> int:
    n = 1
    for a in _names(entry):
        n *= sizes.get(a, 1)
    return n


def _q_spec(pspec, qshape, sizes: dict) -> dict:
    """An int8 moment's ``{'q', 'scale'}`` specs: the param spec ``pspec``
    over ``q``'s dims (its block dim unsharded), an entry that does not
    divide its dim's size dropped."""
    entries = list(pspec) + [None] * (len(qshape) - len(pspec))
    q = [e if d % _nshards(e, sizes) == 0 else None
         for e, d in zip(entries, qshape)]
    return {"q": P(*q), "scale": P(*q[:-1])}


def opt_axes(param_axes, opt_m, state_dtype: str, mesh) -> dict:
    """The moments' spec tree (the reference's ``_opt_axes``): under int8
    each ``{'q', 'scale'}`` leaf of ``opt_m`` (the moments' tree, real or
    abstract) inherits its param's spec as ``_q_spec`` cuts it, an f32
    fallback leaf keeps the param spec; f32 and bf16 moments are the
    params' specs."""
    if state_dtype != "int8":
        return {"m": param_axes, "v": param_axes, "step": P()}
    sizes = mesh_sizes(mesh)

    def walk(ax, node):
        if isinstance(ax, PartitionSpec):
            if isinstance(node, dict) and "q" in node:
                return _q_spec(ax, node["q"].shape, sizes)
            return ax
        if isinstance(ax, dict):
            return {k: walk(v, node[k]) for k, v in ax.items()}
        return [walk(a, n) for a, n in zip(ax, node)]

    mv = walk(param_axes, opt_m)
    return {"m": mv, "v": mv, "step": P()}


def _moment_layout(p, dtype: str) -> tuple:
    """``(whole, q_spec)`` of param block ``p``'s moment under the active
    mesh: ``whole`` the ``(dim, axes)`` that ``p`` has sharded and its
    int8 moment holds whole (``_q_spec`` dropped their entries), ``q_spec``
    the int8 moment's ``{'q', 'scale'}`` specs, or None where the moment
    is not int8 blocks (decided on the global shape)."""
    sizes = mesh_sizes(current_mesh())
    spec = spec_of(p)
    shape = tuple(n * _nshards(e, sizes)
                  for n, e in zip(p.shape, list(spec) + [None] * p.dim()))
    if dtype != "int8" or not q8_compatible(shape):
        return (), None
    q_spec = _q_spec(spec, (*shape[:-1], shape[-1] // BLOCK, BLOCK), sizes)
    whole = tuple((d, e) for d, e in enumerate(spec)
                  if _nshards(e, sizes) > 1 and q_spec["q"][d] is None)
    return whole, q_spec


def _enc(x, dtype: str, sqrt_domain: bool = False, compatible=None):
    """``x`` in the state dtype; under int8 ``compatible`` (default: ``x``'s
    own shape) says whether it is block-quantised or stays f32."""
    if dtype == "bf16":
        return x.to(torch.bfloat16)
    if dtype == "int8":
        if not (q8_compatible(x) if compatible is None else compatible):
            return x      # small or odd tensors stay f32
        # v is stored in the sqrt domain: block-quantising raw v underflows
        # small entries to 0 and m/sqrt(v) explodes
        return q8_encode(torch.sqrt(x) if sqrt_domain else x)
    return x


def _dec(x, dtype: str, shape, sqrt_domain: bool = False):
    if dtype == "bf16":
        return x.to(torch.float32)
    if dtype == "int8" and isinstance(x, dict):
        y = q8_decode(x, shape)
        return torch.square(y) if sqrt_domain else y
    return x


def _store(node, value) -> None:
    """Write an encoded moment into its state node in place."""
    if isinstance(node, dict):
        node["q"].copy_(value["q"])
        node["scale"].copy_(value["scale"])
    else:
        node.copy_(value)


@torch.no_grad()
def adamw_init(params, cfg: AdamWConfig = AdamWConfig()) -> dict:
    """``{'m', 'v', 'step'}``: zero moments in ``cfg.state_dtype`` in the
    params' structure, a 0-d int32 step on the params' device.  Under the
    active mesh: this rank's moment blocks, tagged with their specs
    (``opt_axes``)."""
    mesh = current_mesh()
    dt = cfg.state_dtype

    def zeros(p, sq):
        if mesh is None:
            return _enc(torch.zeros_like(p, dtype=torch.float32), dt, sq)
        whole, q_spec = _moment_layout(p, dt)
        shape = list(p.shape)
        for d, e in whole:
            shape[d] *= _nshards(e, mesh_sizes(mesh))
        out = _enc(torch.zeros(shape, dtype=torch.float32, device=p.device),
                   dt, sq, compatible=q_spec is not None)
        if q_spec is None:
            return with_spec(out, spec_of(p))
        return {k: with_spec(v, q_spec[k]) for k, v in out.items()}

    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else "cpu"
    step = torch.zeros((), dtype=torch.int32, device=dev)
    return {"m": tree_map(lambda p: zeros(p, False), params),
            "v": tree_map(lambda p: zeros(p, True), params),
            "step": step if mesh is None else with_spec(step, P())}


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale every leaf by ``min(1, max_norm / max(norm, 1e-12))``, in
    place; the norm is the sqrt of the f32 sum of the leaves' sums of
    squares, summed leaf by leaf in the reference's order.  Returns
    ``(grads, norm)``.

    Under the active mesh the leaves are this rank's blocks, each tagged
    with its spec (``train.trainer``): a leaf's sum of squares is summed
    over the axes its spec shards it on (one all-reduce for the leaves of
    each set of axes), and a replicated leaf, the same on every rank, is
    counted once.  The norm is the global one on every rank."""
    leaves = tree_leaves(grads)
    sq = [torch.sum(torch.square(g.to(torch.float32))) for g in leaves]
    if current_mesh() is not None:
        sq = _sum_over_shards(leaves, sq)
    total = 0
    for v in sq:
        total = total + v
    gn = torch.sqrt(torch.as_tensor(total, dtype=torch.float32))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    for g in tree_leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, gn


def _sum_over_shards(leaves, sq):
    """Each leaf's sum of squares ``sq`` summed over the mesh axes its
    spec names."""
    from repro_torch.parallel import collectives as coll

    groups = {}
    for i, g in enumerate(leaves):
        axes = tuple(a for e in spec_of(g) for a in _names(e))
        groups.setdefault(axes, []).append(i)
    out = list(sq)
    for axes, idx in groups.items():
        if axes:
            red = coll.all_reduce(torch.stack([sq[i] for i in idx]), axes)
            for j, i in enumerate(idx):
                out[i] = red[j]
    return out


@torch.no_grad()
def adamw_update(params, grads, state, lr, cfg: AdamWConfig = AdamWConfig()):
    """One AdamW step, in place: moments ``m = b1 m + (1-b1) g`` and ``v =
    b2 v + (1-b2) g^2`` (f32 math, stored in ``cfg.state_dtype``; v in the
    sqrt domain under int8), bias-corrected update ``mh / (sqrt(vh) +
    eps)`` (clipped to +-5 under int8), decoupled weight decay on leaves
    of two or more dims, ``p -= lr * upd``.  ``lr`` is a float or a 0-d
    tensor.  Returns ``(params, state)``."""
    state["step"].add_(1)
    step = state["step"].to(torch.float32)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                      device=step.device), step)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                      device=step.device), step)
    lr = torch.as_tensor(lr, dtype=torch.float32)
    m_nodes = _param_nodes(params, state["m"])
    v_nodes = _param_nodes(params, state["v"])
    for (p, m_node), (_, v_node), g in zip(m_nodes, v_nodes,
                                          tree_leaves(grads)):
        g = g.to(torch.float32)
        whole = (_moment_layout(p, cfg.state_dtype)[0]
                 if current_mesh() is not None else ())
        if whole:
            from repro_torch.parallel import collectives as coll

            for d, axes in whole:     # the moment's whole dims
                g = coll.all_gather(g, axes, dim=d)
        q8 = isinstance(m_node, dict)
        m = _dec(m_node, cfg.state_dtype, g.shape)
        v = _dec(v_node, cfg.state_dtype, g.shape, True)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        upd = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        if cfg.state_dtype == "int8":
            # quantisation noise can still inflate m/sqrt(v)
            upd = torch.clamp(upd, -5.0, 5.0)
        for d, axes in whole:         # this rank's block of the update
            upd = coll.split(upd, axes, dim=d)
        if p.dim() >= 2:      # decoupled weight decay on matrices only
            upd = upd + cfg.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * upd)
        _store(m_node, _enc(m, cfg.state_dtype, compatible=q8))
        _store(v_node, _enc(v, cfg.state_dtype, True, compatible=q8))
    return params, state
