"""Gradient compression (port of ``repro.train.compress``): int8
stochastic-rounding quantise-dequantise per 1024-element block, with
error feedback.  Stochastic rounding keeps it unbiased: E[q8_sr(x)] = x.

The uniforms come from a ``torch.Generator``, or are passed in (``u``:
one ``[n_blocks, 1024]`` f32 tensor a leaf), so a test can feed the
reference's ``jax.random.uniform`` draws.

Under the active mesh (the sharded train step) every leaf is this rank's
block of the global gradient, tagged with its spec, and the result is
that block of the unsharded compression of the global leaf: the blocks
of 1024 are the flattened global leaf's, and the uniforms its draw.  A
leaf's uniforms are drawn ``CHUNK`` at a time, sharded or not; under a
mesh each rank runs through every chunk of the global draw from the
same generator and keeps only its own elements, so it never holds more
than one chunk of the others' (each rank spends the whole leaf's draw in
time, not in memory).  The rank's elements are runs of the flattened
global leaf (from its last sharded dim ``d`` on, ``local[d] *
prod(shape[d + 1:])`` elements each).  Where a run's length is a
multiple of 1024 they are whole global blocks and are compressed in
place (``_LOCAL``); else each global block's absmax is the max of its
ranks' partial maxima, one all-reduce of a float a block over the
leaf's axes (``_REDUCE``), and each rank quantises its own elements.
``test_torch_sharded_train.py::test_deepseek_v3_compression_routes``
counts deepseek-v3's leaves by route on its production mesh.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.parallel.sharding import current_mesh, spec_of, with_spec

BLOCK = 1024
CHUNK = 1 << 24   # uniforms drawn at a time: a multiple of BLOCK


def _blocked(x: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, BLOCK)


def q8_sr(x: torch.Tensor, gen: Optional[torch.Generator] = None,
          u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int8 stochastic-round quantise-dequantise (per 1024-block absmax
    scale), in ``x``'s dtype.  ``u``: the uniforms ``[n_blocks, 1024]``;
    drawn from ``gen`` when not given.  Works in place on its own copies,
    so it holds about three f32 copies of ``x`` and the uniforms."""
    blk = _blocked(x.to(torch.float32))
    scale = torch.clamp(blk.abs().amax(dim=1, keepdim=True) / 127.0,
                        min=1e-12)
    y = blk / scale
    lo = torch.floor(y)
    frac = y.sub_(lo)
    if u is None:
        u = _draw(gen, y.shape[0], y.device)
    q = lo.add_(u < frac).clamp_(-127, 127)
    del y, frac
    out = q.mul_(scale).reshape(-1)[: x.numel()].reshape(x.shape)
    return out.to(x.dtype)


def _draw(gen, n_blocks: int, device) -> torch.Tensor:
    out = torch.empty((n_blocks * BLOCK,), dtype=torch.float32,
                      device=device)
    for a in range(0, out.numel(), CHUNK):
        out[a:a + CHUNK].uniform_(generator=gen)
    return out.view(n_blocks, BLOCK)


_LOCAL, _REDUCE = "local", "reduce"


def _sharded_dims(t) -> list:
    """``(dim, axes)`` of each dim the active mesh shards block ``t`` on
    (more than one rank)."""
    from repro_torch.parallel import collectives as coll

    return [(d, e) for d, e in enumerate(spec_of(t))
            if e is not None and coll.size(e) > 1]


def compress_route(t) -> str:
    """How a gradient block ``t`` under the active mesh is compressed:
    ``_LOCAL`` where its rank's elements are runs of whole global blocks,
    else ``_REDUCE``.  The runs are the block's elements from its last
    sharded dim on, ``prod(t.shape[d:])`` each, and every run starts at a
    multiple of its length in the flattened global leaf: so they are
    whole blocks where that length is a multiple of 1024 (or where no dim
    is sharded)."""
    dims = _sharded_dims(t)
    if not dims:
        return _LOCAL
    return (_LOCAL if math.prod(t.shape[dims[-1][0]:]) % BLOCK == 0
            else _REDUCE)


def _runs(x, dims) -> tuple:
    """``(starts, length)``: the index in the flattened global leaf of the
    first element of each run of this rank's block ``x`` (int64, on the
    host, increasing), and the runs' length."""
    from repro_torch.parallel import collectives as coll

    d = dims[-1][0]
    axes = dict(dims)
    stride = math.prod(x.shape[d + 1:])      # unsharded past ``d``
    starts = torch.zeros((), dtype=torch.int64)
    for i in range(d, -1, -1):
        n = x.shape[i] if i < d else 1
        off = coll.index(axes[i]) * x.shape[i] if i in axes else 0
        starts = (starts + (off + torch.arange(n)).reshape(
            (n,) + (1,) * (d - i)) * stride)
        stride *= x.shape[i] * (coll.size(axes[i]) if i in axes else 1)
    return starts.reshape(-1), math.prod(x.shape[d:])


def _uniforms_at(gen, n_blocks: int, starts, length: int, w: int,
                 device) -> torch.Tensor:
    """The elements ``starts[r] + j`` (``j < length``) of a leaf's draw
    of ``n_blocks`` blocks (``_draw``), ``[len(starts), length]``: the
    chunks drawn in turn, each kept only where it meets a run.  ``w``
    divides every start and the length (``BLOCK`` where the runs are
    whole blocks: rows of ``w`` move together)."""
    n, step = n_blocks * BLOCK // w, CHUNK // w
    starts, length = starts // w, length // w
    ends = starts + length
    out = torch.empty((starts.numel(), length, w), dtype=torch.float32,
                      device=device)
    cols = torch.arange(length, device=device)
    for a in range(0, n, step):
        rows = min(step, n - a)
        chunk = torch.empty((rows * w,), dtype=torch.float32,
                            device=device).uniform_(generator=gen)
        chunk, b = chunk.view(rows, w), a + rows
        lo = int(torch.searchsorted(ends, a, right=True))
        hi = int(torch.searchsorted(starts, b))
        if length > step:        # long runs: a few meet each chunk
            for r in range(lo, hi):
                s = int(starts[r])
                i, j = max(s, a), min(s + length, b)
                out[r, i - s:j - s] = chunk[i - a:j - a]
        elif lo < hi:
            idx = starts[lo:hi].to(device)[:, None] + cols
            hit = ((idx >= a) & (idx < b))[..., None]
            got = chunk[(idx - a).clamp_(0, rows - 1)]
            out[lo:hi] = torch.where(hit, got, out[lo:hi])
    return out.view(starts.numel(), -1)


def _q8_sr_runs(x, starts, length: int, n_blocks: int, u, axes):
    """``q8_sr`` of the global leaf on this rank's runs ``x`` ([runs,
    length], f32) that are not whole blocks: each global block's absmax
    the max over ``axes`` of every rank's max over its own elements, then
    each element quantised as ``q8_sr`` quantises it (``u`` its
    uniforms, [runs, length])."""
    from repro_torch.parallel import collectives as coll

    group = max(1, CHUNK // length)
    cols = torch.arange(length, device=x.device)

    def pieces():   # each group of runs and its elements' block ids
        for r in range(0, starts.numel(), group):
            yield r, (starts[r:r + group].to(x.device)[:, None]
                      + cols) // BLOCK

    amax = torch.zeros((n_blocks,), dtype=torch.float32, device=x.device)
    for r, ids in pieces():
        amax.scatter_reduce_(0, ids.reshape(-1),
                             x[r:r + group].abs().reshape(-1), "amax")
    scale = torch.clamp(coll.all_reduce(amax, axes, "max", inplace=True)
                        / 127.0, min=1e-12)
    out = torch.empty_like(x)
    for r, ids in pieces():
        sc = scale[ids]
        y = x[r:r + group] / sc
        lo = torch.floor(y)
        q = lo.add_(u[r:r + group] < y.sub_(lo)).clamp_(-127, 127)
        out[r:r + group] = q.mul_(sc)
    return out


def _q8_sr_block(x, gen, u):
    """``q8_sr`` of the global leaf whose block under the active mesh is
    ``x`` (f32, tagged): this rank's block of the result.  ``u`` the global
    leaf's uniforms, or None to draw them from ``gen``."""
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.sharding import local_shard

    dims = _sharded_dims(x)
    if not dims:
        return q8_sr(x, gen, u)
    mesh, spec = current_mesh(), spec_of(x)
    shape = list(x.shape)
    for d, e in dims:
        shape[d] *= coll.size(e)
    numel = math.prod(shape)
    n_blocks = -(-numel // BLOCK)
    starts, length = _runs(x, dims)
    route = compress_route(x)
    if u is None:
        u = _uniforms_at(gen, n_blocks, starts, length,
                         BLOCK if route == _LOCAL else 1, x.device)
    else:
        u = local_shard(u.reshape(-1)[:numel].reshape(shape), spec, mesh)
    if route == _LOCAL:
        return q8_sr(x, u=u.reshape(-1, BLOCK))
    axes = tuple(a for _, e in dims
                 for a in (e if isinstance(e, tuple) else (e,)))
    out = _q8_sr_runs(x.reshape(starts.numel(), length), starts, length,
                      n_blocks, u.reshape(starts.numel(), length), axes)
    return out.reshape(x.shape)
@torch.no_grad()
def compress_grads(grads, gen: Optional[torch.Generator] = None,
                   error_state=None,
                   uniforms: Optional[Sequence[torch.Tensor]] = None):
    """QDQ every gradient leaf (leaves in the reference's order); error
    feedback carries each leaf's residual ``corrected - q`` to the next
    call.  ``uniforms``: one tensor a leaf for ``q8_sr``'s ``u``.
    Returns ``(compressed_grads, new_error_state)``, new trees."""
    leaves = tree_leaves(grads)
    err = (tree_leaves(error_state) if error_state is not None
           else [None] * len(leaves))
    us = list(uniforms) if uniforms is not None else [None] * len(leaves)
    sharded = current_mesh() is not None
    out = {}
    for leaf, e, u in zip(leaves, err, us):
        corrected = leaf.to(torch.float32)
        if e is not None:
            corrected = corrected + e
        if sharded:
            spec = spec_of(leaf)
            q = _q8_sr_block(with_spec(corrected, spec), gen, u)
            out[id(leaf)] = (with_spec(q.to(leaf.dtype), spec),
                             with_spec(corrected - q.to(torch.float32), spec))
            continue
        q = q8_sr(corrected, gen, u)
        out[id(leaf)] = (q.to(leaf.dtype), corrected - q.to(torch.float32))
    return (tree_map(lambda t: out[id(t)][0], grads),
            tree_map(lambda t: out[id(t)][1], grads))
