"""Gradient compression (port of ``repro.train.compress``): int8
stochastic-rounding quantise-dequantise per 1024-element block, with
error feedback.  Stochastic rounding keeps it unbiased: E[q8_sr(x)] = x.

The uniforms come from a ``torch.Generator``, or are passed in (``u``:
one ``[n_blocks, 1024]`` f32 tensor a leaf), so a test can feed the
reference's ``jax.random.uniform`` draws.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.optim.adamw import tree_leaves, tree_map

BLOCK = 1024


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
    drawn from ``gen`` when not given."""
    blk = _blocked(x.to(torch.float32))
    scale = torch.clamp(blk.abs().amax(dim=1, keepdim=True) / 127.0,
                        min=1e-12)
    y = blk / scale
    lo = torch.floor(y)
    frac = y - lo
    if u is None:
        u = torch.rand(y.shape, generator=gen, dtype=torch.float32,
                       device=y.device)
    q = torch.clamp(lo + (u < frac), -127, 127)
    out = (q * scale).reshape(-1)[: x.numel()].reshape(x.shape)
    return out.to(x.dtype)


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
    out = {}
    for leaf, e, u in zip(leaves, err, us):
        corrected = leaf.to(torch.float32)
        if e is not None:
            corrected = corrected + e
        q = q8_sr(corrected, gen, u)
        out[id(leaf)] = (q.to(leaf.dtype), corrected - q.to(torch.float32))
    return (tree_map(lambda t: out[id(t)][0], grads),
            tree_map(lambda t: out[id(t)][1], grads))
