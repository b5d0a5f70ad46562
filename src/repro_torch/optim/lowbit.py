"""Block-wise 8-bit optimizer-state quantisation, 8-bit-Adam style (port
of ``repro.optim.lowbit``).

Blocks split the LAST axis (``x [..., N] -> q [..., N/256, 256]``), never
a flatten, as in the reference (whose sharding needs the leading dims
intact); the port keeps the layout so the state converts leaf for leaf.
Tensors whose last dim is not a multiple of 256 (norm scales, biases,
steps) stay f32.
"""

from __future__ import annotations

import torch

BLOCK = 256


def q8_compatible(x) -> bool:
    """Whether a tensor, or a shape, takes int8 blocks: a last dim that is
    a positive multiple of 256."""
    shape = tuple(x.shape) if isinstance(x, torch.Tensor) else tuple(x)
    return len(shape) >= 1 and shape[-1] % BLOCK == 0 and shape[-1] > 0


def q8_encode(x: torch.Tensor) -> dict:
    """``[..., N]`` -> ``{'q': int8 [..., N/256, 256], 'scale': f32
    [..., N/256]}``: absmax / 127 a block (at least 1e-12), codes rounded
    half to even and clipped to +-127."""
    if not q8_compatible(x):
        raise ValueError(f"q8_encode needs a last dim that is a multiple "
                         f"of {BLOCK}, got shape {tuple(x.shape)}")
    blk = x.reshape(*x.shape[:-1], x.shape[-1] // BLOCK, BLOCK)
    scale = torch.clamp(blk.abs().amax(dim=-1) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(blk / scale[..., None]), -127, 127)
    return {"q": q.to(torch.int8), "scale": scale}


def q8_decode(enc: dict, shape) -> torch.Tensor:
    blk = enc["q"].to(torch.float32) * enc["scale"][..., None]
    return blk.reshape(shape)
