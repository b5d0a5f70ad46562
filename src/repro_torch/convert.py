"""Convert the JAX package's params (serve LMs, ResNet) and paged pools
into the port's tensors.  Compiled TLMAC plans are numpy on both sides
and need no conversion.

Inputs are the JAX pytrees already turned into nested dicts and lists of
numpy arrays (``jax.tree.map(np.asarray, tree)``): this module imports
nothing of JAX.  bf16 leaves arrive as ``ml_dtypes.bfloat16`` arrays,
which ``torch.from_numpy`` rejects, so they are viewed as ``uint16`` and
reinterpreted as ``torch.bfloat16`` (bit-exact).

``params_from_jax`` stores ``embed``/``head`` in bf16 although JAX keeps
them in f32: every use casts them to bf16 first (``embed_apply``,
``logits_apply``), so storing the rounded values keeps every number the
forward computes, at half the memory.  After the JAX tree is mirrored
leaf for leaf, every TLMAC serve linear gains one derived leaf,
``table_narrow`` (``kernels.tlmac_fused.narrow_table`` of its table),
which the lookup kernel reads.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.tlmac_fused import narrow_table
from repro_torch.models.nn import ParamTree


def to_torch(a, device="cuda") -> torch.Tensor:
    """One numpy leaf -> tensor of the same dtype and bits."""
    a = np.array(a, order="C", copy=True)   # keeps 0-d leaves 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _tree(x, device):
    if isinstance(x, dict):
        return {k: _tree(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree(v, device) for v in x]
    return to_torch(x, device)


def _add_narrow_tables(x):
    if isinstance(x, dict):
        if "table" in x and "exec_idx" in x:
            x["table_narrow"] = narrow_table(x["table"])
        for v in x.values():
            _add_narrow_tables(v)
    elif isinstance(x, list):
        for v in x:
            _add_narrow_tables(v)


def params_from_jax(tree, device="cuda") -> ParamTree:
    """JAX serve params (``lm.init_lm(..., purpose='serve')[0]`` as numpy)
    -> the port's ``ParamTree``, plus each serve linear's
    ``table_narrow``."""
    p = _tree(tree, device)
    for name in ("embed", "head"):
        if name in p:
            p[name] = {"emb": p[name]["emb"].to(torch.bfloat16)}
    _add_narrow_tables(p)
    return ParamTree(p)


def pool_from_jax(tree, device="cuda"):
    """JAX paged caches (``lm.init_caches(..., paged=spec)[0]`` as numpy:
    a list per segment of ``{'b0': {'k', 'v'[, 'ks', 'vs']}}``) -> the
    same structure of tensors."""
    return _tree(tree, device)


def resnet_params_from_jax(tree, device="cuda"):
    """JAX ResNet params (``resnet.init_resnet(key, cfg)`` as numpy) -> the
    port's nested dict of float32 tensors, same structure and bits."""
    return _tree(tree, device)
