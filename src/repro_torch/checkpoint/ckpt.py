"""Checkpointing in the reference's on-disk format (port of
``repro.checkpoint.ckpt``), so a checkpoint written by either package
restores in the other.

One ``step_<N>/`` directory (N zero-padded to 8 digits) per checkpoint:

- ``manifest.json``: step, sorted key list, shapes and dtypes, user
  metadata;
- ``arrays.npz``: '/'-joined path (dict keys, list indices) -> array.

Writes are atomic (a temporary directory renamed into place), so a
preemption mid-save never corrupts the latest checkpoint.  bf16 leaves
are stored as 2-byte void arrays, the bytes numpy writes for the
reference's ``ml_dtypes.bfloat16`` leaves; restore reads them back into
a bf16 leaf of the tree it is given.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Optional

import numpy as np
import torch


def _is_tree(x) -> bool:
    return hasattr(x, "tree") and callable(x.tree)


def _paths(tree, prefix=()):
    """``(path, leaf)`` pairs in the reference's order (sorted dict keys,
    list indices)."""
    if _is_tree(tree):
        tree = tree.tree()
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _to_numpy(t) -> np.ndarray:
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def save_checkpoint(ckpt_dir: str, step: int, tree,
                    metadata: Optional[dict] = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = {k: _to_numpy(v) for k, v in _paths(tree)}
    tmp = tempfile.mkdtemp(dir=ckpt_dir)
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {
            "step": int(step),
            "keys": sorted(flat.keys()),
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "dtypes": {k: str(v.dtype) for k, v in flat.items()},
            "metadata": metadata or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)           # atomic publish
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and os.path.exists(
                 os.path.join(ckpt_dir, d, "manifest.json"))]
    return max(steps) if steps else None


def _leaf(arr: np.ndarray, like, device) -> torch.Tensor:
    dtype = like.dtype if isinstance(like, torch.Tensor) else None
    if dtype == torch.bfloat16 or arr.dtype.name == "bfloat16" \
            or arr.dtype == np.dtype("V2"):
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, order="C", copy=True))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def _rebuild(like, leaves, device):
    if _is_tree(like):
        return type(like)(_rebuild(like.tree(), leaves, device),
                          trainable=like.trainable)
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves, device) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return [_rebuild(v, leaves, device) for v in like]
    return next(leaves)


def restore_checkpoint(ckpt_dir: str, like_tree, step: Optional[int] = None,
                       device="cuda"):
    """Restore into the structure of ``like_tree`` (nested dicts, lists,
    ``ParamTree``s), each leaf in the like leaf's dtype, on ``device``.
    Returns ``(tree, manifest)``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, "arrays.npz")) as data:
        leaves = [_leaf(data[key], like, device)
                  for key, like in _paths(like_tree)]
    return _rebuild(like_tree, iter(leaves), device), manifest
