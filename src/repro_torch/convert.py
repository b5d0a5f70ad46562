"""Convert the JAX package's params (serve and train LMs, ResNet), AdamW
state, paged pools and dense caches into the port's tensors, and the
port's trees back into numpy (``to_numpy``).  Compiled TLMAC plans are
numpy on both sides and need no conversion.

Inputs are the JAX pytrees already turned into nested dicts and lists of
numpy arrays (``jax.tree.map(np.asarray, tree)``): this module imports
nothing of JAX.  bf16 leaves arrive as ``ml_dtypes.bfloat16`` arrays,
which ``torch.from_numpy`` rejects, so they are viewed as ``uint16`` and
reinterpreted as ``torch.bfloat16`` (bit-exact).

``params_from_jax`` stores ``embed``/``head`` in bf16 although JAX keeps
them in f32: every use casts them to bf16 first (``embed_apply``,
``logits_apply``), so storing the rounded values keeps every number the
forward computes, at half the memory.  Every other leaf is mirrored as
it is: each serve linear's layout (TLMAC plans, ``w8``/``w_step``/
``a_step`` of int8, bf16 ``w`` of dense, mixed within one tree), a MoE
layer's expert-stacked linears (leaves ``[L, E, ...]``), the ``front``
leaf of a VLM or enc-dec config (the train-path linear's qdq leaves:
``w``, ``w_step``, ``aq`` with its ``deltas`` and ``out_step``), an MLA
block's dense ``wkv_b`` and norms, the recurrent blocks' f32 leaves
(rglru ``conv.w``, ``wr.w``, ``wi.w``, ``lam.l``; mLSTM ``conv.w``,
``wi.w``, ``wf.w``, ``wf.b``; sLSTM ``r.w``, ``bias.b``), and an enc-dec
model's ``encoder`` segments, ``enc_norm`` and each decoder block's
``xattn`` and ``norm3``.  Then
every TLMAC serve linear gains one derived leaf, ``table_narrow``
(``kernels.tlmac_fused.narrow_table`` of its table, an expert stack's
``[L, E, n_clus, N_arr, 2^G]`` narrowed as one), which the lookup kernel
reads, and every int8 linear's ``w8`` has K and N zero-padded to
multiples of 8 (``models.nn.pad_int8_weight``: the card's int8 GEMM
takes no other; ``w_step`` keeps the true N).

With a ``mesh`` (and the ``cfg`` whose specs cut it), ``params_from_jax``
and ``dense_caches_from_jax`` give this rank's blocks
(``parallel.sharding.local_tree`` under ``models.lm.param_axes`` and
``cache_axes_tree``, the caches' batch entry as ``sharding.batch_entry``
picks it), each leaf tagged with its spec.  The port's own leaves are
made from the local block: ``table_narrow`` from the replicated
``table``, a K- or N-sharded ``w8`` cut first and then padded.

``train_params_from_jax`` keeps every leaf as it is, ``embed``/``head``
in f32 too (training updates the f32 masters), as a trainable
``ParamTree``; with a ``mesh``, this rank's blocks under the train specs
(an expert stack's experts on 'model', MLA's leaves as their specs cut
them), and ``adamw_state_from_jax`` the moments' blocks under the
reference's moment shardings (int8 and bf16 moments too).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.tlmac_fused import narrow_table
from repro_torch.models.nn import ParamTree, pad_int8_weight


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


def _serve_leaves(x):
    """Each serve linear's derived leaves, in place: ``table_narrow`` of a
    TLMAC plan, the padded ``w8`` of an int8 linear."""
    if isinstance(x, dict):
        if "table" in x and "exec_idx" in x:
            x["table_narrow"] = _retag(narrow_table(x["table"]), x["table"])
        if "w8" in x:
            x["w8"] = _retag(pad_int8_weight(x["w8"]).contiguous(), x["w8"])
        for v in x.values():
            _serve_leaves(v)
    elif isinstance(x, list):
        for v in x:
            _serve_leaves(v)


def _local(tree, device, mesh, specs):
    """``_tree``, or this rank's blocks of it under ``specs``."""
    if mesh is None:
        return _tree(tree, device)
    from repro_torch.parallel.sharding import local_tree

    out = local_tree(_tree(tree, "cpu"), specs, mesh)
    return out if torch.device(device).type == "cpu" else _to(out, device)


def _to(tree, device):
    """A tree of tagged CPU tensors on ``device``, tags kept."""
    from repro_torch.parallel.sharding import spec_of, with_spec

    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return with_spec(tree.to(device), spec_of(tree))


def params_from_jax(tree, device="cuda", mesh=None, cfg=None) -> ParamTree:
    """JAX serve params (``lm.init_lm(..., purpose='serve')[0]`` as numpy)
    -> the port's ``ParamTree``, plus each serve linear's
    ``table_narrow`` and padded ``w8``.  With ``mesh``: this rank's blocks
    under ``cfg``'s specs."""
    specs = None
    if mesh is not None:
        from repro_torch.models import lm

        specs = lm.param_axes(cfg)
    p = _local(tree, device, mesh, specs)
    for name in ("embed", "head"):
        if name in p:
            emb = p[name]["emb"]
            p[name] = {"emb": _retag(emb.to(torch.bfloat16), emb)}
    _serve_leaves(p)
    return ParamTree(p)


def _retag(new, old):
    """``new`` with ``old``'s spec tag, where it has one."""
    from repro_torch.parallel.sharding import _SPEC_ATTR

    if hasattr(old, _SPEC_ATTR):
        setattr(new, _SPEC_ATTR, getattr(old, _SPEC_ATTR))
    return new


def train_params_from_jax(tree, device="cuda", mesh=None,
                          cfg=None) -> ParamTree:
    """JAX train params (``lm.init_lm(key, cfg)[0]`` as numpy) -> the
    port's trainable ``ParamTree``, every leaf as it is.  With ``mesh``:
    this rank's blocks under ``cfg``'s train specs (the sharded train
    step's params)."""
    specs = None
    if mesh is not None:
        from repro_torch.models import lm

        specs = lm.param_axes(cfg, "train")
    return ParamTree(_local(tree, device, mesh, specs), trainable=True)


def adamw_state_from_jax(state, device="cuda", mesh=None, cfg=None):
    """JAX AdamW state (``optim.adamw_init``/``adamw_update``'s ``{'m',
    'v', 'step'}`` as numpy: f32 or bf16 moments, int8 moments as ``{'q',
    'scale'}`` dicts, a 0-d int32 step) -> the same structure of
    tensors.  With ``mesh``: this rank's blocks, cut by the reference's
    moment shardings (``optim.adamw.opt_axes``: f32 and bf16 moments as
    the params, an int8 moment's ``q`` and ``scale`` by the param spec
    with each dim that does not divide replicated), the step whole."""
    if mesh is None:
        return _tree(state, device)
    from repro_torch.models import lm
    from repro_torch.optim.adamw import opt_axes

    # every {'q', 'scale'} node is an int8 moment; other leaves keep the
    # param specs, whatever the state dtype
    axes = opt_axes(lm.param_axes(cfg, "train"), state["m"], "int8", mesh)
    return {k: _local(state[k], device, mesh, axes[k])
            for k in ("m", "v", "step")}


def to_numpy(tree):
    """The port's tree (a ``ParamTree``, nested dicts and lists of
    tensors) -> the same structure of numpy arrays, bits unchanged; bf16
    leaves come back as ``uint16`` views (numpy has no bf16:
    ``.view(ml_dtypes.bfloat16)`` makes JAX's leaf)."""
    if isinstance(tree, ParamTree):
        tree = tree.tree()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def pool_from_jax(tree, device="cuda"):
    """JAX paged caches (``lm.init_caches(..., paged=spec)[0]`` as numpy:
    a list per segment of ``{'b0': {'k', 'v'[, 'ks', 'vs']}}``) -> the
    same structure of tensors."""
    return _tree(tree, device)


def dense_caches_from_jax(tree, device="cuda", mesh=None, cfg=None):
    """JAX dense caches (``lm.init_caches(cfg, B, S_max)[0]`` or a
    ``prefill``'s, as numpy: a list per segment of ``{'b0': {'k', 'v'}}``
    with leaves ``[n_layers, B, S, KV, hd]``, bf16 or f32, an MLA
    model's ``{'b0': {'ckv', 'kr'}}`` latents ``[n_layers, B, S, kv_lora |
    rope]`` bf16, a ``dec_cross`` block's ``k``/``v`` and ``xk``/``xv``,
    or a recurrent block's f32 state leaves) -> the same structure of
    tensors, as ``lm.init_caches(cfg, B=, S_max=)`` holds them.  With
    ``mesh``: this rank's blocks under ``cfg``'s cache specs, as
    ``lm.init_caches(..., mesh=mesh)`` holds them."""
    specs = None
    if mesh is not None:
        from repro_torch.models import lm
        from repro_torch.parallel.sharding import fix_batch_axes

        B = next(iter(next(iter(tree[0].values())).values())).shape[1]
        specs = fix_batch_axes(lm.cache_axes_tree(cfg), B, mesh)
    return _local(tree, device, mesh, specs)


def resnet_params_from_jax(tree, device="cuda"):
    """JAX ResNet params (``resnet.init_resnet(key, cfg)`` as numpy) -> the
    port's nested dict of float32 tensors, same structure and bits."""
    return _tree(tree, device)
