"""NN primitives (port of ``repro.models.nn``): the train-path linear
(dense bf16 or fake-quant QAT, with gradients), serve linears (dense,
int8 and TLMAC layouts) and their expert-stacked form, norms,
embeddings, rotary, activations.

Parameters travel as nested dicts of tensors, like the JAX pytrees;
``ParamTree`` holds such a tree as an ``nn.Module`` (float leaves are
``Parameter``s, frozen for serving and trainable for training; integer
plan arrays are buffers).

Every ``init_*`` tags each leaf it makes with the reference's partition
spec (``parallel.sharding.with_spec``): the production mesh's axes
``('pod', 'data', 'model')``, FSDP configs also sharding a reduction dim
over ``('pod', 'data')`` (``_fsdp_spec``).  ``models.lm.param_axes``
reads the tags; a ``ParamTree`` keeps them on its leaves and on the
per-layer views, and the serve linears under a mesh
(``tp_linear_apply``) read them to pick their collectives."""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.core.quant import quantizers as Q
from repro_torch.core.tlmac.compile import plan_shapes
from repro_torch.kernels import ops as kops
from repro_torch.kernels.int8_experts import int8_experts_matmul
from repro_torch.kernels.tlmac_fused import narrow_table
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import (_SPEC_ATTR as SPEC_ATTR, P,
                                           current_mesh, spec_of, with_spec)

COMPUTE_DTYPE = torch.bfloat16
MODEL_AXIS = 16  # 'model' axis size in both production meshes; fixes dp


class ParamTree(nn.Module):
    """A nested dict (and list) of tensors held as a module.  ``tree()``
    returns the nested dict of tensors; ``layers(si)`` returns the
    per-layer views of stacked segment ``si``, cached until the module
    moves (serving only: the views are made outside any graph).  With
    ``trainable`` the float leaves require gradients; a train forward
    indexes the stacked leaves inside its graph (``models.lm.forward``),
    so each stacked leaf's gradient collects all its layers."""

    def __init__(self, tree, trainable: bool = False):
        super().__init__()
        self.trainable = trainable
        self._kinds = {}
        self._specs = {}    # leaf name -> its partition spec, where tagged
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v, trainable))
                self._kinds[k] = "tree"
            elif isinstance(v, (list, tuple)):
                self.add_module(k, nn.ModuleList(ParamTree(x, trainable)
                                                 for x in v))
                self._kinds[k] = "list"
            elif torch.is_floating_point(v):
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=trainable))
                self._kinds[k] = "leaf"
            else:
                self.register_buffer(k, v)
                self._kinds[k] = "leaf"
            if self._kinds[k] == "leaf" and hasattr(v, SPEC_ATTR):
                self._specs[k] = getattr(v, SPEC_ATTR)
        self._views = {}

    def tree(self) -> dict:
        out = {}
        for k, kind in self._kinds.items():
            v = getattr(self, k)
            if kind == "tree":
                out[k] = v.tree()
            elif kind == "list":
                out[k] = [x.tree() for x in v]
            else:
                if k in self._specs:    # a new Parameter drops the tag
                    setattr(v, SPEC_ATTR, self._specs[k])
                out[k] = v
        return out

    def layers(self, si: int, stack: str = "segments"):
        """Per-layer views of stacked segment ``si`` of ``stack``
        (``segments``, or an enc-dec model's ``encoder``)."""
        views = self._views.get((stack, si))
        if views is None:
            seg = getattr(self, stack)[si].tree()
            n = _leading(seg)
            views = [tree_index(seg, i) for i in range(n)]
            self._views[(stack, si)] = views
        return views

    def _apply(self, fn, *args, **kwargs):
        self._views = {}
        return super()._apply(fn, *args, **kwargs)


def _leading(tree) -> int:
    for v in tree.values():
        return _leading(v) if isinstance(v, dict) else v.shape[0]
    raise ValueError("empty tree")


def tree_index(tree, i: int):
    """``jax.tree.map(lambda c: c[i], tree)`` over nested dicts; a tagged
    stacked leaf's view carries its spec less the layer axis."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = tree_index(v, i)
            continue
        out[k] = v[i]
        if hasattr(v, SPEC_ATTR):
            setattr(out[k], SPEC_ATTR, getattr(v, SPEC_ATTR)[1:])
    return out


def _pick_dp(N: int, want: int) -> int:
    """Largest dp <= want dividing N with N/dp divisible by the model
    axis (the JAX package's choice, so plan shapes match it)."""
    best = None
    for dp in range(min(want, N), 0, -1):
        if N % dp == 0:
            if (N // dp) % MODEL_AXIS == 0:
                return dp
            if best is None:
                best = dp
    return best or min(want, N)


def _fsdp_spec(spec: P, fsdp: bool, shape=None, axes=("pod", "data"),
               n_shards=32) -> P:
    """Extend a TP spec with FSDP sharding on the first unsharded dim
    whose size divides the shard count (shape-aware)."""
    if not fsdp:
        return spec
    parts = list(spec)
    for i, s in enumerate(parts):
        if s is None and (shape is None or shape[i] % n_shards == 0):
            parts[i] = axes
            return P(*parts)
    return spec


def _bf16_matmul(x, w, f32_out: bool = False):
    """``x @ w`` of bf16 operands to bf16: one bf16 ``torch.matmul`` on the
    card (cuBLAS accumulates in f32); on the CPU the f32 product of the
    bf16 operands, which is XLA's CPU dot (a CPU bf16 GEMM orders its sums
    differently).  ``f32_out``: the f32 product, unrounded (on the card
    cuBLAS's bf16 GEMM with an f32 output, ``_MatmulF32Out``)."""
    if x.device.type == "cuda":
        return _MatmulF32Out.apply(x, w) if f32_out else torch.matmul(x, w)
    y = torch.matmul(x.float(), w.float())
    return y if f32_out else y.to(COMPUTE_DTYPE)


class _MatmulF32Out(torch.autograd.Function):
    """``x [..., K] @ w [K, N]`` of bf16 operands on the card, as f32: the
    bf16 GEMM with an f32 output (``torch.mm(out_dtype=)``, which has no
    derivative of its own), so the sum is the bf16 product's less its
    last rounding.  The backward is the bf16 product's: the gradient
    rounded to bf16 (the values a bf16 output's gradient holds), then the
    two bf16 GEMMs of ``torch.matmul``'s backward."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).reshape(-1, w.shape[-1])
        dx = g.mm(w.t()).reshape(x.shape)
        dw = x.reshape(-1, x.shape[-1]).t().mm(g)
        return dx, dw


def _winit(gen, shape, device) -> torch.Tensor:
    """N(0, 1) f32 over the square root of the fan-in (``shape[-2]``)."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return w / math.sqrt(shape[-2])


def init_linear(gen: torch.Generator, K: int, N: int, cfg,
                use_bias: bool = False, device="cuda",
                expert: int = 0, shard=(None, "model")) -> dict:
    """Train-path linear (the reference's ``init_linear``): ``w [K, N]``
    f32 (``[E, K, N]`` with ``expert=E``), a zero bias ``[N]`` (``[E, N]``)
    with ``use_bias``, and under ``linear_impl='qdq'`` the LSQ step
    ``w_step [N]`` (per output channel over every expert) and the N2UQ
    activation params ``aq``.  ``shard`` is the TP spec of ``w``: an
    expert stack shards E on 'model' instead, a ``pure_fsdp`` config
    shards ``w`` 256 ways over ('data', 'model')."""
    shape = (expert, K, N) if expert else (K, N)
    if expert:
        spec = _fsdp_spec(P("model", None, None), cfg.fsdp, shape)
    elif cfg.pure_fsdp:
        spec = _fsdp_spec(P(None, None), True, shape,
                          axes=("data", "model"), n_shards=256)
        if spec == P(None, None):       # neither dim divides 256
            spec = _fsdp_spec(P(None, None), True, shape)
    else:
        spec = _fsdp_spec(P(*shard), cfg.fsdp, shape)
    p = {"w": with_spec(_winit(gen, shape, device), spec)}
    if use_bias:
        p["b"] = with_spec(
            torch.zeros(shape[:-2] + (N,), dtype=torch.float32,
                        device=device),
            P("model", shard[-1]) if expert else P(shard[-1]))
    if cfg.linear_impl == "qdq":
        p["w_step"] = with_spec(
            Q.lsq_init(p["w"].reshape(-1, N), cfg.quant.w_bits,
                       per_channel=True), P(shard[-1]))
        aq = Q.n2uq_act_init(cfg.quant.a_bits, device=device)
        p["aq"] = {"deltas": with_spec(aq["deltas"], P(None)),
                   "out_step": with_spec(aq["out_step"], P())}
    return p


def linear_apply(params, x, cfg, use_bias: bool = False,
                 k_split: bool = False):
    """The reference's train-path linear, with gradients: with ``aq`` in
    the params (``linear_impl='qdq'``), the N2UQ activation quantiser and
    the LSQ weight quantiser (``core.quant.quantizers``) fake-quantise
    both operands, then a bf16 product; else the bf16 product of ``x``
    and ``w``.  Expert weights ``[E, K, N]`` take ``x [..., E, cap, K]``
    to ``[..., E, cap, N]``.  The serve path also reaches it through an
    enc-dec model's ``front`` projection (``models.lm.encode``).

    ``k_split`` (under a mesh; a weight replicated on 'model'): the
    product of this rank's block of the reduction dim over 'model',
    rounded to bf16, the partials summed over 'model' in f32 and rounded
    once (``collectives.sum_partials_ad``), as the reference's
    partitioned graph runs a VLM's FSDP-cut front (``models.lm``)."""
    numel, partial = None, False
    if current_mesh() is not None:
        partial = _row_parallel(params["w"], cfg)
        if partial and use_bias:
            raise NotImplementedError("a bias on a row-parallel train linear")
        params, numel = _train_leaves(params, cfg)
    w = params["w"]
    if "aq" in params:
        xq = Q.n2uq_act_quant(x.to(torch.float32), params["aq"],
                              cfg.quant.a_bits)
        wq = Q.lsq_quant(w.reshape(-1, w.shape[-1]), params["w_step"],
                         cfg.quant.w_bits, numel=numel).reshape(w.shape)
        x_, w_ = xq.to(COMPUTE_DTYPE), wq.to(COMPUTE_DTYPE)
    else:
        x_, w_ = x.to(COMPUTE_DTYPE), w.to(COMPUTE_DTYPE)
    if k_split:
        y = _bf16_matmul(coll.split(x_, "model"),
                         coll.split(w_, "model", dim=-2))
        return coll.sum_partials_ad(y.float(), "model").to(COMPUTE_DTYPE)
    # [..., E, cap, K] @ [E, K, N] broadcasts
    y = _bf16_matmul(x_, w_, f32_out=partial)
    if use_bias:
        y = y + params["b"].to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# The train linear under a mesh (the sharded train step)
# ---------------------------------------------------------------------------
#
# Under ``launch.mesh.mesh_context`` a train linear's leaves are this rank's
# blocks, tagged with the reference's specs (``init_linear``), and
# ``linear_apply`` follows them:
#
# - tensor parallel (every config but ``pure_fsdp``): 'model' in ``w``'s
#   spec is TP.  Column-parallel ``w`` P(fsdp, 'model') (wq, wk, wv, wi,
#   wg) with ``w_step`` P('model') and a bias P('model'): the product of
#   the whole input (gathered over the sequence by the block) on this
#   rank's columns.  Row-parallel ``w`` P('model', fsdp) (both ``wo``s)
#   with ``w_step`` P(None): the product of this rank's input columns on
#   its rows, a partial sum that the block reduce-scatters.  The N2UQ
#   activation quantiser reads the input the linear gets; LSQ runs on the
#   local block with the whole weight's element count.  A row-parallel
#   product is returned in f32, unrounded: the block sums the partials
#   over 'model' in f32 and rounds the sum once, so the sum differs from
#   the whole product's only in its f32 order (the reference's partitioned
#   graph computes these products whole, after resharding its
#   activations, and rounds once; partials rounded to bf16 first moved
#   the N2UQ codes downstream);
# - FSDP: the axes of ``w``'s spec other than a TP 'model' (('pod',
#   'data'), or ('data', 'model') and ``w_step``'s 'model' under
#   ``pure_fsdp``, which has no TP) are gathered at each use
#   (``collectives.all_gather_ad``, counted as parameter collectives); the
#   backward reduce-scatters the gradient, which sums it over those axes;
# - an expert stack ``w [E, K, N]`` P('model', fsdp, None) holds this rank's
#   experts (expert parallelism, ``models.moe``), and its ``w_step``
#   P('model'), a step per output channel over every expert, is gathered
#   over 'model' at use.


def train_work_axes(cfg) -> tuple:
    """Every mesh axis over which the sharded train step splits its work:
    the batch rows' axes (``train_batch_axes``) and, under tensor
    parallelism, 'model'."""
    return ("data", "model") if cfg.pure_fsdp else ("pod", "data", "model")


def train_batch_axes(cfg) -> tuple:
    """The mesh axes a sharded train step splits its batch rows over, as
    the reference's ``_lower_train`` shards the batch: ('data', 'model')
    under ``pure_fsdp`` (no TP), else ('pod', 'data')."""
    return ("data", "model") if cfg.pure_fsdp else ("pod", "data")


def _row_parallel(w, cfg) -> bool:
    """Whether a train linear's ``w`` is row-parallel: its reduction dim
    on a TP 'model'."""
    spec = spec_of(w)
    return (not cfg.pure_fsdp and len(spec) >= 2
            and "model" in _names(spec[-2]))


def _train_leaves(params, cfg):
    """A train linear's leaves as its product reads them on this rank
    (FSDP axes gathered), and the whole weight's element count."""
    w = params["w"]
    numel = w.numel()
    for e in spec_of(w):
        numel *= coll.size(e)
    out = dict(params)
    for name in ("w", "w_step", "b"):
        if name in params:
            out[name] = gather_fsdp(params[name], cfg)
    if w.dim() == 3 and "w_step" in out and not cfg.pure_fsdp:
        # an expert stack: its experts are on 'model' and its step, one a
        # column over every expert's rows, is cut on 'model' too; the
        # rank's experts read it whole, and the backward's reduce-scatter
        # sums every rank's experts into each block
        out["w_step"] = coll.all_gather_ad(out["w_step"], "model", dim=0,
                                           param=True)
    return out, numel


def gather_fsdp(t, cfg):
    """A param block of the sharded train step gathered over its FSDP
    axes (every axis its spec names but a TP 'model'), as it is used; the
    backward reduce-scatters the gradient.  Under ``pure_fsdp`` the batch
    is split over ('data', 'model') only, so a gather over a 'pod' of more
    than one rank would sum copies of one gradient: refused."""
    for d, e in enumerate(spec_of(t)):
        axes = tuple(a for a in _names(e) if cfg.pure_fsdp or a != "model")
        if cfg.pure_fsdp and "pod" in axes and coll.size("pod") > 1:
            raise NotImplementedError(
                "a pure_fsdp leaf sharded over 'pod' under a mesh with a pod "
                "axis: its batch is replicated over 'pod' (the reference's "
                "_lower_train), so the gather's backward would sum copies")
        if axes:
            t = coll.all_gather_ad(t, axes, dim=d, param=True)
    return t


def init_serve_linear(gen: torch.Generator, K: int, N: int, cfg,
                      use_bias: bool = False, device="cuda",
                      expert: int = 0, shard=(None, "model")) -> dict:
    """Serve-linear params of ``cfg.serve_impl``, drawn from ``gen``
    (which must live on ``device``):

    - ``dense``: ``w`` bf16 ``[K, N]``, N(0, 1/K);
    - ``int8``: ``w8`` int8 ``[K, N]`` in [-127, 126] (zero-padded to
      multiples of 8 by ``pad_int8_weight``), ``w_step [N]`` and
      ``a_step`` f32 ones;
    - ``tlmac``: the plan's capacity shapes: int32 tables, uint8
      (N_arr <= 256) or int16 indices, int8 step clusters, and the
      table's narrow rows (``table_narrow``) that the lookup kernel
      reads.

    ``expert > 0`` stacks E experts: every leaf gains a leading E (the
    reference's expert-stacked linear).  Each leaf is allocated once in
    its stored dtype and drawn expert by expert, so no draw holds a wider
    copy of it (an int64 draw of one deepseek MoE layer's indices alone
    would be 22.5 GB); on the meta device nothing is drawn.

    Specs, the reference's: ``shard`` is the TP spec (output dim on
    'model' by default; ``('model', None)`` for a row-parallel linear),
    an expert stack shards E on 'model'.  A tlmac linear shards its
    output tiles on 'model' where they divide the axis, else its
    reduction groups, and an FSDP config its groups over ('pod', 'data')
    too; the tables are replicated (``table_narrow``, the port's own
    leaf, as ``table``)."""
    impl = cfg.serve_impl
    e = (expert,) if expert else ()
    espec = ("model",) if expert else ()
    meta = torch.device(device).type == "meta"

    def draw(shape, dtype, fill):
        """A leaf ``[*e, *shape]`` of ``dtype``, each expert's slice
        filled by ``fill(slice)`` in turn."""
        out = torch.empty((*e, *shape), dtype=dtype, device=device)
        for part in (() if meta else out.unbind(0) if expert else (out,)):
            fill(part)
        return out

    ones = lambda *shape: torch.ones((*e, *shape), dtype=torch.float32,
                                     device=device)
    w_step_spec = P(*espec, None if expert else shard[-1])
    a_step_spec = P(*espec) if e else P()
    if impl == "dense":     # drawn in bf16: no f32 copy at init
        p = {"w": with_spec(
            draw((K, N), torch.bfloat16,
                 lambda t: t.normal_(generator=gen).mul_(1.0 / math.sqrt(K))),
            P("model", *shard[:-1], None) if expert else P(*shard))}
    elif impl == "int8":
        p = {
            "w8": with_spec(
                pad_int8_weight(draw((K, N), torch.int8,
                                     lambda t: t.random_(-127, 127,
                                                         generator=gen))),
                P("model", None, None) if expert else P(*shard)),
            "w_step": with_spec(ones(N), w_step_spec),
            "a_step": with_spec(ones(), a_step_spec),
        }
    elif impl == "tlmac":
        G, dp = cfg.tlmac_G, _pick_dp(N, cfg.tlmac_dp)
        ps = plan_shapes(K, N, G, cfg.quant.w_bits,
                         n_arr_cap=cfg.tlmac_narr_cap, d_p=dp)
        n_tiles, kg = N // dp, K // G
        idx_dtype = torch.uint8 if ps["N_arr"] <= 256 else torch.int16
        dp_extra = ("pod", "data") if (cfg.fsdp and kg % 32 == 0) else None
        if expert:
            idx_spec = P("model", None, dp_extra, None)
            cl_spec = P("model", None, dp_extra)
        elif tuple(shard) == (None, None):
            idx_spec, cl_spec = P(None, None, None), P(None, None)
        elif n_tiles % MODEL_AXIS == 0:
            idx_spec, cl_spec = P("model", dp_extra, None), P("model",
                                                               dp_extra)
        elif kg % MODEL_AXIS == 0:
            idx_spec, cl_spec = P(None, "model", None), P(None, "model")
        else:
            idx_spec, cl_spec = P(None, None, None), P(None, None)
        table = draw(ps["table"][0], torch.int32,
                     lambda t: t.random_(-8, 8, generator=gen))
        p = {
            "table": with_spec(table, P(*espec)),
            "exec_idx": with_spec(
                draw((n_tiles, kg, dp), idx_dtype,
                     lambda t: t.random_(0, ps["N_arr"], generator=gen)),
                idx_spec),
            "step_cluster": with_spec(
                draw((n_tiles, kg), torch.int8,
                     lambda t: t.random_(0, ps["N_clus"], generator=gen)),
                cl_spec),
            "w_step": with_spec(ones(N), w_step_spec),
            "a_step": with_spec(ones(), a_step_spec),
            # entries drawn in [-8, 8): int8 rows (unknown on meta)
            "table_narrow": with_spec(
                table.to(torch.int8) if meta else narrow_table(table),
                P(*espec)),
        }
    else:
        raise ValueError(f"serve_impl {impl!r} not in dense | int8 | tlmac")
    if use_bias:
        p["b"] = with_spec(torch.zeros((*e, N), dtype=torch.bfloat16,
                                       device=device), P(*espec, shard[-1]))
    return p


def layout(params) -> str:
    """The serve layout of one linear's params: ``'table'`` => tlmac,
    ``'w8'`` => int8, ``'w'`` => dense (the reference's dispatch)."""
    return "tlmac" if "table" in params else (
        "int8" if "w8" in params else "dense")


INT_MM_MIN_M = 32   # torch._int_mm refuses M <= 16: zero rows pad M to 32
INT8_ALIGN = 8      # torch._int_mm takes K and N in multiples of 8


def pad_int8_weight(w8: torch.Tensor) -> torch.Tensor:
    """``w8 [..., K, N]`` with K and N padded by zero rows and columns to
    multiples of ``INT8_ALIGN``, once, where the params are made (the
    reference's ``dot_general`` takes any K and N; the card's int8 GEMM
    does not).  The int32 product is unchanged; the serve linear pads its
    activations' K alike and cuts the output back to ``w_step``'s N."""
    K, N = w8.shape[-2:]
    pk, pn = -K % INT8_ALIGN, -N % INT8_ALIGN
    if not (pk or pn):
        return w8
    return torch.nn.functional.pad(w8, (0, pn, 0, pk))


def _int8_codes(x, a_step, Kp: int):
    """Activations rounded half to even on ``a_step``, clipped to +-127,
    as int8 codes with K padded by zero columns to the weight's ``Kp``."""
    aq = torch.clamp(torch.round(x.to(torch.float32) / a_step),
                     -127, 127).to(torch.int8)
    K = aq.shape[-1]
    return torch.nn.functional.pad(aq, (0, Kp - K)) if Kp != K else aq


def int8_matmul(aq: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``aq [M, K] @ w8 [K, N]`` of int8 operands.  On the
    card one ``torch._int_mm`` (cuBLASLt int8 GEMM: K and N come padded to
    multiples of 8 by ``pad_int8_weight``, and zero rows pad M past 16);
    on the CPU an int32 product (no rounding anywhere)."""
    if aq.device.type != "cuda":
        return torch.matmul(aq.to(torch.int32), w8.to(torch.int32))
    M, K = aq.shape
    Mp = max(INT_MM_MIN_M, -(-M // 8) * 8)
    if Mp != M:
        a = torch.zeros((Mp, K), dtype=torch.int8, device=aq.device)
        a[:M] = aq
        return torch._int_mm(a, w8)[:M]
    return torch._int_mm(aq.contiguous(), w8)


def _tlmac_quant_pack(a_step, x, cfg):
    """Quantise activations to B_a-bit codes ``[M, K]`` int8 (round half
    to even, as ``jnp.round``), contiguous as the kernel takes them (the
    codes keep ``x``'s strides, which a sliced or einsum-made ``x`` may
    not have in row-major order).  The kernel packs bit-planes itself."""
    B_a = cfg.quant.a_bits
    K = x.shape[-1]
    return torch.clamp(torch.round(x.to(torch.float32) / a_step),
                       0, 2**B_a - 1).to(torch.int8).reshape(-1, K
                                                             ).contiguous()


def _tlmac_gemm(params, aq, lead, cfg):
    """One lookup GEMM from quantised activations, dequantised to bf16,
    through ``cfg.serve_tlmac_impl``: ``'auto'`` reads the autotune cache
    (host side, so a CUDA graph capture may resolve it) and never tunes
    inline; a miss takes kernel 1.  Reads ``table_narrow`` where the
    params carry it (made once with them); a bare int32 ``table`` serves
    the CPU's plain version and is refused by the kernels."""
    yi = _tlmac_int(params, params["exec_idx"], params["step_cluster"], aq,
                    cfg)
    y = _dequant(yi, params["a_step"], params["w_step"])
    return y.reshape(*lead, yi.shape[-1])


def _tlmac_int(params, exec_idx, step_cluster, aq, cfg):
    """The int32 lookup product ``[M, n_tiles * dp]`` of codes ``aq``
    through ``cfg.serve_tlmac_impl`` on the plan ``exec_idx``/
    ``step_cluster`` (the params' own, or their gathered blocks)."""
    n_tiles, kg, dp = exec_idx.shape
    table = params.get("table_narrow", params["table"])
    return kops.tlmac_matmul(aq, table, exec_idx, step_cluster,
                             B_a=cfg.quant.a_bits, G=cfg.tlmac_G,
                             N=n_tiles * dp, impl=cfg.serve_tlmac_impl,
                             tune_on_miss=False)


def _dequant(yi, a_step, w_step):
    """``yi * (a_step * w_step)`` in f32, to bf16."""
    return (yi.to(torch.float32) * (a_step * w_step)).to(COMPUTE_DTYPE)


def serve_linear_apply(params, x, cfg, use_bias: bool = False):
    """Serve-path forward ``[..., K] -> [..., N]``, dispatched on the
    params (``layout``), so mixed-precision layer layouts serve:

    - dense: ``x`` rounded to bf16 times the bf16 ``w``, summed in f32,
      to bf16: one bf16 ``torch.matmul`` on the card (cuBLAS accumulates
      in f32); on the CPU the f32 product of the bf16 operands, which is
      XLA's CPU dot (a CPU bf16 GEMM orders its sums differently);
    - int8: activations rounded half to even on ``a_step``, clipped to
      +-127, an exact int8 x int8 -> int32 product (``int8_matmul``, on
      the padded weight, cut back to N), then ``yi * (a_step * w_step)``
      in f32, to bf16;
    - tlmac: the lookup GEMM on quantised codes, kernel 1 or the impl
      ``cfg.serve_tlmac_impl`` names (``_tlmac_gemm``)."""
    impl = layout(params)
    if impl == "dense":
        y = _bf16_matmul(x.to(COMPUTE_DTYPE), params["w"])
    elif impl == "int8":
        a_step, w8 = params["a_step"], params["w8"]
        aq = _int8_codes(x, a_step, w8.shape[0])
        N = params["w_step"].shape[-1]
        yi = int8_matmul(aq.reshape(-1, w8.shape[0]), w8)[:, :N]
        y = _dequant(yi, a_step, params["w_step"]).reshape(*x.shape[:-1], N)
    else:
        aq = _tlmac_quant_pack(params["a_step"], x, cfg)
        y = _tlmac_gemm(params, aq, x.shape[:-1], cfg)
    if use_bias:
        y = y + params["b"].to(y.dtype)
    return y


def serve_linear_pair_apply(p1, p2, x, cfg):
    """Two serve linears reading the same tensor (swiglu wi/wg).  A tlmac
    pair shares one activation quantisation on the first branch's
    ``a_step`` for both lookup GEMMs; any other layout runs two
    independent applies."""
    if layout(p1) != "tlmac" or layout(p2) != "tlmac":
        return serve_linear_apply(p1, x, cfg), serve_linear_apply(p2, x, cfg)
    aq = _tlmac_quant_pack(p1["a_step"], x, cfg)
    lead = x.shape[:-1]
    y1 = _tlmac_gemm(p1, aq, lead, cfg)
    y2 = _tlmac_gemm(dict(p2, a_step=p1["a_step"]), aq, lead, cfg)
    return y1, y2


serve_linear_apply.pair_apply = serve_linear_pair_apply


def serve_expert_linear_apply(params, xe, cfg):
    """Serve-path expert linear: every leaf of ``params`` has a leading E;
    ``xe [G, E, cap, K] -> [G, E, cap, N]``, each expert's ``G * cap`` rows
    through its own linear (the reference's ``jax.vmap`` over experts):

    - tlmac: each expert's codes on its own ``a_step``, then ONE launch of
      the lookup kernel over the expert stack (kernel 1's expert axis),
      dequantised as the dense path does, ``yi * (a_step * w_step)`` in
      f32 to bf16 (the reference's fused N-tile GEMM rounds each finished
      tile so);
    - int8: each expert's exact int8 x int8 -> int32 product from ONE
      launch of the expert-stacked int8 kernel
      (``kernels/int8_experts.py``; one batched int32 product on the
      CPU), dequantised in f32 to bf16;
    - dense: the bf16 product summed in f32 (one batched matmul).

    Under a mesh (expert parallelism) the leaves are this rank's block of
    ``E / |model|`` experts and ``xe`` holds their rows; a tlmac plan's
    reduction groups sharded over ('pod', 'data') (``fsdp``) are gathered
    at use, as ``_tp_tlmac`` gathers a single linear's."""
    G, E, cap, K = xe.shape
    x = xe.transpose(0, 1).reshape(E, G * cap, K)
    impl = layout(params)
    if impl == "tlmac":
        a_step = params["a_step"].reshape(E, 1, 1)
        aq = torch.clamp(torch.round(x.to(torch.float32) / a_step),
                         0, 2**cfg.quant.a_bits - 1).to(
            torch.int8).contiguous()
        exec_idx, step_cluster = params["exec_idx"], params["step_cluster"]
        if current_mesh() is not None:
            exec_idx, step_cluster = (_gather_plan_fsdp(t, 2) for t in (
                exec_idx, step_cluster))
        n_tiles, kg, dp = exec_idx.shape[-3:]
        table = params.get("table_narrow", params["table"])
        yi = kops.tlmac_matmul(aq, table, exec_idx, step_cluster,
                               B_a=cfg.quant.a_bits, G=cfg.tlmac_G,
                               N=n_tiles * dp, impl="fused")
        y = (yi.to(torch.float32)
             * (a_step * params["w_step"][:, None, :])).to(COMPUTE_DTYPE)
    elif impl == "int8":
        a_step, w8 = params["a_step"].reshape(E, 1, 1), params["w8"]
        aq = _int8_codes(x, a_step, w8.shape[-2])
        N = params["w_step"].shape[-1]
        yi = int8_experts_matmul(aq, w8)[..., :N]
        y = (yi.to(torch.float32)
             * (a_step * params["w_step"][:, None, :])).to(COMPUTE_DTYPE)
    else:
        y = _bf16_matmul(x.to(COMPUTE_DTYPE), params["w"])
    N = y.shape[-1]
    return y.reshape(E, G, cap, N).transpose(0, 1)


# ---------------------------------------------------------------------------
# Serve linears under a mesh: tensor parallelism over 'model'
# ---------------------------------------------------------------------------
#
# Under ``launch.mesh.mesh_context`` every leaf is this rank's block of the
# reference's leaf, tagged with its spec (``parallel.sharding.local_tree``),
# and an activation's last dim is either whole or this rank's block of
# 'model' columns (``split``).  A linear follows its leaves' specs, which
# ``init_serve_linear`` picks as the reference does:
#
# - output dim on 'model' (tlmac ``exec_idx`` P('model', ...), int8 ``w8``
#   and dense ``w`` P(None, 'model')): the product of the whole input on the
#   local output tiles gives this rank's columns;
# - reduction dim on 'model' (tlmac P(None, 'model', None), int8 and dense
#   ``wo`` P('model', None)): the product of the input's local block, then
#   a sum over 'model': exact in int32 for tlmac and int8; for dense the
#   reference's partitioned graph rounds each partial product to bf16,
#   sums the partials in f32 and rounds the sum to bf16 (read in its
#   compiled HLO), and so does the port;
# - a tlmac plan's reduction groups also on ('pod', 'data') (FSDP): the
#   ``exec_idx``/``step_cluster`` blocks are gathered over those axes at
#   use, the only collective that moves a parameter;
# - replicated: the whole input, the whole output.
#
# An input that is split where the whole is needed is gathered over 'model'
# as its int8 codes (tlmac, int8; half the bytes of bf16, the same
# product), as bf16 for dense.  An output is split where the output tiles
# are, or where ``w_step`` (and the bias) is sharded on 'model' although the
# product is whole: it is then cut to this rank's columns.


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _model_dim(spec, d: int) -> bool:
    return d < len(spec) and "model" in _names(spec[d])


def _cut_cols(t, n_local: int):
    """This rank's block of ``n_local`` columns of a whole ``t``."""
    return t.narrow(-1, coll.index("model") * n_local, n_local)


def _tp_in(codes, split: bool, want_split: bool):
    """Codes (or bf16 activations) in the layout the weight reads: this
    rank's block of columns, or the whole gathered over 'model'."""
    if want_split and not split:
        return _cut_cols(codes, codes.shape[-1] // coll.size("model")
                         ).contiguous()
    if split and not want_split:
        return coll.all_gather(codes, "model", dim=-1)
    return codes


def _tp_layout(params):
    """(output dim on 'model', reduction dim on 'model')."""
    impl = layout(params)
    if impl == "tlmac":
        spec = spec_of(params["exec_idx"])
        return _model_dim(spec, 0), _model_dim(spec, 1)
    spec = spec_of(params["w8" if impl == "int8" else "w"])
    return _model_dim(spec, 1), _model_dim(spec, 0)


def _gather_plan_fsdp(t, dim: int):
    """A tlmac plan leaf (``exec_idx``, ``step_cluster``) with its
    reduction groups, dim ``dim``, gathered over the FSDP axes its spec
    puts there (every axis but 'model'): the only collective that moves a
    parameter."""
    axes = tuple(a for a in _names(spec_of(t)[dim]) if a != "model")
    return coll.all_gather(t, axes, dim=dim, param=True) if axes else t


def _tp_cols(y, split: bool, leaf):
    """``(y, leaf)`` on the same columns: ``y`` cut to this rank's where
    ``leaf`` (``w_step`` or a bias) is sharded on 'model' and ``y`` whole,
    ``leaf`` cut where ``y`` is split and ``leaf`` whole; and ``y``'s
    split."""
    if _model_dim(spec_of(leaf), 0):
        if not split:
            y = _cut_cols(y, leaf.shape[-1])
        return y, leaf, True
    if split:
        leaf = _cut_cols(leaf, y.shape[-1])
    return y, leaf, split


def _tp_tlmac(params, aq, split: bool, cfg):
    """One tlmac linear's product on this rank, from codes ``aq [M, K |
    K_local]``: the int32 lookup GEMM on the local plan (its FSDP blocks
    gathered), summed over 'model' where the reduction groups are split,
    then dequantised; returns ``(y, split)``."""
    out_m, in_m = _tp_layout(params)
    exec_idx, step_cluster = (_gather_plan_fsdp(params[n], 1)
                              for n in ("exec_idx", "step_cluster"))
    yi = _tlmac_int(params, exec_idx, step_cluster,
                    _tp_in(aq, split, in_m), cfg)
    if in_m:
        yi = coll.all_reduce(yi, "model")
    yi, w_step, split = _tp_cols(yi, out_m, params["w_step"])
    return _dequant(yi, params["a_step"], w_step), split


def _tp_bias(y, split: bool, params, use_bias: bool):
    if not use_bias:
        return y, split
    y, b, split = _tp_cols(y, split, params["b"])
    return y + b.to(y.dtype), split


def tp_linear_apply(params, x, cfg, split: bool = False,
                    use_bias: bool = False):
    """``serve_linear_apply`` on this rank's blocks under the active mesh:
    ``x [..., K]`` whole, or its block of 'model' columns with ``split``.
    Returns ``(y, split)``: ``y``'s last dim whole or this rank's block of
    columns."""
    lead = x.shape[:-1]
    impl = layout(params)
    out_m, in_m = _tp_layout(params)
    if impl == "tlmac":
        aq = _tlmac_quant_pack(params["a_step"], x, cfg)
        y, split = _tp_tlmac(params, aq, split, cfg)
    elif impl == "int8":
        w8 = params["w8"]
        aq = _int8_codes(x, params["a_step"], x.shape[-1]).reshape(
            -1, x.shape[-1])
        aq = _tp_in(aq, split, in_m)
        aq = torch.nn.functional.pad(aq, (0, w8.shape[0] - aq.shape[-1]))
        yi = int8_matmul(aq.contiguous(), w8)[:, :params["w_step"].shape[-1]]
        if in_m:
            yi = coll.all_reduce(yi, "model")
        yi, w_step, split = _tp_cols(yi, out_m, params["w_step"])
        y = _dequant(yi, params["a_step"], w_step)
    else:
        w = params["w"]
        y = _bf16_matmul(_tp_in(x.to(COMPUTE_DTYPE), split, in_m), w)
        if in_m:   # bf16 partials summed in f32, rounded once
            y = coll.all_reduce(y.float(), "model").to(COMPUTE_DTYPE)
        split = out_m
    y, split = _tp_bias(y, split, params, use_bias)
    return y.reshape(*lead, y.shape[-1]), split


def tp_linear_pair_apply(p1, p2, x, cfg):
    """``serve_linear_pair_apply`` under the mesh (``x`` whole): a tlmac
    pair shares the first branch's codes.  Returns ``(y1, y2, split)``:
    the two linears have one spec, so their outputs one layout."""
    if layout(p1) != "tlmac" or layout(p2) != "tlmac":
        (y1, s1), (y2, _) = (tp_linear_apply(p1, x, cfg),
                             tp_linear_apply(p2, x, cfg))
    else:
        aq = _tlmac_quant_pack(p1["a_step"], x, cfg)
        y1, s1 = _tp_tlmac(p1, aq, False, cfg)
        y2, _ = _tp_tlmac(dict(p2, a_step=p1["a_step"]), aq, False, cfg)
    lead = x.shape[:-1]
    return (y1.reshape(*lead, y1.shape[-1]), y2.reshape(*lead, y2.shape[-1]),
            s1)


def gather_cols(t, split: bool):
    """The whole of an activation that may be split over 'model'."""
    return coll.all_gather(t, "model", dim=-1) if split else t


def own_cols(t, split: bool):
    """This rank's block of 'model' columns of an activation that may be
    whole (a column-parallel linear's output, cut where its tiles were
    not)."""
    return t if split else _cut_cols(t, t.shape[-1] // coll.size("model"))


# ---------------------------------------------------------------------------
# Norms / embeddings / rotary
# ---------------------------------------------------------------------------


def rmsnorm_apply(params, x, eps: float = 1e-6, dtype=None):
    """``dtype`` is the output's, ``x``'s by default.  A block passes its
    residual sum in f32 with ``dtype`` bf16 (``models.lm.apply_block``)."""
    x32 = x.to(torch.float32)
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps) * params["scale"]
    return y.to(dtype or x.dtype)


def padded_vocab(vocab: int) -> int:
    return vocab + (-vocab) % MODEL_AXIS


def _vocab_start(emb) -> int:
    """The global index of this rank's first vocab row: 0 without a mesh;
    under one, the rows are this rank's 'model' block (vocab-parallel)."""
    if current_mesh() is None:
        return 0
    return coll.index("model") * emb.shape[0]


def embed_apply(params, tokens):
    """Token embeddings in bf16.  Under a mesh the table is this rank's
    block of vocab rows: each rank takes the rows it owns, zeros for the
    others, and a sum over 'model' assembles them (exact: one nonzero term
    an element)."""
    emb = params["emb"]
    if current_mesh() is None:
        return emb[tokens.long()].to(COMPUTE_DTYPE)
    t = tokens.long() - _vocab_start(emb)
    own = (t >= 0) & (t < emb.shape[0])
    rows = emb[t.clamp(0, emb.shape[0] - 1)].to(COMPUTE_DTYPE)
    rows = torch.where(own[..., None], rows, torch.zeros_like(rows))
    return coll.all_reduce(rows, "model")


def train_embed_apply(params, tokens, cfg):
    """``embed_apply`` of the sharded train step (f32 master rows, with
    gradients): under tensor parallelism vocab-parallel, each rank's own
    rows (zeros for the others) summed over 'model'
    (``collectives.all_reduce_ad``: each rank's rows get the gradient of
    their tokens); under ``pure_fsdp`` the table gathered over its FSDP
    axes ('model'), then the plain lookup."""
    emb = params["emb"]
    if cfg.pure_fsdp:
        return gather_fsdp(emb, cfg)[tokens.long()].to(COMPUTE_DTYPE)
    n = emb.shape[0]
    t = tokens.long() - _vocab_start(emb)
    own = (t >= 0) & (t < n)
    rows = emb[t.clamp(0, n - 1)].to(COMPUTE_DTYPE)
    rows = torch.where(own[..., None], rows, torch.zeros_like(rows))
    return coll.all_reduce_ad(rows, "model")


def train_logits_apply(params, x, cfg):
    """``logits_apply`` of the sharded train step: under tensor
    parallelism this rank's block of the padded vocab from the whole
    sequence ``x`` (its rows of the table); under ``pure_fsdp`` the table
    gathered and the whole vocab.  Returns ``(logits, the global index of
    its first column)``."""
    if cfg.pure_fsdp:
        emb = gather_fsdp(params["emb"], cfg)
        return logits_apply({"emb": emb}, x, cfg.vocab, start=0), 0
    return (logits_apply(params, x, cfg.vocab),
            _vocab_start(params["emb"]))


def logits_apply(params, x, vocab: Optional[int] = None,
                 start: Optional[int] = None):
    """Logits in bf16; padded vocab rows masked to -1e30.  On the CPU the
    product is XLA's CPU dot (``_bf16_matmul``: f32 over the bf16
    operands, rounded once): torch's CPU bf16 GEMM differs from it by an
    ulp in a few logits, more often on a sliced ``x``.  Under a mesh the
    result is this rank's block of the padded vocab (its rows of the
    table), padded rows masked by their global index (``start``, the
    index of its first row, where the table is not the 'model' block)."""
    lg = _bf16_matmul(x.to(COMPUTE_DTYPE), params["emb"].to(COMPUTE_DTYPE).T)
    if start is None:
        start = _vocab_start(params["emb"])
    if vocab is not None and start + lg.shape[-1] > vocab:
        iota = start + torch.arange(lg.shape[-1], device=lg.device)
        lg = torch.where(iota < vocab, lg,
                         torch.full_like(lg, -1e30))
    return lg


def greedy(logits) -> torch.Tensor:
    """The argmax over the vocab (the lower index on a tie, as
    ``jnp.argmax``), int64.  Under a mesh ``logits`` is this rank's vocab
    block: the max over 'model', then the least global index holding it."""
    if current_mesh() is None:
        return logits.argmax(dim=-1)
    i = logits.argmax(dim=-1)
    v = logits.gather(-1, i[..., None])[..., 0].float()
    i = i + coll.index("model") * logits.shape[-1]
    top = coll.all_reduce(v, "model", "max")
    cand = torch.where(v == top, i, torch.full_like(i, torch.iinfo(
        torch.int64).max))
    return coll.all_reduce(cand, "model", "min")


def rotary_embedding(positions, dim: int, base: float = 10000.0):
    """Returns (sin, cos) ``[..., dim/2]`` in f32.  Every tensor is made
    on the device (no host-to-device copy), so a CUDA graph can hold it.
    On the CPU the frequencies and the sine and cosine are the C library's
    ``powf``, ``sinf`` and ``cosf``, which XLA's CPU backend calls (it
    folds the reference's ``1 / base**e`` into ``base**(-e)``); torch's
    vectorised ``pow``, ``sin`` and ``cos`` differ from them by an ulp at
    a few percent of rotary arguments.  On the card, torch's."""
    if positions.device.type == "cpu":
        return _libm_rotary(positions, dim, float(base))
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv = torch.pow(torch.full((), base, dtype=torch.float32,
                               device=positions.device), -exps)
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.sin(ang), torch.cos(ang)


@functools.lru_cache(maxsize=None)
def _libm():
    """The C library's f32 ``powf``, ``sinf`` and ``cosf``."""
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    fns = {}
    for name, n_args in (("powf", 2), ("sinf", 1), ("cosf", 1)):
        f = getattr(lib, name)
        f.restype, f.argtypes = ctypes.c_float, [ctypes.c_float] * n_args
        fns[name] = f
    return fns


@functools.lru_cache(maxsize=None)
def _libm_inv_freq(dim: int, base: float) -> torch.Tensor:
    """``powf(base, -e)`` for the rotary exponents ``e = arange(0, dim, 2)
    / dim`` (f32)."""
    powf = _libm()["powf"]
    exps = np.arange(0, dim, 2, dtype=np.float32) / np.float32(dim)
    return torch.tensor([powf(base, -float(e)) for e in exps],
                        dtype=torch.float32)


def libm_sincosf(ang: torch.Tensor):
    """``(sinf(ang), cosf(ang))`` of a CPU f32 tensor, one C library call
    an element."""
    fns = _libm()
    vals = ang.reshape(-1).tolist()
    return tuple(torch.tensor([fns[n](v) for v in vals],
                              dtype=torch.float32).reshape(ang.shape)
                 for n in ("sinf", "cosf"))


# (dim, base) -> [sin, cos, filled]: the rows of integer positions
# computed so far (the C library is called once an element), grown by
# doubling
_ROTARY_ROWS: Dict[tuple, list] = {}


def _libm_rotary(positions, dim: int, base: float):
    inv = _libm_inv_freq(dim, base)
    if positions.is_floating_point() or (
            positions.numel() and int(positions.min()) < 0):
        return libm_sincosf(positions.to(torch.float32)[..., None] * inv)
    idx = positions.long()
    need = int(idx.max()) + 1 if idx.numel() else 0
    rows = _ROTARY_ROWS.get((dim, base))
    if rows is None or rows[2].shape[0] < need:
        P = 1 << max(need - 1, 255).bit_length()
        grown = [torch.zeros(P, inv.numel(), dtype=torch.float32),
                 torch.zeros(P, inv.numel(), dtype=torch.float32),
                 torch.zeros(P, dtype=torch.bool)]
        for new, old in zip(grown, rows or ()):
            new[:old.shape[0]] = old
        rows = _ROTARY_ROWS[(dim, base)] = grown
    todo = torch.unique(idx)
    todo = todo[~rows[2][todo]]
    if todo.numel():
        s, c = libm_sincosf(todo.to(torch.float32)[:, None] * inv)
        rows[0][todo], rows[1][todo], rows[2][todo] = s, c, True
    return rows[0][idx], rows[1][idx]


def apply_rotary(x, sin, cos):
    """x ``[..., S, H, hd]``; sin/cos ``[..., S, hd/2]`` broadcast over
    heads.  On the CPU as XLA's CPU backend computes it: ``x1 * c - x2 *
    s`` contracted into ``fma(x1, c, -(x2 * s))`` (and ``fma(x2, c, x1 *
    s)``), the fused product taken exactly in f64."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    s, c = sin[..., None, :], cos[..., None, :]
    if x.device.type == "cpu":
        c64 = c.double()
        return torch.cat([(x1.double() * c64 - (x2 * s).double()).float(),
                          (x2.double() * c64 + (x1 * s).double()).float()],
                         dim=-1).to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def silu(x):
    """``jax.nn.silu`` as XLA computes it: ``x * (1 / (1 + exp(-x)))``
    with every op rounded to ``x``'s dtype, where torch's fused ``silu``
    rounds once.  In bf16 the two differ by one ulp on about 5% of inputs;
    this form equals JAX's on every bf16 input whose result is a normal
    number (XLA flushes subnormal results to zero)."""
    return x * torch.reciprocal(torch.exp(-x) + 1)


_F32_TINY = torch.finfo(torch.float32).tiny
_GELU_C = math.sqrt(2 / math.pi)
_GELU_K = 0.044715


def gelu(x, f32_out: bool = False):
    """``jax.nn.gelu`` (``approximate=True``: the tanh form) as XLA's CPU
    backend computes it: every op in f32, its result flushed to zero when
    subnormal (XLA runs with flush-to-zero) and rounded to ``x``'s dtype,
    ``x ** 3`` as ``(x * x) * x`` with a rounding between, the constants
    ``sqrt(2 / pi)`` and ``0.044715`` rounded to that dtype first.  torch's
    ``gelu`` (erf, or tanh rounded once) differs from it in bf16 on about
    43% of inputs; this form equals ``jax.jit(jax.nn.gelu)`` on every
    finite bf16 input.  ``f32_out`` returns the last product ``x * cdf``
    in f32, unrounded: XLA fuses it into the next linear's activation
    quantiser (``models.lm.ffn_apply``)."""
    dt = x.dtype

    def r(v):
        v = torch.where(v.abs() < _F32_TINY, v * 0, v)
        return v.to(dt).to(torch.float32)

    c, k = (torch.tensor(v, dtype=torch.float32).to(dt).item()
            for v in (_GELU_C, _GELU_K))
    xf = r(x.to(torch.float32))
    x3 = r(r(xf * xf) * xf)
    t = r(torch.tanh(r(c * r(xf + r(k * x3)))))
    y = xf * r(0.5 * r(1 + t))
    if f32_out:
        return y
    return r(y).to(dt)


def act_fn(kind: str):
    return {"gelu": gelu, "silu": silu,
            "relu": nn.functional.relu}["silu" if kind == "swiglu" else kind]


def init_embedding(gen: torch.Generator, vocab: int, d: int, device="cuda",
                   dtype=torch.bfloat16):
    """Embedding drawn N(0, 0.02^2).  Serving draws it in bf16, the dtype
    every use casts it to, so no f32 copy is ever held (a 256000 x 8192
    f32 draw alone would be 8.4 GB); training keeps the f32 master
    (``dtype=torch.float32``), as the reference does."""
    emb = torch.randn((padded_vocab(vocab), d), generator=gen,
                      dtype=dtype, device=device)
    return {"emb": with_spec(emb.mul_(0.02), P("model", None))}  # vocab-par.


def init_rmsnorm(d: int, device="cuda"):
    return {"scale": with_spec(torch.ones(d, dtype=torch.float32,
                                          device=device), P(None))}


def init_layernorm(d: int, device="cuda"):
    return {"scale": with_spec(torch.ones(d, dtype=torch.float32,
                                          device=device), P(None)),
            "bias": with_spec(torch.zeros(d, dtype=torch.float32,
                                          device=device), P(None))}


def layernorm_apply(params, x, eps: float = 1e-5):
    """LayerNorm in f32 (variance with ddof 0, as ``jnp.var``), to
    ``x``'s dtype."""
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]
    return y.to(x.dtype)

