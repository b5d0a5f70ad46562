"""Mixture-of-Experts FFN (port of ``repro.models.moe``): top-k routing,
grouped capacity dispatch, shared experts, the load-balance aux loss.

Tokens are routed per group (a sequence, or a slice of one): the router
runs in f32, the top ``k`` experts' probabilities are renormalised into
gates, and each (token, slot) takes the next queue position of its expert
in the flattened ``t * k`` order; a position at or past the capacity
``cap = max(int(capacity_factor * t * k / E), 1)`` drops that assignment.
Dispatch and combine are one-hot einsums, as in the reference: shape-static
and free of host syncs, so the serve loop's CUDA graphs capture them.  The
capacity depends on the group's length, so a paged prefill chunk (one group
of ``chunk`` rows, padding rows routed like the others) drops differently
from a dense prefill of the whole prompt: the reference's behaviour,
mirrored.

Serving, the expert linears run through ``nn.serve_expert_linear_apply``:
one launch of the lookup kernel over each expert-stacked linear.
Training (``apply_fn=nn.linear_apply``), they run through the same
``apply_fn`` on ``xe [G, E, cap, D]`` (the train linear's expert-stacked
``w [E, K, N]``), and the router's softmax holds its max constant in
the backward, as ``jax.nn.softmax`` does.

Ties: ``jax.lax.top_k`` takes the lower expert index first; ``torch.topk``
promises no order among equal values, so the top k come from a stable
descending sort.

Expert parallelism (serving under ``launch.mesh.mesh_context``): the expert
stacks are this rank's block of ``E / |model|`` experts (the reference's
``P('model', ...)``) and the residual stream is whole on every rank of
'model'.  The router is replicated, so every rank of 'model' routes its
batch rows alike; each dispatches only into its own experts, runs them
(one launch a stack), and combines their outputs into a partial sum over
its experts.  The partials are rounded to bf16, summed over 'model' in
f32 and the sum rounded once, as the reference's partitioned graph does
(read in its compiled HLO: the combine's dot rounded, converted to f32,
all-reduced).  The shared experts run tensor parallel over 'model'
(``nn.tp_linear_apply``).  The reference's GSPMD also shards the stream's
``d`` over 'model' (its router logits and norms sum ``d`` in partial sums
over 'model'); the port keeps the stream whole and sums ``d`` at once.
"""

from __future__ import annotations

import torch

from repro_torch.models import nn
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import P, current_mesh, with_spec

MAX_GROUP_TOKENS = 4096


def init_moe(gen, cfg, device="cuda", linear_init=nn.init_serve_linear):
    """Router ``w [d, E]`` f32 N(0, 0.02^2); expert-stacked ``wi``/``wg``
    ``[E] d -> d_expert`` and ``wo`` ``[E] d_expert -> d``; with
    ``n_shared`` the shared experts' ``shared_wi``/``shared_wg``/
    ``shared_wo`` of width ``d_expert * n_shared``.  The linears are
    ``linear_init``'s: serve linears, or the train path's
    ``nn.init_linear``."""
    d, E, F = cfg.d_model, cfg.n_experts, cfg.d_expert
    lin = linear_init
    w = torch.randn((d, E), generator=gen, dtype=torch.float32,
                    device=device).mul_(0.02)
    p = {"router": {"w": with_spec(w, P(None, None))},
         "wi": lin(gen, d, F, cfg, device=device, expert=E),
         "wg": lin(gen, d, F, cfg, device=device, expert=E),
         "wo": lin(gen, F, d, cfg, device=device, expert=E)}
    if cfg.n_shared:
        Fs = F * cfg.n_shared
        p["shared_wi"] = lin(gen, d, Fs, cfg, device=device)
        p["shared_wg"] = lin(gen, d, Fs, cfg, device=device)
        p["shared_wo"] = lin(gen, Fs, d, cfg, device=device,
                             shard=("model", None))
    return p


def moe_apply(params, x, cfg, apply_fn=nn.serve_linear_apply,
              expert_apply_fn=None):
    """x ``[B, S, D]`` -> ``(y [B, S, D], aux_loss)``.  Each sequence is a
    routing group; one longer than ``MAX_GROUP_TOKENS`` is cut into groups
    of that many tokens.  ``expert_apply_fn`` defaults to
    ``nn.serve_expert_linear_apply`` under the serve linear and to
    ``apply_fn`` otherwise (the reference's rule)."""
    if expert_apply_fn is None:
        expert_apply_fn = (nn.serve_expert_linear_apply
                           if apply_fn is nn.serve_linear_apply else apply_fn)
    if (current_mesh() is not None
            and expert_apply_fn is not nn.serve_expert_linear_apply):
        return _moe_train_sharded(params, x, cfg, apply_fn)
    B, S, D = x.shape
    if S > MAX_GROUP_TOKENS:
        if S % MAX_GROUP_TOKENS:
            raise ValueError(f"a sequence of {S} tokens does not cut into "
                             f"groups of {MAX_GROUP_TOKENS}")
        xg = x.reshape(B * (S // MAX_GROUP_TOKENS), MAX_GROUP_TOKENS, D)
        y, aux = _moe_grouped(params, xg, cfg, apply_fn, expert_apply_fn)
        return y.reshape(B, S, D), aux
    return _moe_grouped(params, x, cfg, apply_fn, expert_apply_fn)


def _span(name: str):
    """A profiler range ``repro_torch.moe.<name>`` (host side: inside a
    captured graph it is recorded at capture, not at replay)."""
    return torch.profiler.record_function(f"repro_torch.moe.{name}")


def _one_hot(idx, n: int, dtype):
    """``jax.nn.one_hot``: an index outside ``[0, n)`` is a row of zeros
    (a comparison, which needs no host check of the indices)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _dot(eq: str, a, b):
    """A bf16 einsum: on the card cuBLAS (f32 sums); on the CPU the f32
    product of the bf16 operands rounded once, as XLA's CPU dot."""
    if a.device.type == "cuda":
        return torch.einsum(eq, a, b)
    return torch.einsum(eq, a.float(), b.float()).to(nn.COMPUTE_DTYPE)


def route(router_w, x, cfg):
    """The router of one batch of groups ``x [G, t, D]``: ``(probs [G, t,
    E] f32, gates [G, t, k] f32 (dropped assignments zeroed), eidx [G, t,
    k], keep [G, t, k], pos [G, t, k], cap)``."""
    G, t, _ = x.shape
    E, k = cfg.n_experts, cfg.top_k
    cap = max(int(cfg.capacity_factor * t * k / E), 1)
    logits = torch.einsum("gtd,de->gte", x.to(torch.float32), router_w)
    u = torch.exp(logits - logits.amax(dim=-1, keepdim=True).detach())
    probs = u / u.sum(dim=-1, keepdim=True)
    gates, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = gates[..., :k], eidx[..., :k]
    gates = gates / gates.sum(dim=-1, keepdim=True)
    # queue position of each (token, slot) within its expert, per group
    flat = _one_hot(eidx, E, torch.int32).reshape(G, t * k, E)
    pos = torch.cumsum(flat, dim=1, dtype=torch.int32) - flat
    pos = (pos * flat).sum(dim=-1).reshape(G, t, k)
    keep = pos < cap
    return probs, gates * keep, eidx, keep, pos, cap


def local_experts(params, cfg) -> tuple:
    """``(e0, E_l)``: the first global index and the count of the experts
    whose stacks ``params`` holds: all of them without a mesh, this rank's
    block of 'model' under one.  An expert count that does not divide over
    'model' is refused, as ``shard_shape`` refuses an uneven dim."""
    E = cfg.n_experts
    if current_mesh() is None:
        return 0, E
    m = coll.size("model")
    if E % m:
        raise ValueError(f"{E} experts do not divide over 'model' ({m} "
                         "ranks)")
    held = next(v for v in params["wi"].values()      # every leaf leads
                if isinstance(v, torch.Tensor))          # with E
    if held.shape[0] != E // m:
        raise ValueError(f"the expert stacks hold {held.shape[0]} experts, "
                         f"not this rank's {E // m} of {E}")
    return coll.index("model") * (E // m), E // m


class _Uses(torch.autograd.Function):
    """``n`` uses of one tensor whose gradients are summed in its dtype
    from the last use to the first."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.dtype = x.dtype
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *gs):
        total = None
        for g in reversed(gs):
            if g is not None:
                g = g.to(ctx.dtype)
                total = g if total is None else total + g
        return total, None


def _uses(x, n: int) -> tuple:
    """``x`` for each of its ``n`` uses in the FFN (the router, the
    dispatch, the shared experts' wi and wg).  Autograd adds their bf16
    gradients in the order they arrive, which differs between the sharded
    step's graph and the unsharded one's; summed in one fixed order (the
    order in which they arrive in the unsharded graph: the shared experts'
    wg, wi, then the dispatch, then the router), both steps are bit-equal
    on one rank."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return (x,) * n
    return _Uses.apply(x, n)


class _FirstRankGrad(torch.autograd.Function):
    """The identity; the backward passes the gradient on the first rank of
    ``axes`` and zeros on the others (the same graph on every rank, so
    every rank issues its backward's collectives in one order)."""

    @staticmethod
    def forward(ctx, t, axes):
        ctx.first = coll.index(axes) == 0
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.first else torch.zeros_like(g)), None


def _moe_grouped(params, x, cfg, apply_fn, expert_apply_fn):
    ep = current_mesh() is not None
    xr, xd, xi, xg = _uses(x, 4)
    ye, comb, probs, eidx = _routed(params, xr, xd, cfg, expert_apply_fn)
    with _span("combine"):
        y = _dot("gtec,gecd->gtd", comb, ye)
        if ep:      # bf16 partials over the local experts, summed in f32
            y = coll.all_reduce(y.float(), "model").to(nn.COMPUTE_DTYPE)
    if cfg.n_shared:
        with _span("shared"):
            y = y + (_tp_shared(params, x, cfg) if ep
                     else _shared(params, xi, xg, cfg, apply_fn))
    return y.to(x.dtype), _aux(probs, eidx, cfg)


def _routed(params, xr, xd, cfg, expert_apply_fn, every_expert=False):
    """Route the groups ``xr [G, t, D]``, dispatch ``xd`` (the same
    tensor, another use) into the experts whose stacks ``params`` holds
    and run them: ``(ye [G, E_l, cap, D], comb, probs, eidx)``, ``comb
    [G, t, E_l, cap]`` the combine weights of those experts (of every
    expert with ``every_expert``: the sharded train step's, which gathers
    the experts' outputs)."""
    bf = nn.COMPUTE_DTYPE
    e0, El = local_experts(params, cfg)
    with _span("route"):
        probs, gates, eidx, keep, pos, cap = route(params["router"]["w"],
                                                   xr, cfg)
    with _span("dispatch"):
        oh_c = _one_hot(torch.where(keep, pos, torch.full_like(pos, cap)),
                        cap, bf)
        oh_eb = _one_hot(eidx - e0, El, bf)                  # [G, t, k, E_l]
        disp = _dot("gtke,gtkc->gtec", oh_eb, oh_c)          # [G, t, E_l, cap]
        xe = _dot("gtec,gtd->gecd", disp, xd.to(bf))         # [G, E_l, cap, D]
    with _span("experts"):
        # serving, XLA rounds the experts' gated product to bf16 before
        # wo's quantiser (read in the compiled HLO), where it feeds the
        # shared experts' and the dense FFN's product to wo in f32; the
        # train linear's quantiser reads the experts' product in f32 too
        # (found by the train forward's bit-equality)
        hi = expert_apply_fn(params["wi"], xe, cfg)
        if expert_apply_fn is nn.linear_apply:
            hi = hi.float()
        h = hi * nn.silu(expert_apply_fn(params["wg"], xe, cfg))
        ye = expert_apply_fn(params["wo"], h, cfg)           # [G, E_l, cap, D]
    with _span("combine"):
        oh = _one_hot(eidx, cfg.n_experts, bf) if every_expert else oh_eb
        comb = _dot("gtke,gtkc->gtec", oh * gates.to(bf)[..., None], oh_c)
    return ye, comb, probs, eidx


def _aux(probs, eidx, cfg, batch_axes=None):
    """The Switch-style load-balance loss ``E * sum(me * ce)``: ``me`` the
    mean router probability of each expert, ``ce`` the share of tokens
    whose first choice it is.  ``batch_axes`` (the sharded train step's):
    both means are over the global batch, each rank's summed over those
    axes (its rows are as many as every other rank's)."""
    E = cfg.n_experts
    me = probs.reshape(-1, E).mean(dim=0)
    ce = _one_hot(eidx[..., 0].reshape(-1), E, torch.float32).mean(dim=0)
    if batch_axes is not None:
        n = coll.size(batch_axes)
        me = coll.all_reduce_ad(me, batch_axes) / n
        ce = coll.all_reduce(ce, batch_axes) / n
    return E * (me * ce).sum()


def _moe_train_sharded(params, x, cfg, apply_fn):
    """``moe_apply`` of the sharded train step under tensor parallelism:
    ``x [B, S_l, D]`` this rank's sequence block of its batch rows (the
    layer boundary is sequence-sharded, Megatron-SP), returns ``(y [B,
    S_l, D], aux)`` for the same block.

    A routing group is a whole sequence (or a ``MAX_GROUP_TOKENS`` slice
    of one), so the sequence is gathered over 'model' (backward:
    reduce-scatter) and every rank of 'model' routes it alike.  Each
    dispatches into its own experts and runs them; their outputs are
    gathered over 'model' (backward: each expert's gradient summed over
    the ranks' tokens), and each rank combines every expert for its own
    sequence block, one f32 product rounded to bf16, as the reference's
    partitioned train graph does (read in its compiled HLO: the experts'
    outputs all-gathered, the combine's dot on the device's tokens).  The
    shared experts run tensor parallel: ``shared_wi``/``shared_wg`` on this
    rank's columns, ``shared_wo``'s f32 partials reduce-scattered onto the
    block and rounded once; the two are added in bf16.

    The aux loss is the global batch's on every rank.  Every rank of
    'model' computes it on the same tokens, so only the first lets its
    gradient through (``_FirstRankGrad``): the router's gradient is summed
    over 'model' (``train.trainer.grad_axes``), where its gate path is a
    partial over each rank's experts."""
    bf = nn.COMPUTE_DTYPE
    xs = coll.all_gather_ad(x, "model", dim=1)
    B, S, D = xs.shape
    t = min(S, MAX_GROUP_TOKENS)
    if S % t:
        raise ValueError(f"a sequence of {S} tokens does not cut into "
                         f"groups of {MAX_GROUP_TOKENS}")
    S_l, s0 = x.shape[1], coll.index("model") * x.shape[1]
    if (S_l % t if S_l > t else t % S_l):
        raise NotImplementedError(
            f"a sequence block of {S_l} tokens that is neither inside one "
            f"routing group of {t} tokens nor a run of whole groups")

    n = S // t
    xr, xd, xi, xg = _uses(xs, 4)
    ye, comb, probs, eidx = _routed(params, xr.reshape(B * n, t, D),
                                    xd.reshape(B * n, t, D), cfg,
                                    nn.linear_apply, every_expert=True)
    with _span("combine"):
        # the rank's block: groups [j0, j0 + nj) of each sequence, tokens
        # [off, off + tb) of each
        ye = coll.all_gather_ad(ye, "model", dim=1)       # [G, E, cap, D]
        nj, tb, j0, off = max(S_l // t, 1), min(S_l, t), s0 // t, s0 % t
        comb = comb.reshape(B, n, *comb.shape[1:])[:, j0:j0 + nj,
                                                    off:off + tb]
        ye = ye.reshape(B, n, *ye.shape[1:])[:, j0:j0 + nj]
        y = _dot("gtec,gecd->gtd", comb.reshape(B * nj, *comb.shape[2:]),
                 ye.reshape(B * nj, *ye.shape[2:])).reshape(B, S_l, D)
    if cfg.n_shared:
        with _span("shared"):
            sh = coll.reduce_scatter_ad(_shared(params, xi, xg, cfg,
                                                apply_fn), "model", dim=1)
            y = y + sh.to(bf)
    aux = _FirstRankGrad.apply(_aux(probs, eidx, cfg,
                                    nn.train_batch_axes(cfg)), "model")
    return y.to(x.dtype), aux


def _shared(params, xi, xg, cfg, apply_fn):
    """The shared experts on ``xi`` and ``xg`` (two uses of one input): a
    SwiGLU whose gated product reaches ``shared_wo`` in f32."""
    hs = apply_fn(params["shared_wi"], xi, cfg).float() * nn.silu(
        apply_fn(params["shared_wg"], xg, cfg))
    return apply_fn(params["shared_wo"], hs, cfg)


def _tp_shared(params, x, cfg):
    """``_shared`` under the mesh, tensor parallel over 'model': wi and wg
    on this rank's columns (or whole), each on its own activation step,
    ``shared_wo`` following its spec; the output whole."""
    h, split = nn.tp_linear_apply(params["shared_wi"], x, cfg)
    g, _ = nn.tp_linear_apply(params["shared_wg"], x, cfg)
    hs = h.float() * nn.silu(g)
    return nn.gather_cols(*nn.tp_linear_apply(params["shared_wo"], hs, cfg,
                                              split=split))
