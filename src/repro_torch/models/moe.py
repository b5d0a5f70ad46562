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
    held = next(iter(params["wi"].values()))     # every leaf leads with E
    if held.shape[0] != E // m:
        raise ValueError(f"the expert stacks hold {held.shape[0]} experts, "
                         f"not this rank's {E // m} of {E}")
    return coll.index("model") * (E // m), E // m


def _moe_grouped(params, x, cfg, apply_fn, expert_apply_fn):
    G, t, D = x.shape
    bf = nn.COMPUTE_DTYPE
    ep = current_mesh() is not None
    if ep and expert_apply_fn is not nn.serve_expert_linear_apply:
        raise NotImplementedError(
            "the train MoE under a mesh: expert-parallel training is ROADMAP "
            "queue 1's next item")
    e0, El = local_experts(params, cfg)
    with _span("route"):
        probs, gates, eidx, keep, pos, cap = route(params["router"]["w"], x,
                                                   cfg)
    with _span("dispatch"):
        oh_c = _one_hot(torch.where(keep, pos, torch.full_like(pos, cap)),
                        cap, bf)
        oh_eb = _one_hot(eidx - e0, El, bf)                  # [G, t, k, E_l]
        disp = _dot("gtke,gtkc->gtec", oh_eb, oh_c)          # [G, t, E_l, cap]
        xe = _dot("gtec,gtd->gecd", disp, x.to(bf))          # [G, E_l, cap, D]
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
        ye = expert_apply_fn(params["wo"], h, cfg)           # [G, E, cap, D]
    with _span("combine"):
        comb = _dot("gtke,gtkc->gtec", oh_eb * gates.to(bf)[..., None], oh_c)
        y = _dot("gtec,gecd->gtd", comb, ye)
        if ep:      # bf16 partials over the local experts, summed in f32
            y = coll.all_reduce(y.float(), "model").to(bf)
    if cfg.n_shared:
        with _span("shared"):
            y = y + (_tp_shared(params, x, cfg) if ep
                     else _shared(params, x, cfg, apply_fn))
    # Switch-style load-balance auxiliary loss (serve discards it)
    E = cfg.n_experts
    me = probs.reshape(-1, E).mean(dim=0)
    ce = _one_hot(eidx[..., 0].reshape(-1), E, torch.float32).mean(dim=0)
    aux = E * (me * ce).sum()
    return y.to(x.dtype), aux


def _shared(params, x, cfg, apply_fn):
    """The shared experts: a SwiGLU whose gated product reaches
    ``shared_wo`` in f32."""
    hs = apply_fn(params["shared_wi"], x, cfg).float() * nn.silu(
        apply_fn(params["shared_wg"], x, cfg))
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
