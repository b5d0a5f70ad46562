"""RecurrentGemma / Griffin recurrent block (arXiv:2402.19427) of the
serve path, the port of ``repro.models.rglru``:

    x -> [linear -> causal conv1d(4) -> RG-LRU] * silu(linear gate) -> out

RG-LRU:
    r_t = sigmoid(W_r x_t),  i_t = sigmoid(W_i x_t)
    log a_t = -c * softplus(Lambda) * r_t          (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

A prefill runs the linear recurrence as ``associative_scan``, which
combines elements in the order of ``jax.lax.associative_scan`` (log2(S)
vectorised levels); a sequential loop would round differently.  Decode
is the one-step cell.  The gates are f32 products of plain weights, as
in the reference.  The train forward runs the same functions under
autograd (``apply_fn=nn.linear_apply``): the scan's interleave writes
only into tensors it makes.  Under a mesh the serve forward is
``tp_rglru_block_apply`` and the train forward ``tp_rglru_train``, both on
this rank's block of the lru channels.
"""

from __future__ import annotations

import torch

from repro_torch.core.quant.quantizers import _softplus
from repro_torch.models import nn
from repro_torch.models.xlstm import _conv_step, _winit
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import P, with_spec

_C = 8.0


def init_rglru_block(gen, cfg, device="cuda",
                     linear_init=nn.init_serve_linear):
    """The reference's leaves: ``linear_init``'s linears (serve, or the
    train path's ``nn.init_linear``) ``win``/``wgate`` d -> lru and
    ``wout`` lru -> d; f32 ``conv.w [W, lru]``, ``wr.w``/``wi.w [lru,
    lru]`` and ``lam.l [lru]``, Lambda drawn so that a^(1/r) lies in
    [0.9, 0.999]."""
    d = cfg.d_model
    lru = cfg.lru_dim or d
    lin = linear_init
    lam = torch.empty(lru, dtype=torch.float32, device=device).uniform_(
        0.9, 0.999, generator=gen)
    return {
        "win": lin(gen, d, lru, cfg, device=device),
        "wgate": lin(gen, d, lru, cfg, device=device),
        "conv": {"w": with_spec(_winit(gen, (cfg.conv_width, lru), 0.1,
                                       device), P(None, "model"))},
        "wr": {"w": with_spec(_winit(gen, (lru, lru), 0.02, device),
                              P("model", None))},
        "wi": {"w": with_spec(_winit(gen, (lru, lru), 0.02, device),
                              P("model", None))},
        "lam": {"l": with_spec(
            torch.log(torch.exp(-torch.log(lam) / _C) - 1.0), P("model"))},
        "wout": lin(gen, lru, d, cfg, device=device, shard=("model", None)),
    }


def rglru_zero_state(B, lru, conv_width=4, device="cuda",
                     dtype=torch.float32, lead=()):
    """``h [B, lru]`` and ``conv``, the last ``conv_width - 1`` pre-conv
    inputs ``[B, W-1, lru]`` (zeros: the causal left padding)."""
    return {"h": torch.zeros((*lead, B, lru), dtype=dtype, device=device),
            "conv": torch.zeros((*lead, B, conv_width - 1, lru),
                                dtype=dtype, device=device)}


def _gates(params, u, reduce=None):
    """u ``[B, S, lru]`` (after the conv) -> ``(log_a, bx)`` in f32.
    ``reduce``: applied to each gate's product first (under the mesh the
    sum of its partials over 'model', this rank's channels of it)."""
    uf = u.to(torch.float32)
    mm = (lambda w: uf @ w) if reduce is None else (lambda w: reduce(uf @ w))
    r = torch.sigmoid(mm(params["wr"]["w"]))
    i = torch.sigmoid(mm(params["wi"]["w"]))
    log_a = -_C * _softplus(params["lam"]["l"]) * r
    a2 = torch.exp(2.0 * log_a)
    # jnp.maximum (a tie splits the gradient), not torch.clamp
    bx = torch.sqrt(torch.maximum(1.0 - a2, a2.new_full((), 1e-9))) * (
        i * uf)
    return log_a, bx


def _comb(l, r):
    """(a, b) o (a', b') = (a a', a' b + b') in log space for a."""
    return l[0] + r[0], torch.exp(r[0]) * l[1] + r[1]


def associative_scan(fn, elems, dim: int):
    """``jax.lax.associative_scan(fn, elems, axis=dim)`` over a tuple of
    tensors, in its order of combination: combine adjacent pairs, scan
    those recursively, then combine the scanned odd prefixes with the
    even elements, and interleave."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def sl(e, start, stop=None, step=1):
        idx = [slice(None)] * e.dim()
        idx[dim] = slice(start, stop, step)
        return e[tuple(idx)]

    reduced = fn(tuple(sl(e, 0, -1, 2) for e in elems),
                 tuple(sl(e, 1, None, 2) for e in elems))
    odd = associative_scan(fn, reduced, dim)
    if n % 2 == 0:
        even = fn(tuple(sl(e, 0, -1) for e in odd),
                  tuple(sl(e, 2, None, 2) for e in elems))
    else:
        even = fn(odd, tuple(sl(e, 2, None, 2) for e in elems))
    even = tuple(torch.cat([sl(e, 0, 1), r], dim=dim)
                 for e, r in zip(elems, even))
    out = []
    for a, b in zip(even, odd):
        shape = list(a.shape)
        shape[dim] = a.shape[dim] + b.shape[dim]
        y = a.new_empty(shape)
        sl(y, 0, None, 2).copy_(a)
        sl(y, 1, None, 2).copy_(b)
        out.append(y)
    return tuple(out)


def _recur(params, u_in, state, cfg, reduce=None):
    """The conv and the RG-LRU over ``u_in [B, S, lru]`` (f32) from
    ``state``: ``(hs [B, S, lru], new state)``."""
    S = u_in.shape[1]
    h0 = state["h"]
    u, new_conv = _conv_step(state["conv"], u_in, params["conv"]["w"], S,
                             cfg.conv_width)
    log_a, bx = _gates(params, u, reduce)
    if S == 1:
        h = torch.exp(log_a[:, 0]) * h0 + bx[:, 0]
        hs = h[:, None, :]
    else:
        # the initial state enters the first step
        bx = torch.cat([bx[:, :1] + torch.exp(log_a[:, :1]) * h0[:, None],
                        bx[:, 1:]], dim=1)
        _, hs = associative_scan(_comb, (log_a, bx), dim=1)
        h = hs[:, -1]
    return hs, {"h": h, "conv": new_conv}


def rglru_block_apply(params, x, cfg, state=None,
                      apply_fn=nn.serve_linear_apply):
    """x ``[B, S, d]`` -> ``(y, state)``; S == 1 is a decode step."""
    B, S, d = x.shape
    u_in = apply_fn(params["win"], x, cfg).to(torch.float32)
    if state is None:
        state = rglru_zero_state(B, u_in.shape[-1], cfg.conv_width,
                                 device=x.device)
    hs, state = _recur(params, u_in, state, cfg)
    g = nn.silu(apply_fn(params["wgate"], x, cfg))
    # the gated product reaches wout's quantiser in f32, unrounded, as XLA
    # fuses it (models.lm.ffn_apply)
    y = apply_fn(params["wout"], hs.to(x.dtype).float() * g, cfg)
    return y, state


def tp_rglru_block_apply(params, x, cfg, state):
    """``rglru_block_apply`` of a serve forward under the mesh, on this
    rank's block of the lru channels: ``win``/``wgate`` column-parallel
    (``nn.tp_linear_apply``), the conv, ``lam``, the recurrence and the
    state ``h``/``conv`` (``state``, this rank's blocks) on its channels.
    ``wr``/``wi`` are cut on their input dim (P('model', None)), so each
    gate's f32 product is a partial sum over 'model': all-reduced whole,
    then this rank's channels kept, as the reference's compiled graph
    all-reduces both gates' f32 partials.  ``wout`` is row-parallel.
    Returns ``(y whole, state)``."""
    u_in = nn.own_cols(*nn.tp_linear_apply(params["win"], x, cfg))
    hs, state = _recur(params, u_in.to(torch.float32), state, cfg,
                       lambda p: coll.split(coll.all_reduce(p, "model"),
                                            "model"))
    g = nn.silu(nn.own_cols(*nn.tp_linear_apply(params["wgate"], x, cfg)))
    y, split = nn.tp_linear_apply(params["wout"], hs.to(x.dtype).float() * g,
                                  cfg, split=True)
    return nn.gather_cols(y, split), state


def tp_rglru_train(params, x, cfg):
    """``rglru_block_apply`` of the sharded train step (from the zero
    state, with gradients) on this rank's block of the lru channels:
    ``x [B, S, d]`` the whole sequence of this rank's rows (gathered by
    the block, ``models.lm._tp_train_block``), so the conv and the
    recurrence run over the whole sequence on its channels (never across
    ranks).  ``win``/``wgate`` are column-parallel (``nn.linear_apply`` on
    this rank's columns); each gate's f32 product over ``wr``/``wi``'s
    rows (P('model', None)) is a partial sum, all-reduced over 'model'
    (backward: the gradient passed through) and cut to this rank's
    channels (backward: gathered), as the serve path reduces it.  Returns
    the row-parallel ``wout``'s f32 partial sum ``[B, S, d]`` (the block
    reduce-scatters it)."""
    lin = nn.linear_apply
    u_in = lin(params["win"], x, cfg).to(torch.float32)
    state = rglru_zero_state(x.shape[0], u_in.shape[-1], cfg.conv_width,
                             device=x.device)
    hs, _ = _recur(params, u_in, state, cfg, lambda p: coll.split_ad(
        coll.all_reduce_ad(p, "model"), "model"))
    g = nn.silu(lin(params["wgate"], x, cfg))
    return lin(params["wout"], hs.to(x.dtype).float() * g, cfg)
