"""xLSTM blocks (arXiv:2405.04517) of the serve path, the port of
``repro.models.xlstm``: mLSTM (matrix memory) and sLSTM (scalar memory
with state mixing), assembled 7:1 by ``models.lm.segments_for``.

mLSTM cell (stabilised exponential gating):
    m_t = max(f~_t + m_{t-1}, i~_t)
    f'  = exp(f~ + m_{t-1} - m_t),  i' = exp(i~ - m_t)
    C_t = f' C_{t-1} + i' v_t k_t^T          [B, H, hd, hd]
    n_t = f' n_{t-1} + i' k_t
    h_t = (C_t q_t) / max(|n_t . q_t|, exp(-m_t))

Both cells are one-step functions run by ``chunked_scan`` over the
sequence (prefill, the train forward) or once (decode).  ``chunked_scan``
is a loop over time; under autograd a sequence longer than one chunk
runs chunk by chunk, each chunk recomputed in the backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of each
chunk), so the backward holds the state at chunk boundaries and one
chunk's steps, not every step's ``[B, H, hd, hd]`` matrix memory.  The
linears are ``apply_fn``'s (lookup GEMMs serving under TLMAC, the
train linear under QAT); the gate projections ``wi``/``wf`` and the
sLSTM recurrence are f32 products of plain weights, as in the
reference.  Under a mesh the serve forwards are ``tp_mlstm_apply`` and
``tp_slstm_apply`` and the train forwards ``tp_mlstm_train`` and
``tp_slstm_train``, in one layout.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.core.quant.quantizers import _softplus
from repro_torch.launch import comm_analysis as ca
from repro_torch.models import nn
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import P, with_spec


def _depthwise_causal_conv(x, w):
    """x ``[B, S, C]``, w ``[W, C]`` -> the causal depthwise conv (zeros
    before the first position)."""
    W, S = w.shape[0], x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + xp[:, i:i + S, :] * w[i]
    return out


CHUNK = 64    # the reference's scan chunk: a longer scan must be a multiple
# on ``meta`` (the dry run's trace) a scan past one chunk runs a few of its
# steps and counts the rest (``_counted_scan``, ``_counted_chunks``);
# False runs every step there too
COUNTED = True


def _lead(xs) -> torch.Tensor:
    return xs[0] if isinstance(xs, tuple) else xs


def _steps(xs) -> int:
    return _lead(xs).shape[0]


def _at(xs, t):
    """Step ``t``'s input: ``xs`` (a tensor or a tuple of them, time
    leading) indexed at ``t``."""
    return tuple(a[t] for a in xs) if isinstance(xs, tuple) else xs[t]


def _scan(cell, state, xs):
    """``cell`` over every step of ``xs``: ``(state, ys stacked)``."""
    ys = []
    for t in range(_steps(xs)):
        state, y = cell(state, _at(xs, t))
        ys.append(y)
    return state, torch.stack(ys)


def _probed(p, cell, state, x_of):
    """``cell`` on ``state`` and the input ``x_of()`` (indexed after the
    mark, so its backward falls inside), between ``p``'s marks."""
    keys = list(state)
    vals = ca.probe(p, "in", *(state[k] for k in keys))
    state, y = cell(dict(zip(keys, vals)), x_of())
    *vals, y = ca.probe(p, "out", *(state[k] for k in keys), y)
    return dict(zip(keys, vals)), y


def _repeated(p, times, held, saved, state):
    keys = list(state)
    return dict(zip(keys, ca.repeated(p, times, held, saved,
                                      *(state[k] for k in keys))))


def _storages(tree) -> set:
    return {t.untyped_storage()._cdata for t in tree.values()}


def _counted_scan(cell, state, xs, saves: bool):
    """``_scan`` on ``meta`` over T steps, counted: steps 0, 1, T-2 and T-1
    run, and the T-4 between are counted as step 1's work
    (``comm_analysis.repeat``; their backward as step T-2's).  What they
    would hold is made as placeholders of the bytes step 1 left alive:
    beside ``ys`` (their outputs) and, where the step's saved tensors are
    kept (``saves``: a checkpointed chunk's recomputation), saved until
    their backward (the step's saved tensors and its state, which the
    next step saves).  The first step (its input is the caller's) and the
    last two (the top of the loop's memory; the last one's state is the
    result) run as in ``_scan``.  The trace's cost, collectives, peak and
    temp bytes are ``_scan``'s."""
    T = _steps(xs)
    k = T - 4
    if k < 0:
        return _scan(cell, state, xs)
    dev = _lead(xs).device
    state, y = cell(state, _at(xs, 0))
    ys = [y]
    work, before = ca.Work(), ca.live_bytes()
    state, y = cell(state, _at(xs, 1))
    ys.append(y)
    grown = ca.live_bytes() - before
    ca.repeat(work.stop(), k)
    own = (0 if y.untyped_storage()._cdata in _storages(state)
           else y.untyped_storage().nbytes())
    per_y = own if saves else grown
    held = ca.placeholder(k * per_y, dev)   # the left-out outputs, as ys
    if torch.is_grad_enabled():
        p = ca.Probe()
        state = _repeated(p, k, ca.placeholder(k * (grown - per_y), dev),
                          True, state)
        state, y = _probed(p, cell, state, lambda: _at(xs, T - 2))
    else:
        state, y = cell(state, _at(xs, T - 2))
    ys.append(y)
    state, y = cell(state, _at(xs, T - 1))
    ys.append(y)
    out = ca.joined(ys, 2, k)
    del held, ys
    return state, out


def _chunk(xs, c: int):
    sl = slice(c * CHUNK, (c + 1) * CHUNK)
    return tuple(a[sl] for a in xs) if isinstance(xs, tuple) else xs[sl]


def _checkpointed(cell, state, chunk):
    """One chunk checkpointed as ``chunked_scan`` does, its steps counted
    (``_counted_scan``): its saved tensors are kept in the recomputation
    (every call of the function after the first)."""
    calls = []

    def scan(st, ch):
        calls.append(None)
        return _counted_scan(cell, st, ch, saves=len(calls) > 1)

    return torch.utils.checkpoint.checkpoint(
        scan, state, chunk, use_reentrant=False, preserve_rng_state=False)


def _counted_chunks(cell, state, xs, length: int):
    """``chunked_scan``'s checkpointed chunks on ``meta``, counted: of n
    chunks, 0, n-2 and n-1 run (each its steps counted), and the n-3
    between are counted as chunk 0's forward work and chunk n-2's
    backward work (recomputation included), with placeholders of the
    bytes chunk 0 left alive: its output beside ``ys`` and its state,
    which the next chunk's checkpoint holds until its backward."""
    n = length // CHUNK
    k = max(n - 3, 0)
    work, before = ca.Work(), ca.live_bytes()
    state, y = _checkpointed(cell, state, _chunk(xs, 0))
    ys, held = [y], []      # held: the left-out chunks' outputs, as ys
    if n > 2:
        grown = ca.live_bytes() - before
        ca.repeat(work.stop(), k)
        own = y.untyped_storage().nbytes()
        held.append(ca.placeholder(k * own, y.device))
        p = ca.Probe()
        state = _repeated(p, k, ca.placeholder(k * (grown - own), y.device),
                          False, state)
        state, y = _probed(p, lambda st, ch: _checkpointed(cell, st, ch),
                           state, lambda: _chunk(xs, n - 2))
        ys.append(y)
    state, y = _checkpointed(cell, state, _chunk(xs, n - 1))
    ys.append(y)
    return state, ca.joined(ys, 1, k, cat=True)


def chunked_scan(cell, state, xs, length: int):
    """``cell(state, x_t) -> (state, y_t)`` over the leading time axis of
    every tensor of the tuple ``xs``; returns ``(state, ys)`` with ``ys``
    stacked ``[length, ...]``.  Like the reference, a length past
    ``CHUNK`` that is not a multiple of it raises ``AssertionError``.
    With gradients on and ``length > CHUNK``, each chunk of ``CHUNK``
    steps is checkpointed (non-reentrant: recomputed in the backward);
    the values are the plain loop's, bit for bit.  On ``meta`` a scan
    past one chunk is counted (``COUNTED``): a few steps run, whatever the
    length, and the trace reads as the full loop's."""
    if length > CHUNK:
        assert length % CHUNK == 0, (length, CHUNK)
    counted = (COUNTED and length > CHUNK
               and _lead(xs).device.type == "meta")
    if length <= CHUNK or not torch.is_grad_enabled():
        return (_counted_scan(cell, state, xs, saves=False) if counted
                else _scan(cell, state, xs))
    if counted:
        return _counted_chunks(cell, state, xs, length)
    ys = []
    for c in range(length // CHUNK):
        state, y = torch.utils.checkpoint.checkpoint(
            _scan, cell, state, _chunk(xs, c), use_reentrant=False,
            preserve_rng_state=False)
        ys.append(y)
    return state, torch.cat(ys)


def log_sigmoid(x):
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``, softplus as
    ``logaddexp(x, 0)``."""
    return -_softplus(-x)


def _winit(gen, shape, scale: float, device):
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device) * scale


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm(gen, cfg, device="cuda", linear_init=nn.init_serve_linear):
    """The reference's mLSTM leaves: ``linear_init``'s linears (serve, or
    the train path's ``nn.init_linear``) ``up`` d -> 4d, ``wq``, ``wk``,
    ``wv`` 2d -> 2d and ``down`` 2d -> d; f32 ``conv.w [W, 2d]``, gate
    weights ``wi.w``/``wf.w [2d, H]`` and ``wf.b`` (3.0)."""
    d, H = cfg.d_model, cfg.n_heads
    inner = 2 * d
    lin = linear_init
    row = ("model", None)           # row-parallel: K on 'model'
    return {
        "up": lin(gen, d, 2 * inner, cfg, device=device),
        "conv": {"w": with_spec(_winit(gen, (cfg.conv_width, inner), 0.1,
                                       device), P(None, "model"))},
        "wq": lin(gen, inner, inner, cfg, device=device, shard=row),
        "wk": lin(gen, inner, inner, cfg, device=device, shard=row),
        "wv": lin(gen, inner, inner, cfg, device=device, shard=row),
        "wi": {"w": with_spec(_winit(gen, (inner, H), 0.02, device),
                              P("model", None))},
        "wf": {"w": with_spec(_winit(gen, (inner, H), 0.02, device),
                              P("model", None)),
               "b": with_spec(torch.full((H,), 3.0, dtype=torch.float32,
                                         device=device), P(None))},
        "down": lin(gen, inner, d, cfg, device=device, shard=row),
    }


def mlstm_zero_state(B, H, hd, conv_width=4, device="cuda",
                     dtype=torch.float32, lead=()):
    """``C [B, H, hd, hd]``, ``n [B, H, hd]``, ``m [B, H]`` (-1e30) and
    ``conv``, the last ``conv_width - 1`` pre-conv inputs ``[B, W-1, H
    hd]``; ``lead`` prepends a layer axis."""
    z = lambda *s: torch.zeros((*lead, *s), dtype=dtype, device=device)
    return {"C": z(B, H, hd, hd), "n": z(B, H, hd),
            "m": torch.full((*lead, B, H), -1e30, dtype=dtype,
                            device=device),
            "conv": z(B, conv_width - 1, H * hd)}


def _mlstm_cell(state, qkvif):
    """One mLSTM step.  ``C [B, H, i, j]`` takes ``v`` on its rows ``i``
    and ``k`` on its columns ``j``: under the mesh ``v`` and ``C`` are
    this rank's rows, ``q``, ``k``, ``n`` and ``m`` whole, so every sum
    (``C q`` over ``j``, ``n . q``) is whole on the rank."""
    q, k, v, it, ft = qkvif           # q/k/v [B, H, hd]; it/ft [B, H]
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(ft + m, it)
    fp = torch.exp(ft + m - m_new)
    ip = torch.exp(it - m_new)
    C = fp[..., None, None] * C + ip[..., None, None] * (
        v[..., :, None] * k[..., None, :])
    n = fp[..., None] * n + ip[..., None] * k
    num = torch.einsum("bhij,bhj->bhi", C, q)
    den = torch.maximum(torch.einsum("bhj,bhj->bh", n, q).abs(),
                        torch.exp(-m_new))
    return {"C": C, "n": n, "m": m_new}, num / den[..., None]


def _conv_step(state_conv, x32, w, S: int, conv_width: int):
    """The depthwise conv of ``x32 [B, S, C]`` after the carried tail
    ``state_conv [B, W-1, C]`` (decode: one position), and the new tail."""
    prev = state_conv.to(torch.float32)
    window = torch.cat([prev, x32], dim=1)
    if S == 1:
        c = torch.einsum("bwl,wl->bl", window, w)[:, None, :]
    else:
        c = _depthwise_causal_conv(x32, w)
    return c, window[:, -(conv_width - 1):]


def mlstm_apply(params, x, cfg, state=None, apply_fn=nn.serve_linear_apply):
    """x ``[B, S, d]`` -> ``(y, final_state)``; S == 1 is a decode step."""
    B, S, d = x.shape
    inner = 2 * d
    H = cfg.n_heads
    hd = inner // H
    u = apply_fn(params["up"], x, cfg)
    xi, z = u[..., :inner], u[..., inner:]
    if state is None:
        state = mlstm_zero_state(B, H, hd, cfg.conv_width, device=x.device)
    c, new_conv = _conv_step(state["conv"], xi.to(torch.float32),
                             params["conv"]["w"], S, cfg.conv_width)
    c = nn.silu(c).to(x.dtype)
    q = apply_fn(params["wq"], c, cfg).reshape(B, S, H, hd)
    k = apply_fn(params["wk"], c, cfg).reshape(B, S, H, hd) / _sqrt_f32(hd)
    v = apply_fn(params["wv"], xi, cfg).reshape(B, S, H, hd)
    c32 = c.to(torch.float32)
    it = torch.einsum("bsk,kh->bsh", c32, params["wi"]["w"])
    ft = torch.einsum("bsk,kh->bsh", c32, params["wf"]["w"])
    ft = log_sigmoid(ft + params["wf"]["b"])
    xs = (q.transpose(0, 1).to(torch.float32),
          k.transpose(0, 1).to(torch.float32),
          v.transpose(0, 1).to(torch.float32),
          it.transpose(0, 1), ft.transpose(0, 1))
    cell_state = {n: state[n] for n in ("C", "n", "m")}
    cell_state, hs = chunked_scan(_mlstm_cell, cell_state, xs, S)
    h = hs.transpose(0, 1).reshape(B, S, inner).to(x.dtype)
    # the gated product reaches down's quantiser in f32, unrounded, as
    # XLA fuses it (models.lm.ffn_apply)
    y = apply_fn(params["down"], h.float() * nn.silu(z), cfg)
    return y, dict(cell_state, conv=new_conv)


def _check_tp_heads(cfg) -> None:
    """Refuse the mLSTM layout in which the heads divide the production
    'model' axis (``lm.cache_axes``' ``h_ok`` branch: ``C``, ``n`` and
    ``m`` cut on heads), which no reference config has."""
    if cfg.n_heads % nn.MODEL_AXIS == 0:
        raise NotImplementedError(
            f"the mLSTM of {cfg.name!r} under a mesh with {cfg.n_heads} "
            f"heads: heads that divide the 'model' axis ({nn.MODEL_AXIS}) "
            "cut the state on heads (cache_axes' h_ok layout), which no "
            "reference config has; the port serves and trains the "
            "value-dim cut only")


def tp_mlstm_apply(params, x, cfg, state):
    """``mlstm_apply`` of a serve forward under the mesh, the state cut as
    the reference's ``cache_axes`` cuts it where the heads do not divide
    the 'model' axis: ``C [B, H, i, j]`` on its value dim ``i``, ``n [B,
    H, j]`` on its key dim ``j``, ``m`` whole, the conv tail on the inner
    channels.  ``up`` is column-parallel, its output gathered (``xi`` and
    ``z`` are its two halves); the conv and silu run on this rank's inner
    channels; the row-parallel ``wq``/``wk`` read them, ``wv`` the whole
    ``xi``, and q, k, v are gathered whole; the gate products over the
    channels (``wi``/``wf`` cut on their input dim) are f32 partial sums
    all-reduced over 'model', as the reference's compiled graph sums
    them.  ``n`` is gathered whole for the call and cut again at its end,
    so each step updates this rank's rows ``i`` of ``C`` and takes ``C
    q`` and ``n . q`` whole on the rank (the reference's graph moves ``n``
    and ``q`` by all-to-all and sums ``n . q`` whole too); the output rows
    are gathered into the row-parallel ``down``.  Returns ``(y whole,
    state)``."""
    _check_tp_heads(cfg)
    B, S, d = x.shape
    inner, H = 2 * d, cfg.n_heads
    hd = inner // H
    u = nn.gather_cols(*nn.tp_linear_apply(params["up"], x, cfg))
    xi, z = u[..., :inner], u[..., inner:]
    c, new_conv = _conv_step(state["conv"],
                             coll.split(xi, "model").to(torch.float32),
                             params["conv"]["w"], S, cfg.conv_width)
    c = nn.silu(c).to(x.dtype)

    def whole(name, t, split):
        y, ys = nn.tp_linear_apply(params[name], t, cfg, split=split)
        return nn.gather_cols(y, ys).reshape(B, S, H, hd)

    q = whole("wq", c, True)
    k = whole("wk", c, True) / _sqrt_f32(hd)
    v = coll.split(whole("wv", xi, False), "model")
    c32 = c.to(torch.float32)
    it = coll.all_reduce(torch.einsum("bsk,kh->bsh", c32, params["wi"]["w"]),
                         "model")
    ft = coll.all_reduce(torch.einsum("bsk,kh->bsh", c32, params["wf"]["w"]),
                         "model")
    ft = log_sigmoid(ft + params["wf"]["b"])
    t32 = lambda a: a.transpose(0, 1).to(torch.float32)
    xs = (t32(q), t32(k), t32(v), it.transpose(0, 1), ft.transpose(0, 1))
    cell_state = {"C": state["C"], "m": state["m"],
                  "n": coll.all_gather(state["n"], "model")}
    cell_state, hs = chunked_scan(_mlstm_cell, cell_state, xs, S)
    cell_state["n"] = coll.split(cell_state["n"], "model")
    h = coll.all_gather(hs.transpose(0, 1).to(x.dtype), "model")
    y, split = nn.tp_linear_apply(params["down"], h.reshape(B, S, inner)
                                  .float() * nn.silu(z), cfg)
    return nn.gather_cols(y, split), dict(cell_state, conv=new_conv)


def tp_mlstm_train(params, x, cfg):
    """``mlstm_apply`` of the sharded train step (from the zero state,
    with gradients) in the serve path's layout (``tp_mlstm_apply``): ``x
    [B, S, d]`` the whole sequence of this rank's rows (gathered by the
    block, ``models.lm._tp_train_block``).  ``up`` column-parallel, its
    output gathered (backward: reduce-scattered); the conv and silu on
    this rank's inner channels; the row-parallel ``wq``/``wk`` and the
    gates' f32 products over ``wi``/``wf``'s rows are partial sums, taken
    whole on every rank (``collectives.sum_partials_ad``: each rank
    uses them for its rows of ``C`` only); ``wv`` on this rank's rows of
    ``xi``, reduce-scattered onto its value dim ``i``.  The scan keeps this
    rank's rows ``i`` of ``C`` and ``n``, ``m`` whole (the zero state is
    whole: nothing to gather), so ``C q`` and ``n . q`` are whole on the
    rank; its rows of ``h`` are gathered into the row-parallel ``down``.
    Returns ``down``'s f32 partial sum ``[B, S, d]`` (the block
    reduce-scatters it)."""
    _check_tp_heads(cfg)
    B, S, d = x.shape
    inner, H = 2 * d, cfg.n_heads
    hd = inner // H
    lin = nn.linear_apply
    u = coll.all_gather_ad(lin(params["up"], x, cfg), "model")
    xi, z = u[..., :inner], u[..., inner:]
    xi_own = coll.split(xi, "model")
    zero = mlstm_zero_state(B, H, hd, cfg.conv_width, device=x.device)
    c, _ = _conv_step(coll.split(zero["conv"], "model"),
                      xi_own.to(torch.float32), params["conv"]["w"], S,
                      cfg.conv_width)
    c = nn.silu(c).to(x.dtype)
    whole = lambda t: coll.sum_partials_ad(t, "model")
    q = whole(lin(params["wq"], c, cfg)).to(x.dtype).reshape(B, S, H, hd)
    k = whole(lin(params["wk"], c, cfg)).to(x.dtype).reshape(
        B, S, H, hd) / _sqrt_f32(hd)
    v = coll.reduce_scatter_ad(lin(params["wv"], xi_own, cfg).reshape(
        B, S, H, hd), "model", dim=-1).to(x.dtype)
    c32 = c.to(torch.float32)
    it = whole(torch.einsum("bsk,kh->bsh", c32, params["wi"]["w"]))
    ft = whole(torch.einsum("bsk,kh->bsh", c32, params["wf"]["w"]))
    ft = log_sigmoid(ft + params["wf"]["b"])
    t32 = lambda a: a.transpose(0, 1).to(torch.float32)
    xs = (t32(q), t32(k), t32(v), it.transpose(0, 1), ft.transpose(0, 1))
    cell_state = {"C": coll.split(zero["C"], "model", dim=2), "n": zero["n"],
                  "m": zero["m"]}
    _, hs = chunked_scan(_mlstm_cell, cell_state, xs, S)
    h = coll.all_gather_ad(hs.transpose(0, 1).to(x.dtype), "model")
    hz = h.reshape(B, S, inner).float() * nn.silu(z)
    return lin(params["down"], coll.split(hz, "model"), cfg)


def _sqrt_f32(n: int) -> float:
    """``jnp.sqrt(n)`` of an int: the f32 square root."""
    return float(torch.tensor(float(n), dtype=torch.float32).sqrt())


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(gen, cfg, device="cuda", linear_init=nn.init_serve_linear):
    """The reference's sLSTM leaves: ``linear_init``'s linears ``wx`` d ->
    4d (the z, i, f, o pre-activations), ``down`` and ``up_gate`` d -> d;
    f32 block-diagonal recurrences ``r.w [4, H, hd, hd]`` and ``bias.b
    [4d]`` (0 for z, i, f; 3.0 for o)."""
    d, H = cfg.d_model, cfg.n_heads
    hd = d // H
    lin = linear_init
    bias = torch.zeros(4 * d, dtype=torch.float32, device=device)
    bias[3 * d:] = 3.0
    return {
        "wx": lin(gen, d, 4 * d, cfg, device=device),
        # H is small (4): the recurrences shard over hd instead
        "r": {"w": with_spec(_winit(gen, (4, H, hd, hd), 0.05, device),
                             P(None, None, "model", None))},
        "bias": {"b": with_spec(bias, P(None))},
        "down": lin(gen, d, d, cfg, device=device),
        "up_gate": lin(gen, d, d, cfg, device=device),
    }


def slstm_zero_state(B, d, device="cuda", dtype=torch.float32, lead=()):
    """``c``, ``h``, ``m`` zeros and ``n`` ones, each ``[B, d]``."""
    z = lambda: torch.zeros((*lead, B, d), dtype=dtype, device=device)
    return {"c": z(), "n": torch.ones((*lead, B, d), dtype=dtype,
                                      device=device),
            "h": z(), "m": z()}


def _slstm_cell(params, state, x4, H: int):
    """x4 ``[B, 4d]`` pre-activations from the input; state mixing by the
    recurrent matrices ``r``."""
    B, d4 = x4.shape
    d = d4 // 4
    hprev = state["h"].reshape(B, H, d // H)
    rec = torch.einsum("bhi,ghij->gbhj", hprev, params["r"]["w"]).reshape(
        4, B, d)
    pre = (x4.reshape(B, 4, d).transpose(0, 1) + rec
           + params["bias"]["b"].reshape(4, d)[:, None, :])
    return _slstm_gates(state, pre)


def _slstm_gates(state, pre):
    """The sLSTM state update from the pre-activations ``pre [4, B, d]``
    (z, i, f, o)."""
    z, i, f, o = pre.unbind(0)
    z = torch.tanh(z)
    o = torch.sigmoid(o)
    logf = log_sigmoid(f)
    m_new = torch.maximum(logf + state["m"], i)
    ip = torch.exp(i - m_new)
    fp = torch.exp(logf + state["m"] - m_new)
    c = fp * state["c"] + ip * z
    n = fp * state["n"] + ip
    # jnp.maximum: a tie (n == 1, e.g. after fp underflows) splits the
    # gradient in half, where torch.clamp would pass all of it
    h = o * c / torch.maximum(n, n.new_ones(()))
    return {"c": c, "n": n, "h": h, "m": m_new}, h


def _own_heads(d: int, H: int):
    """This rank's block of the sLSTM's ``d`` (head-major, cut over
    'model') as ``(heads, cols)`` slices of ``[H, hd]``: whole heads, or
    the columns of one head."""
    hd, n = d // H, coll.size("model")
    db = d // n
    lo = coll.index("model") * db
    if db % hd == 0:
        return slice(lo // hd, (lo + db) // hd), slice(None)
    if hd % db:
        raise NotImplementedError(
            f"the sLSTM under a mesh: a rank's {db} of d {d} neither holds "
            f"whole heads of {hd} nor part of one")
    return slice(lo // hd, lo // hd + 1), slice(lo % hd, lo % hd + db)


def tp_slstm_apply(params, x, cfg, state):
    """``slstm_apply`` of a serve forward under the mesh, the state ``c``,
    ``n``, ``h``, ``m [B, d]`` cut on ``d`` (head-major), as the
    reference's ``cache_axes`` cuts it: ``wx`` is column-parallel, its
    output gathered and each gate's block of ``d`` kept.  The recurrences
    ``r [4, H, hd, hd]`` are cut on their input dim ``i``; they are
    gathered once a call and this rank keeps their output columns of its
    block of ``d`` (``_own_heads``), every ``i``.  Each step gathers ``h``
    whole and takes the rank's recurrent products whole over ``i``, as the
    reference's compiled graph does after it reshards ``r`` by all-to-all
    (its sLSTM state is its one-device state bit for bit); ``up_gate`` and
    ``down`` are column-parallel.  Returns ``(y whole, state)``."""
    B, S, d = x.shape
    H = cfg.n_heads
    x4 = nn.gather_cols(*nn.tp_linear_apply(params["wx"], x, cfg))
    x4 = coll.split(x4.to(torch.float32).reshape(B, S, 4, d), "model")
    bias = coll.split(params["bias"]["b"].reshape(4, d), "model")
    heads, cols = _own_heads(d, H)
    rw = coll.all_gather(params["r"]["w"], "model", dim=2, param=True)
    rw = rw[:, heads, :, cols].contiguous()

    def cell(st, xt):
        hprev = coll.all_gather(st["h"], "model").reshape(B, H, d // H)
        rec = torch.einsum("bhi,ghij->gbhj", hprev[:, heads], rw)
        pre = xt.transpose(0, 1) + rec.reshape(4, B, -1) + bias[:, None, :]
        return _slstm_gates(st, pre)

    state, hs = chunked_scan(cell, state, x4.transpose(0, 1), S)
    h = hs.transpose(0, 1).to(x.dtype)
    g = nn.silu(nn.own_cols(*nn.tp_linear_apply(params["up_gate"], x, cfg)))
    y, split = nn.tp_linear_apply(params["down"], h.float() * g, cfg,
                                  split=True)
    return nn.gather_cols(y, split), state


def tp_slstm_train(params, x, cfg):
    """``slstm_apply`` of the sharded train step (from the zero state,
    with gradients) in the serve path's layout (``tp_slstm_apply``): ``x
    [B, S, d]`` the whole sequence of this rank's rows (gathered by the
    block, ``models.lm._tp_train_block``), the state on this rank's block
    of ``d``.  ``wx`` column-parallel, gathered and each gate's block kept;
    ``r`` gathered once a call (a parameter gather: its backward
    reduce-scatters the gradient) and its output columns of the block
    kept; each step gathers ``h`` whole (``all_gather_ad``).  ``up_gate``
    and ``down`` are column-parallel: the gated product's blocks are
    gathered into ``down``, and its columns gathered again.  Returns the
    whole ``down`` output ``[B, S, d]`` bf16 (the block keeps its sequence
    block)."""
    B, S, d = x.shape
    H = cfg.n_heads
    lin = nn.linear_apply
    x4 = coll.all_gather_ad(lin(params["wx"], x, cfg), "model")
    x4 = coll.split(x4.to(torch.float32).reshape(B, S, 4, d), "model")
    bias = coll.split(params["bias"]["b"].reshape(4, d), "model")
    heads, cols = _own_heads(d, H)
    rw = coll.all_gather_ad(params["r"]["w"], "model", dim=2, param=True)
    rw = rw[:, heads, :, cols]

    def cell(st, xt):
        hprev = coll.all_gather_ad(st["h"], "model").reshape(B, H, d // H)
        rec = torch.einsum("bhi,ghij->gbhj", hprev[:, heads], rw)
        pre = xt.transpose(0, 1) + rec.reshape(4, B, -1) + bias[:, None, :]
        return _slstm_gates(st, pre)

    state = slstm_zero_state(B, d // coll.size("model"), device=x.device)
    _, hs = chunked_scan(cell, state, x4.transpose(0, 1), S)
    h = hs.transpose(0, 1).to(x.dtype)
    g = nn.silu(lin(params["up_gate"], x, cfg))
    y = lin(params["down"], coll.all_gather_ad(h.float() * g, "model"), cfg)
    return coll.all_gather_ad(y, "model")


def slstm_apply(params, x, cfg, state=None, apply_fn=nn.serve_linear_apply):
    """x ``[B, S, d]`` -> ``(y, final_state)``; S == 1 is a decode step."""
    B, S, d = x.shape
    H = cfg.n_heads
    x4 = apply_fn(params["wx"], x, cfg).to(torch.float32)
    if state is None:
        state = slstm_zero_state(B, d, device=x.device)
    state, hs = chunked_scan(lambda st, xt: _slstm_cell(params, st, xt, H),
                             state, x4.transpose(0, 1), S)
    h = hs.transpose(0, 1).to(x.dtype)
    g = nn.silu(apply_fn(params["up_gate"], x, cfg))
    return apply_fn(params["down"], h.float() * g, cfg), state  # f32, fused
