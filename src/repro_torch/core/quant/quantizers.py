"""Quantisers used by TLMAC (port of ``repro.core.quant.quantizers``).

- ``uniform_quantize``/``uniform_dequantize``: symmetric uniform affine.
- ``lsq_*``: Learned Step-size Quantisation, learnable step with the
  canonical gradient scale ``1/sqrt(numel*qmax)``.
- ``n2uq_*``: Nonuniform-to-Uniform Quantisation, learnable input
  thresholds, uniform output levels, G-STE backward.
- ``binary_quant``: BNN sign/scale baseline.
- ``quantize_weights_int`` / ``quantize_acts_int``: PTQ entry points that
  produce the integer codes the TLMAC compiler consumes.

Every function computes in the same float32 operations, in the same
order, as the reference, so codes agree bit for bit on the same inputs.
Gradients are the reference's: straight-through estimators are written
``x + (f(x) - x).detach()`` (JAX's ``stop_gradient`` form), the N2UQ
count is a ``torch.autograd.Function`` whose backward is the reference's
custom VJP, and clipping splits the gradient in half at a bound, as
``jnp.clip`` does (``torch.clamp`` passes all of it).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static quantisation configuration for one layer family."""

    w_bits: int = 3
    a_bits: int = 3
    # Weight codes are signed two's complement: [-2^(B-1), 2^(B-1)-1].
    # Activation codes are unsigned levels [0, 2^B - 1].
    per_channel: bool = True
    # 'n2uq' | 'lsq' | 'uniform' | 'binary'
    method: str = "n2uq"

    @property
    def w_qmax(self) -> int:
        return 2 ** (self.w_bits - 1) - 1

    @property
    def w_qmin(self) -> int:
        return -(2 ** (self.w_bits - 1))

    @property
    def a_qmax(self) -> int:
        return 2**self.a_bits - 1


def _f32(x, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    device = like.device if like is not None else None
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``: ``minimum(maximum(x, lo), hi)``, whose
    gradient is halved where ``x`` equals a bound (JAX's and torch's
    elementwise max and min split ties; ``torch.clamp`` does not)."""
    lo = torch.full((), lo, dtype=x.dtype, device=x.device)
    hi = torch.full((), hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


# ---------------------------------------------------------------------------
# Uniform symmetric quantisation + STE
# ---------------------------------------------------------------------------


def _round_ste(x: torch.Tensor) -> torch.Tensor:
    """Round with straight-through gradient."""
    return x + (torch.round(x) - x).detach()


def uniform_quantize(x: torch.Tensor, scale, qmin: int,
                     qmax: int) -> torch.Tensor:
    """Real -> integer codes (differentiable via STE)."""
    return _clip(_round_ste(x / scale), qmin, qmax)


def uniform_dequantize(q: torch.Tensor, scale) -> torch.Tensor:
    return q * scale


def fake_quant_weight(w: torch.Tensor, scale, cfg: QuantConfig):
    """Quantise-dequantise weights (QAT forward)."""
    return uniform_dequantize(
        uniform_quantize(w, scale, cfg.w_qmin, cfg.w_qmax), scale)


def fake_quant_act(a: torch.Tensor, scale, cfg: QuantConfig):
    return uniform_dequantize(uniform_quantize(a, scale, 0, cfg.a_qmax),
                              scale)


# ---------------------------------------------------------------------------
# LSQ / LSQ+  (learned step size)
# ---------------------------------------------------------------------------


def lsq_init(w: torch.Tensor, bits: int, per_channel: bool,
             signed: bool = True) -> torch.Tensor:
    """Canonical LSQ init: s = 2*mean(|w|)/sqrt(qmax)."""
    qmax = 2 ** (bits - 1) - 1 if signed else 2**bits - 1
    w = _f32(w)
    root = torch.sqrt(_f32(float(qmax), w))
    if per_channel and w.dim() >= 2:
        s = 2.0 * w.abs().mean(dim=tuple(range(w.dim() - 1))) / root
    else:
        s = 2.0 * w.abs().mean() / root
    return torch.clamp(s, min=1e-9)


def _grad_scale(x: torch.Tensor, scale) -> torch.Tensor:
    """Scale the gradient flowing into x without changing the value."""
    return x * scale + (x * (1.0 - scale)).detach()


def lsq_quant(x: torch.Tensor, step: torch.Tensor, bits: int,
              signed: bool = True, dequant: bool = True,
              numel: Optional[int] = None) -> torch.Tensor:
    """LSQ fake-quant (or codes if ``dequant=False``).  The step's
    gradient is scaled by ``1/sqrt(numel*qmax)``: ``numel`` is the element
    count of the whole weight, ``x``'s own by default.  A sharded train
    linear passes its block with the whole weight's count (the
    reference's ``x.size`` is the global size under GSPMD)."""
    if signed:
        qmin, qmax = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    else:
        qmin, qmax = 0, 2**bits - 1
    x = _f32(x)
    step = _f32(step, x)
    n = x.numel() if numel is None else numel
    g = (_f32(1.0) / torch.sqrt(_f32(float(n) * max(qmax, 1)))).to(
        x.device)
    s = _grad_scale(step, g)
    q = _clip(_round_ste(x / s), qmin, qmax)
    return q * s if dequant else q


# ---------------------------------------------------------------------------
# N2UQ: Nonuniform-to-Uniform quantisation
# ---------------------------------------------------------------------------


def n2uq_act_init(bits: int, init_range: float = 1.0, device="cuda") -> dict:
    """Parameters: threshold *deltas* (softplus-positive) + output step."""
    n_thresh = 2**bits - 1
    deltas = torch.full((n_thresh,), init_range / n_thresh,
                        dtype=torch.float32, device=device)
    out_step = torch.tensor(init_range / n_thresh, dtype=torch.float32,
                            device=device)
    return {"deltas": deltas, "out_step": out_step}


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus is logaddexp(x, 0) everywhere; torch's softplus
    # switches to the identity above x*beta > 20, so it is written out
    return torch.logaddexp(x, torch.zeros_like(x))


def _thresholds_from_deltas(deltas: torch.Tensor) -> torch.Tensor:
    """Strictly increasing thresholds via positive increments."""
    pos = _softplus(deltas) + 1e-6
    return torch.cumsum(pos, dim=0) - 0.5 * pos[0]


def _count(x, thresholds):
    """``#(x > T_i)`` in ``x``'s dtype (a sum of 0/1, exact in any order)."""
    return (x[..., None] > thresholds).sum(dim=-1, dtype=x.dtype)


class _N2UQCount(torch.autograd.Function):
    """``q = out_step * #(x > T_i)`` (uniform output levels), with the
    reference's G-STE backward (``_n2uq_count_bwd``):

    - ``dx``: the gradient inside ``(T_0, T_last)`` times the average
      slope ``out_step / avg_delta``, zero outside;
    - ``dthr``: moving ``T_i`` down raises ``q`` by ``out_step`` for ``x``
      in a band around ``T_i`` (a triangular surrogate of width
      ``avg_delta``), one threshold at a time, so no ``[..., n_thresh]``
      float tensor is made;
    - ``dstep``: ``sum(ct * count)``."""

    @staticmethod
    def forward(ctx, x, thresholds, out_step, bits):
        ctx.save_for_backward(x, thresholds, out_step)
        ctx.bits = bits
        return _count(x, thresholds) * out_step

    @staticmethod
    def backward(ctx, ct):
        x, thresholds, out_step = ctx.saved_tensors
        n_levels = 2**ctx.bits - 1
        lo, hi = thresholds[0], thresholds[-1]
        avg_delta = (hi - lo) / max(n_levels - 1, 1)
        band = torch.clamp(avg_delta, min=1e-6)
        slope = out_step / band
        inside = ((x > lo) & (x < hi)).to(x.dtype)
        dx = ct * inside * slope
        contrib = -ct * out_step / band
        dthr = torch.stack([
            torch.sum(contrib * torch.clamp(
                1.0 - torch.abs(x - thresholds[i]) / band, 0.0, 1.0))
            for i in range(n_levels)])
        dstep = torch.sum(ct * _count(x, thresholds))
        return dx, dthr, dstep.reshape(out_step.shape), None


def _n2uq_count(x, thresholds, out_step, bits):
    return _N2UQCount.apply(x, thresholds, out_step, bits)


def n2uq_act_quant(x: torch.Tensor, params: dict, bits: int,
                   dequant: bool = True) -> torch.Tensor:
    """N2UQ activation quantiser. Returns dequantised values or int codes."""
    thresholds = _thresholds_from_deltas(params["deltas"])
    y = _n2uq_count(x, thresholds, params["out_step"], bits)
    if dequant:
        return y
    return torch.round(y / params["out_step"]).to(torch.int32)


def n2uq_weight_init(w: torch.Tensor, bits: int,
                     per_channel: bool = True) -> dict:
    return {"step": lsq_init(w, bits, per_channel, signed=True)}


def n2uq_weight_quant(w: torch.Tensor, params: dict, bits: int,
                      dequant: bool = True) -> torch.Tensor:
    """N2UQ weight path = LSQ-style symmetric uniform on weights."""
    return lsq_quant(w, params["step"], bits, signed=True, dequant=dequant)


# ---------------------------------------------------------------------------
# Binary (BNN) baseline
# ---------------------------------------------------------------------------


def binary_quant(w: torch.Tensor, dequant: bool = True) -> torch.Tensor:
    """sign(w) with per-channel |w| mean scale (XNOR-Net style), the sign
    straight-through."""
    red = tuple(range(w.dim() - 1)) if w.dim() >= 2 else ()
    alpha = w.abs().mean(dim=red) if red else w.abs().mean()
    sign = torch.where(w >= 0, 1.0, -1.0).to(w.dtype)
    sign = w + (sign - w).detach()
    return sign * alpha if dequant else sign


# ---------------------------------------------------------------------------
# PTQ entry points producing integer codes (what the TLMAC compiler eats)
# ---------------------------------------------------------------------------


def quantize_weights_int(w: torch.Tensor, cfg: QuantConfig,
                         step: Optional[torch.Tensor] = None):
    """Real weights -> (int32 codes in [w_qmin, w_qmax], scale)."""
    w = _f32(w)
    if step is None:
        step = lsq_init(w, cfg.w_bits, cfg.per_channel, signed=True)
    step = _f32(step, w)
    q = torch.clamp(torch.round(w / step), cfg.w_qmin, cfg.w_qmax)
    return q.to(torch.int32), step


def _quantile_linear(a: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(a, q)`` (method 'linear') over all elements, with
    the reference's float32 index arithmetic.  ``torch.quantile`` refuses
    inputs above 2^24 elements, so the two order statistics come from
    ``kthvalue``."""
    flat = a.reshape(-1)
    n = flat.numel()
    pos = _f32(q) * _f32(float(n - 1))
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1.0 - hw
    lo_i = int(min(max(low.item(), 0.0), n - 1))
    hi_i = int(min(max(high.item(), 0.0), n - 1))
    lo_v = torch.kthvalue(flat, lo_i + 1).values
    hi_v = lo_v if hi_i == lo_i else torch.kthvalue(flat, hi_i + 1).values
    return lo_v * lw.to(flat.device) + hi_v * hw.to(flat.device)


def quantize_acts_int(a: torch.Tensor, cfg: QuantConfig,
                      step: Optional[torch.Tensor] = None):
    """Real activations -> (unsigned int32 codes, scale)."""
    a = _f32(a)
    if step is None:
        hi = _quantile_linear(a.abs(), 0.999)
        step = torch.clamp(hi / cfg.a_qmax, min=1e-9)
    step = _f32(step, a)
    q = torch.clamp(torch.round(a / step), 0, cfg.a_qmax)
    return q.to(torch.int32), step
