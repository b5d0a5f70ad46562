"""Quantisers, inference subset (port of ``repro.core.quant.quantizers``).

Forward passes only: LSQ fake-quant, the N2UQ activation quantiser and
the PTQ entry points that produce the integer codes the TLMAC compiler
consumes.  The reference's custom VJPs (G-STE, LSQ gradient scale) are
training and are not ported yet.

Every function computes in the same float32 operations, in the same
order, as the reference, so codes agree bit for bit on the same inputs.
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


def lsq_quant(x: torch.Tensor, step: torch.Tensor, bits: int,
              signed: bool = True, dequant: bool = True) -> torch.Tensor:
    """LSQ fake-quant (or codes if ``dequant=False``), forward only."""
    if signed:
        qmin, qmax = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    else:
        qmin, qmax = 0, 2**bits - 1
    x = _f32(x)
    step = _f32(step, x)
    # the reference's gradient-scaled step s*g + stop_gradient(s*(1-g)):
    # its value is formed with the same two roundings here
    g = (_f32(1.0) / torch.sqrt(_f32(float(x.numel()) * max(qmax, 1)))).to(
        x.device)
    s = step * g + step * (1.0 - g)
    q = torch.clamp(torch.round(x / s), qmin, qmax)
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


def _n2uq_count(x, thresholds, out_step):
    """q = out_step * #(x > T_i)  (uniform output levels), forward only."""
    q = (x[..., None] > thresholds).to(x.dtype).sum(dim=-1)
    return q * out_step


def n2uq_act_quant(x: torch.Tensor, params: dict, bits: int,
                   dequant: bool = True) -> torch.Tensor:
    """N2UQ activation quantiser. Returns dequantised values or int codes."""
    thresholds = _thresholds_from_deltas(params["deltas"])
    y = _n2uq_count(x, thresholds, params["out_step"])
    if dequant:
        return y
    return torch.round(y / params["out_step"]).to(torch.int32)


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
