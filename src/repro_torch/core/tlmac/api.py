"""Composable public API: real weights in, lookup-executing module out
(port of ``repro.core.tlmac.api``).

``TLMACLinear.from_weights`` runs the full paper pipeline (quantise ->
group -> cluster -> anneal -> pack) and yields a callable whose forward is
the lookup GEMM, a drop-in for ``x @ W`` at serve time:

    lin = TLMACLinear.from_weights(w, w_bits=3, a_bits=3, G=4)
    y = lin(x)                       # bf16, == fake-quant matmul
    lin.plan.resources.luts          # the FPGA cost report
    lin.as_serve_params()            # params for models/nn.serve_linear_apply

The forward runs ``ops.tlmac_matmul(impl='pallas')``: the bit-plane
kernel and the lookup GEMM on packed codes on the card (the reference
runs its ``'xla-kscan'`` graph; every impl returns the same int32).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.quant import quantizers as Q
from repro_torch.core.tlmac.compile import TLMACLayerPlan, compile_layer
from repro_torch.kernels import ops as kops
from repro_torch.kernels.tlmac_fused import narrow_table


@dataclasses.dataclass
class TLMACLinear:
    plan: TLMACLayerPlan
    w_step: torch.Tensor         # per-tensor or per-channel dequant scale
    a_step: torch.Tensor
    a_bits: int
    N: int
    bias: Optional[torch.Tensor] = None

    @classmethod
    def from_weights(cls, w, w_bits=3, a_bits=3, G=4, d_p=64, a_step=None,
                     anneal_iters=2000, seed=0, bias=None, device="cuda"):
        """Quantise a real [K, N] weight matrix and compile it.  The
        scales (and bias) live on ``device``; the plan stays numpy and its
        arrays are copied to a device at the first call there."""
        w = torch.as_tensor(w, dtype=torch.float32, device=device)
        cfg = Q.QuantConfig(w_bits=w_bits, a_bits=a_bits, per_channel=False)
        codes, w_step = Q.quantize_weights_int(w, cfg)
        plan = compile_layer(
            codes.cpu().numpy(), B_w=w_bits, B_a=a_bits, G=G, d_p=d_p,
            anneal_iters=anneal_iters, seed=seed,
        )
        a_step = 1.0 if a_step is None else a_step
        return cls(plan=plan, w_step=w_step,
                   a_step=torch.as_tensor(a_step, dtype=torch.float32,
                                          device=device),
                   a_bits=a_bits, N=w.shape[1],
                   bias=None if bias is None
                   else torch.as_tensor(bias, device=device))

    def calibrate(self, x_sample):
        """PTQ activation calibration from a sample batch."""
        cfg = Q.QuantConfig(a_bits=self.a_bits)
        _, step = Q.quantize_acts_int(torch.as_tensor(x_sample), cfg)
        self.a_step = step.to(self.a_step.device)
        return self

    def _plan_arrays(self, device):
        """(table, exec_idx, step_cluster) on ``device``, made once: the
        table as the narrow rows the lookup kernel reads."""
        key = ("linear", str(torch.device(device)))
        hit = self.plan.device_cache.get(key)
        if hit is None:
            hit = (narrow_table(torch.as_tensor(self.plan.table)).to(device),
                   *(torch.as_tensor(a, device=device) for a in (
                       self.plan.exec_idx, self.plan.step_cluster)))
            self.plan.device_cache[key] = hit
        return hit

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., K] -> bf16 [..., N] via the lookup GEMM."""
        lead = x.shape[:-1]
        aq = torch.clamp(torch.round(x.to(torch.float32) / self.a_step),
                         0, 2**self.a_bits - 1).to(torch.int8)
        table, exec_idx, step_cluster = self._plan_arrays(x.device)
        yi = kops.tlmac_matmul(
            aq.reshape(-1, x.shape[-1]), table, exec_idx, step_cluster,
            B_a=self.a_bits, G=self.plan.G, N=self.N, impl="pallas",
        )
        y = (yi * (self.a_step * self.w_step)).to(torch.bfloat16)
        y = y.reshape(*lead, self.N)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y

    def as_serve_params(self) -> dict:
        """Params dict consumable by ``models/nn.serve_linear_apply``
        (stored dtypes: uint8 indices when N_arr <= 256, else int16; the
        table also as the narrow rows the lookup kernel reads)."""
        D_s, D_p = self.plan.exec_idx.shape
        n_tiles = self.N // D_p
        kg = D_s // n_tiles
        dev = self.a_step.device
        w_step = torch.as_tensor(self.w_step, dtype=torch.float32,
                                 device=dev).reshape(-1)
        if w_step.numel() == 1:
            w_step = w_step.expand(self.N).contiguous()
        idx_dtype = torch.uint8 if self.plan.N_arr <= 256 else torch.int16
        table = torch.as_tensor(self.plan.table, device=dev)
        return {
            "table": table,
            "table_narrow": narrow_table(table),
            "exec_idx": torch.as_tensor(
                self.plan.exec_idx.reshape(n_tiles, kg, D_p),
                device=dev).to(idx_dtype),
            "step_cluster": torch.as_tensor(
                self.plan.step_cluster.reshape(n_tiles, kg),
                device=dev).to(torch.int8),
            "w_step": w_step,
            "a_step": self.a_step.to(torch.float32),
        }
