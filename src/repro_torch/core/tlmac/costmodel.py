"""FPGA resource & power cost model (paper §3.1, §6.2).

Copy of ``repro.core.tlmac.costmodel`` for the port (that package's
``__init__`` imports JAX); the two must stay identical in behaviour:
``tests/test_torch_tlmac.py`` holds the compiled plans equal.

The FPGA-specific outputs of the paper (LUT counts, BRAM, dynamic/static
power) are reproduced analytically so that Table 1 / Figures 5, 6, 8 can
be regenerated without Vivado.  Constants are calibrated against the
paper's own reported numbers (see ``benchmarks/table1_block_area.py``).

Target device: AMD Xilinx Virtex UltraScale+ XCVU13P @ 200 MHz.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.tlmac.lut import n_clus_slots, n_lut_bits


@dataclasses.dataclass(frozen=True)
class Device:
    name: str
    luts: int
    ffs: int
    bram36: int
    dsp: int


# XCVU13P (4 SLRs)
XCVU13P = Device(name="xcvu13p", luts=1_728_000, ffs=3_456_000, bram36=2_688, dsp=12_288)

# Table 1 baselines (post-synthesis LUTs, ImageNet ResNet-18 block 6)
LUTNET_BLOCK6_LUTS = 1_840_666
LUTNET_BLOCK6_ACC = 54.87
LOGICSHRINKAGE_BLOCK6_LUTS = 690_357
LOGICSHRINKAGE_BLOCK6_POSTIMPL_LUTS = 665_720
LOGICSHRINKAGE_BLOCK6_ACC = 53.40
N2UQ_ACC = {2: 69.42, 3: 71.94, 4: 72.88}  # [20], quoted in Table 1
TLMAC_TABLE1 = {  # paper-reported TLMAC numbers for validation
    2: dict(luts_syn=54_973, luts_impl=54_716, bram=79.5, dyn_w=0.6),
    3: dict(luts_syn=112_000, luts_impl=110_391, bram=97.0, dyn_w=1.0),
    4: dict(luts_syn=187_908, luts_impl=186_435, bram=103.5, dyn_w=3.1),
}

# Dynamic power per LUT @200MHz, least-squares fit through the paper's
# (LUT, W) points above: k = sum(x*y)/sum(x^2).
_xy = sum(v["luts_impl"] * v["dyn_w"] for v in TLMAC_TABLE1.values())
_xx = sum(v["luts_impl"] ** 2 for v in TLMAC_TABLE1.values())
DYN_W_PER_LUT = _xy / _xx
STATIC_W = 3.0


@dataclasses.dataclass
class FPGAResources:
    luts_pool: int          # LUT arrays (N_arr * N_lut)
    luts_switch: int        # output multiplexers
    luts_accum: int         # accumulators + shifters
    bram36: float
    ffs: int
    dsp: int = 0

    @property
    def luts(self) -> int:
        return self.luts_pool + self.luts_switch + self.luts_accum

    def power_w(self) -> tuple:
        return (DYN_W_PER_LUT * self.luts, STATIC_W)

    def __add__(self, other: "FPGAResources") -> "FPGAResources":
        return FPGAResources(
            luts_pool=self.luts_pool + other.luts_pool,
            luts_switch=self.luts_switch + other.luts_switch,
            luts_accum=self.luts_accum + other.luts_accum,
            bram36=self.bram36 + other.bram36,
            ffs=self.ffs + other.ffs,
            dsp=self.dsp + other.dsp,
        )


def bit_parallel_lut_count(G: int, B_a: int, B_p: int) -> int:
    """Equation 2: N_lut = 2^(G*B_a - 6) * B_p  (the infeasible baseline)."""
    return int(2 ** max(G * B_a - 6, 0) * B_p)


def mux_luts(fan_in: int, width: int) -> int:
    """F:1 mux of `width` bits: one LUT-6 implements a 4:1 mux bit, so a
    tree needs ceil((F-1)/3) LUTs per bit."""
    if fan_in <= 1:
        return 0
    return int(math.ceil((fan_in - 1) / 3)) * width


def hybrid_layer_cost(
    n_arr: int,
    G: int,
    B_w: int,
    B_a: int,
    B_p: int,
    D_p: int,
    D_s: int,
    cnt: np.ndarray = None,   # [N_arr, D_p] route counts (post-annealing)
) -> FPGAResources:
    """Resource model of one TLMAC PE (paper Fig. 3).

    - pool:       N_arr LUT arrays x N_lut LUT-6s
    - switches:   one mux per output p over its routed arrays (fan-in from
                  the routing matrix; full N_arr if not provided)
    - accum:      D_p adders of B_p bits (carry chains, ~1 LUT/bit) + the
                  barrel shifter for the bit-serial 2^b scaling
    - BRAM:       select-mapping memory (D_s x select bits) + mux mapping
                  (D_s x sum of mux select widths) + partial-sum buffer
    """
    B_l = n_lut_bits(B_w, G)
    n_clus = n_clus_slots(G)
    pool = n_arr * B_l

    if cnt is not None:
        fan = (cnt > 0).sum(axis=0)  # fan-in per output p
    else:
        fan = np.full((D_p,), n_arr)
    switch = int(sum(mux_luts(int(f), B_l) for f in fan))

    shifter = int(math.ceil(math.log2(max(B_a, 2))) / 2 * B_l) * D_p
    accum = D_p * B_p + shifter

    sel_bits = math.ceil(math.log2(max(n_clus, 2)))
    mux_sel_bits = int(np.ceil(np.log2(np.maximum(fan, 2))).sum())
    map_bits = D_s * (sel_bits + mux_sel_bits)
    psum_bits = D_p * B_p * 2  # double-buffered partial sums
    bram = (map_bits + psum_bits) / 36864.0  # BRAM36 = 36 Kb

    ffs = D_p * B_p + n_arr  # accumulator regs + pipeline
    return FPGAResources(
        luts_pool=int(pool), luts_switch=switch, luts_accum=int(accum),
        bram36=float(bram), ffs=int(ffs),
    )


def power_estimate(resources: FPGAResources) -> dict:
    dyn, stat = resources.power_w()
    return {"dynamic_w": dyn, "static_w": stat, "total_w": dyn + stat}


def logic_density(n_uwg_total: int, n_arr_total: int) -> float:
    """Paper §6.2.1: unique weight groups stored per LUT array."""
    return n_uwg_total / max(n_arr_total, 1)
