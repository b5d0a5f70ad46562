"""Collective accounting and the roofline's terms: the port's counterpart
of ``repro.launch.hlo_analysis``.

The reference sums the collectives of XLA's optimized HLO text
(``parse_collectives``).  The port has no compiled graph to read, so that
parser has no counterpart here; instead ``record_collectives`` is a
context manager that counts every collective the port's own code issues
(``parallel.overlap``, ``parallel.pipeline``, ``parallel.collectives``):
kind, bytes, count, under the reference's kind names.  Bytes are each
call's tensor bytes on the issuing rank: for a P2P hop the block sent,
for an all-gather the gathered output (as the reference's parser counts
output shapes).  A collective that moves a parameter (the FSDP gather
of a sharded lookup plan or train weight, and its reduce-scatter in the
backward) is counted again under ``param_count`` and ``param_bytes``.
The collectives that a backward issues (``parallel.collectives``'
autograd forms) are counted with the rest and again under
``backward_count_by_kind`` and ``backward_bytes_by_kind``.

``Roofline`` keeps the reference's fields and properties.  Its hardware
model is an argument; the default is the NVIDIA H100 SXM data sheet for
"NVIDIA H100 80GB HBM3, 700 W" (dense rates, not measurements):
    peak bf16   989 TFLOP/s
    HBM         3.35 TB/s
    NVLink      450 GB/s each way (900 GB/s bidirectional)
``V5E`` holds the reference's TPU v5e constants.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict

import torch

_COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int]
    count_by_kind: Dict[str, int]
    param_count: int = 0       # of the above, collectives moving params
    param_bytes: int = 0
    # of the above, those a backward issued
    backward_count_by_kind: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {k: 0 for k in _COLLECTIVES})
    backward_bytes_by_kind: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {k: 0 for k in _COLLECTIVES})

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


# the open recorders: process-wide, not a context variable, so that a
# backward that autograd runs on its device thread is counted too
_RECORDERS = []


@contextlib.contextmanager
def record_collectives():
    """Yields a ``CollectiveStats`` that counts every collective the
    port's code issues inside the block (nested blocks all count), its
    backward's included."""
    stats = CollectiveStats({k: 0 for k in _COLLECTIVES},
                            {k: 0 for k in _COLLECTIVES})
    _RECORDERS.append(stats)
    try:
        yield stats
    finally:
        del _RECORDERS[next(i for i, r in enumerate(_RECORDERS)
                            if r is stats)]


def note_collective(kind: str, tensor: torch.Tensor,
                    param: bool = False, backward: bool = False) -> None:
    """Count one collective of ``kind`` moving ``tensor``'s bytes
    (``param``: the tensor is a parameter's or its gradient's;
    ``backward``: a backward issued it)."""
    if kind not in _COLLECTIVES:
        raise ValueError(f"collective kind {kind!r} not in {_COLLECTIVES}")
    nbytes = tensor.numel() * tensor.element_size()
    for stats in _RECORDERS:
        stats.bytes_by_kind[kind] += nbytes
        stats.count_by_kind[kind] += 1
        if param:
            stats.param_count += 1
            stats.param_bytes += nbytes
        if backward:
            stats.backward_count_by_kind[kind] += 1
            stats.backward_bytes_by_kind[kind] += nbytes


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float      # dense bf16 FLOP/s a chip
    hbm_bw: float          # bytes/s a chip
    link_bw: float         # collective bytes/s a chip


H100 = Hardware("NVIDIA H100 80GB HBM3, 700 W (data sheet)",
                peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9)
# the reference's hardware model (hlo_analysis.py: TPU v5e per chip)
V5E = Hardware("TPU v5e (the reference's constants)",
               peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)


@dataclasses.dataclass
class Roofline:
    flops: float               # total flops (all devices)
    hbm_bytes: float           # total bytes accessed (all devices)
    collective_bytes: float    # total collective bytes (all devices)
    n_chips: int
    model_flops: float = 0.0   # 6*N*D analytic
    hardware: Hardware = H100

    @property
    def t_compute(self) -> float:
        return self.flops / (self.n_chips * self.hardware.peak_flops)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.n_chips * self.hardware.hbm_bw)

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / (self.n_chips * self.hardware.link_bw)

    @property
    def bottleneck(self) -> str:
        t = {"compute": self.t_compute, "memory": self.t_memory,
             "collective": self.t_collective}
        return max(t, key=t.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "n_chips": self.n_chips,
            "hardware": self.hardware.name,
        }
