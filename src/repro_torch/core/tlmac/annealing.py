"""Simulated annealing for routing reduction — paper Algorithm 1, verbatim.

Copy of ``repro.core.tlmac.annealing`` for the port (that package's
``__init__`` imports JAX); the two must stay identical in behaviour:
``tests/test_torch_tlmac.py`` holds the compiled plans equal.

Temperature schedule  T = I / (i+1)^alpha  with alpha = 1.4 (paper §5.2).
A candidate swaps two weight groups of the *same cluster* between two LUT
arrays; acceptance follows the paper's criterion exactly:

    accept  iff  R_new < R_best  or  rand(0,1) < exp((R_best - R_new - 1)/T)

The energy is the total route count R (Equation 6), evaluated
incrementally: a swap touches only arrays e0 and e1, so only their two
cnt rows change.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.core.tlmac.placement import Placement, apply_swap, swap_delta


@dataclasses.dataclass
class AnnealResult:
    placement: Placement
    history: np.ndarray      # route count after each recorded iteration
    r_init: int
    r_final: int             # R_current — what Algorithm 1 returns
    iterations: int
    r_best: int = 0          # best seen (can beat r_final at tiny budgets)

    @property
    def reduction(self) -> float:
        """Fraction of routes remaining (Fig. 6 plots this per layer)."""
        return self.r_final / max(self.r_init, 1)


def anneal_routing(
    p: Placement,
    iterations: int = 100_000,
    alpha: float = 1.4,
    seed: int = 0,
    record_every: int = 0,
) -> AnnealResult:
    """Algorithm 1. Mutates ``p`` in place and returns it with stats."""
    rng = np.random.default_rng(seed)
    r_init = p.routes()
    r_current = r_init
    r_best = r_init

    if record_every <= 0:
        record_every = max(iterations // 256, 1)
    history: List[int] = [r_init]

    # Pre-draw randomness in blocks: a per-iteration default_rng call is
    # the bottleneck at I > 1e5 on one core.
    BLK = 8192
    n_empty = 0
    i = 0
    while i < iterations:
        n = min(BLK, iterations - i)
        cs = rng.integers(0, p.N_clus, size=n)
        e0s = rng.integers(0, p.N_arr, size=n)
        e1s = rng.integers(0, p.N_arr, size=n)
        us = rng.random(size=n)
        for j in range(n):
            i += 1
            c, e0, e1 = int(cs[j]), int(e0s[j]), int(e1s[j])
            if e0 == e1:
                continue
            g0, g1 = p.place[e0, c], p.place[e1, c]
            if g0 < 0 and g1 < 0:
                n_empty += 1
                continue
            T = iterations / float((i + 1) ** alpha)
            new_rows = swap_delta(p, c, e0, e1)
            # routes delta: count sign changes of the two touched rows
            before = (p.cnt[e0] > 0).sum() + (p.cnt[e1] > 0).sum()
            after = (new_rows[0] > 0).sum() + (new_rows[1] > 0).sum()
            r_new = r_current + int(after - before)
            accept = r_new < r_best or us[j] < np.exp(
                min((r_best - r_new - 1) / max(T, 1e-12), 0.0)
            )
            if accept:
                apply_swap(p, c, e0, e1, new_rows)
                r_current = r_new
                if r_new < r_best:
                    r_best = r_new
            if i % record_every == 0:
                history.append(r_current)

    return AnnealResult(
        placement=p,
        history=np.asarray(history, dtype=np.int64),
        r_init=r_init,
        r_final=r_current,
        iterations=iterations,
        r_best=r_best,
    )


def iterations_for_layer(n_connections: int, scale: float = 25.0) -> int:
    """Paper §6.2.2: iteration budget proportional to the initial number
    of connections after random assignment."""
    return int(max(2_000, min(200_000, scale * n_connections)))
