"""Static TLMAC plan shapes (copy of ``repro.core.tlmac.compile.plan_shapes``
and ``repro.core.tlmac.lut.n_clus_slots``, which serve-path init needs).

The full compiler (grouping, clustering, placement, annealing) is not
ported yet; serve params are drawn at the plan's capacity shapes."""

from __future__ import annotations

from typing import Optional

import numpy as np


def n_clus_slots(G: int) -> int:
    """Equation 5: N_clus = 2^(6-G) selectable weight groups per array."""
    assert 1 <= G <= 6
    return 2 ** (6 - G)


def plan_shapes(
    K: int,
    N: int,
    G: int,
    B_w: int,
    n_arr_cap: Optional[int] = None,
    d_p: int = 64,
):
    """Static shapes of a TLMAC plan (no data needed).

    N_arr is budgeted at its worst case (capacity):
    N_arr <= min(2^(B_w*G), D_p * ceil(D_s / N_clus)) or an explicit cap.
    """
    assert K % G == 0 and N % d_p == 0
    n_clus = n_clus_slots(G)
    D_s = (K // G) * (N // d_p)
    D_p = d_p
    worst = min(2 ** (B_w * G), D_p * -(-D_s // n_clus))
    n_arr = min(worst, n_arr_cap) if n_arr_cap else worst
    return {
        "table": ((n_clus, n_arr, 2**G), np.int32),
        "exec_idx": ((D_s, D_p), np.int32),
        "step_cluster": ((D_s,), np.int32),
        "D_s": D_s,
        "D_p": D_p,
        "N_clus": n_clus,
        "N_arr": n_arr,
    }
