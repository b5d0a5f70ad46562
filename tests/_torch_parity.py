"""Shared check of the port's parity tests (not a test module)."""

import dataclasses

import numpy as np


def plans_equal(p, q):
    """Two TLMAC plans (port and reference) are identical: every shape
    field, every plan array (dtype and values), the cost report and the
    annealing trace."""
    for f in ("layout", "orig_shape", "G", "B_w", "D_s", "D_p", "N_uwg",
              "N_clus", "N_arr", "routes_before", "routes_after"):
        assert getattr(p, f) == getattr(q, f), f
    for f in ("table", "exec_idx", "step_cluster", "codebook", "idx",
              "lut_inits"):
        a, b = getattr(p, f), getattr(q, f)
        if a is None or b is None:
            assert a is None and b is None, f
            continue
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert dataclasses.asdict(p.resources) == dataclasses.asdict(q.resources)
    assert np.array_equal(p.anneal.history, q.anneal.history)
    assert (p.anneal.r_best, p.anneal.r_final) == (q.anneal.r_best,
                                                   q.anneal.r_final)
