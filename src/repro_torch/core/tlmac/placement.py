"""Cluster -> LUT-array placement and the routing matrix (paper §5.2).

Copy of ``repro.core.tlmac.placement`` for the port (that package's
``__init__`` imports JAX); the two must stay identical in behaviour:
``tests/test_torch_tlmac.py`` holds the compiled plans equal.

After clustering, each cluster c owns the union of unique weight groups
used by its steps; those groups occupy select-index s = c across the LUT
arrays.  *Which* array each group lands in is free — that freedom is what
simulated annealing exploits to minimise pool->switch routes
(Equation 6):

    R = sum_e sum_p  1( exists c : R(e, c, p) != 0 )

Data model
----------
- ``clusters[c]``      : int array of unique-group ids in cluster c
- ``usage[c]``         : bool [len(clusters[c]), D_p]; usage[c][j, p] is
                         True iff output p needs group clusters[c][j]
                         during some step of cluster c
- ``place [N_arr, N_clus]`` : slot j of clusters[c] assigned to array
                         place-inverse; stored as int "which group-index
                         (into clusters[c]) sits at (e, c)", -1 = empty
- ``cnt [N_arr, D_p]`` : number of clusters contributing a route (e, p);
                         routes = count_nonzero(cnt)
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class Placement:
    clusters: List[np.ndarray]          # per-cluster unique-group ids
    usage: List[np.ndarray]             # per-cluster bool [n_c, D_p]
    place: np.ndarray                   # [N_arr, N_clus] int, -1 empty
    cnt: np.ndarray                     # [N_arr, D_p] int32 route counts
    N_arr: int
    N_clus: int
    D_p: int

    def routes(self) -> int:
        return int(np.count_nonzero(self.cnt))


def build_clusters(idx: np.ndarray, labels: np.ndarray, n_clus: int):
    """Per-cluster unique-group lists + output-usage matrices.

    idx    : [D_s, D_p] unique-group id used by (step, output)
    labels : [D_s] cluster id per step
    """
    D_s, D_p = idx.shape
    clusters, usage = [], []
    for c in range(n_clus):
        steps = np.nonzero(labels == c)[0]
        if len(steps) == 0:
            clusters.append(np.zeros((0,), dtype=np.int64))
            usage.append(np.zeros((0, D_p), dtype=bool))
            continue
        sub = idx[steps]                      # [n_steps_c, D_p]
        gids = np.unique(sub)
        clusters.append(gids)
        # usage[j, p] = does output p use gids[j] in cluster c
        u = np.zeros((len(gids), D_p), dtype=bool)
        pos = np.searchsorted(gids, sub)      # [n_steps_c, D_p]
        for j in range(sub.shape[0]):
            u[pos[j], np.arange(D_p)] = True
        usage.append(u)
    return clusters, usage


def n_arrays(clusters: List[np.ndarray]) -> int:
    """N_arr = size of the largest cluster (paper §5.1)."""
    return max((len(c) for c in clusters), default=0) or 1


def random_placement(
    clusters: List[np.ndarray], usage: List[np.ndarray], D_p: int, seed: int = 0
) -> Placement:
    """Algorithm 1 line 1: random initial placement."""
    rng = np.random.default_rng(seed)
    N_clus = len(clusters)
    N_arr = n_arrays(clusters)
    place = np.full((N_arr, N_clus), -1, dtype=np.int64)
    for c, gids in enumerate(clusters):
        slots = rng.permutation(N_arr)[: len(gids)]
        place[slots, c] = np.arange(len(gids))
    cnt = np.zeros((N_arr, D_p), dtype=np.int32)
    for c in range(N_clus):
        occ = place[:, c] >= 0
        if occ.any():
            cnt[occ] += usage[c][place[occ, c]].astype(np.int32)
    return Placement(
        clusters=clusters, usage=usage, place=place, cnt=cnt,
        N_arr=N_arr, N_clus=N_clus, D_p=D_p,
    )


def routing_matrix(p: Placement) -> np.ndarray:
    """Dense R [N_arr, N_clus, D_p] (for tests/inspection)."""
    R = np.zeros((p.N_arr, p.N_clus, p.D_p), dtype=bool)
    for c in range(p.N_clus):
        occ = p.place[:, c] >= 0
        if occ.any():
            R[occ, c] = p.usage[c][p.place[occ, c]]
    return R


def count_routes(R: np.ndarray) -> int:
    """Equation 6 on a dense routing matrix."""
    return int(np.count_nonzero(R.any(axis=1)))


def swap_delta(p: Placement, c: int, e0: int, e1: int) -> np.ndarray:
    """Route-count delta rows for swapping slots (e0, c) <-> (e1, c).

    Returns the *new* cnt rows for e0 and e1 (shape [2, D_p]) without
    mutating the placement — the annealer applies them on acceptance.
    """
    u = p.usage[c]
    g0, g1 = p.place[e0, c], p.place[e1, c]
    r0 = u[g0].astype(np.int32) if g0 >= 0 else 0
    r1 = u[g1].astype(np.int32) if g1 >= 0 else 0
    new_e0 = p.cnt[e0] - r0 + r1
    new_e1 = p.cnt[e1] - r1 + r0
    return np.stack([new_e0, new_e1])


def apply_swap(p: Placement, c: int, e0: int, e1: int, new_rows: np.ndarray):
    p.place[e0, c], p.place[e1, c] = p.place[e1, c], p.place[e0, c]
    p.cnt[e0] = new_rows[0]
    p.cnt[e1] = new_rows[1]
