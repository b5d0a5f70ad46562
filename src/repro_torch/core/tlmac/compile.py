"""End-to-end TLMAC layer compiler (port of ``repro.core.tlmac.compile``;
numpy and scipy only, so plans are identical to the reference's for the
same weights and seed).

    quantised int weights
      -> weight groups               (groups.py, §3.2)
      -> unique-group codebook       (groups.py, §5)
      -> spectral clustering of D_s  (clustering.py, §5.1)
      -> LUT-array placement         (placement.py)
      -> simulated annealing         (annealing.py, §5.2)
      -> LUT INIT packing            (lut.py)  [FPGA artifact]
      -> execution plan              (tables + indices)
      -> FPGA cost model             (costmodel.py, Table 1 / Fig. 8)

The execution plan is the triple
    table    [N_clus, N_arr, 2^G]  int32  (padded MAC tables per cluster)
    exec_idx [D_s, D_p]            int32  (which LUT array serves
                                           (step, output); the paper's
                                           switch select)
    step_cluster [D_s]             int32  (the paper's mapping memory)
such that for activation-bit codes ``code_b[s]``:

    mac[s, p] = table[step_cluster[s], exec_idx[s, p], code_b[s, p-group]]

which is bit-exact to the dense integer MAC.  ``verify_plan`` proves it.
The lookup-GEMM kernels (``repro_torch.kernels``) execute it on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.tlmac import annealing, clustering, groups, lut, placement
from repro_torch.core.tlmac.costmodel import FPGAResources, hybrid_layer_cost


@dataclasses.dataclass
class TLMACLayerPlan:
    # --- structure ---
    layout: str                  # 'conv' | 'matmul'
    orig_shape: tuple
    G: int
    B_w: int
    D_s: int
    D_p: int
    N_uwg: int
    N_clus: int
    N_arr: int
    # --- execution plan ---
    table: np.ndarray            # [N_clus, N_arr, 2^G] int32 (zero-padded)
    exec_idx: np.ndarray         # [D_s, D_p] int32  array index per (s, p)
    step_cluster: np.ndarray     # [D_s] int32
    codebook: np.ndarray         # [N_uwg, G] int32 (for verification)
    idx: np.ndarray              # [D_s, D_p] int32 unique-group ids
    # --- FPGA artifacts ---
    lut_inits: Optional[np.ndarray]   # uint64 [N_arr, N_lut]
    resources: FPGAResources
    anneal: Optional[annealing.AnnealResult]
    routes_before: int
    routes_after: int
    # device copies of derived plan arrays, keyed by (what, device); filled
    # by the execution paths so repeated calls upload nothing
    device_cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                           compare=False)

    @property
    def logic_density(self) -> float:
        return self.N_uwg / max(self.N_arr, 1)


def compile_layer(
    w_codes: np.ndarray,
    B_w: int,
    B_a: int,
    G: int = 4,
    d_p: int = 64,
    B_p: int = 24,
    anneal_iters: Optional[int] = None,
    seed: int = 0,
    pack_luts: bool = True,
    cluster_max_spectral: int = 8192,
) -> TLMACLayerPlan:
    """Compile one quantised layer's integer weight codes to a TLMAC plan."""
    w = np.asarray(w_codes)
    if w.ndim == 4:
        wg = groups.extract_groups_conv(w, d_p_channels=d_p)
    elif w.ndim == 2:
        wg = groups.extract_groups_matmul(w, G=G, d_p=d_p)
    else:
        raise ValueError(f"unsupported weight rank {w.ndim}")
    G = wg.G

    U, idx = groups.unique_groups(wg)
    T = groups.mac_table(U, G)
    n_uwg = U.shape[0]
    n_clus = lut.n_clus_slots(G)

    # --- §5.1 clustering of the sequential dimension ---
    C = groups.assignment_matrix(idx, n_uwg)
    labels = clustering.spectral_cluster_steps(
        C, n_clus, seed=seed, max_spectral=cluster_max_spectral
    )
    clusters, usage = placement.build_clusters(idx, labels, n_clus)

    # --- §5.2 placement + simulated annealing ---
    pl = placement.random_placement(clusters, usage, wg.D_p, seed=seed)
    routes_before = pl.routes()
    if anneal_iters is None:
        anneal_iters = annealing.iterations_for_layer(routes_before)
    ar = annealing.anneal_routing(pl, iterations=anneal_iters, seed=seed)
    routes_after = ar.r_final

    # --- execution plan ---
    n_arr = pl.N_arr
    table = np.zeros((n_clus, n_arr, 2**G), dtype=np.int32)
    # gid -> array index, per cluster
    gid_to_arr = [dict() for _ in range(n_clus)]
    for c in range(n_clus):
        for e in range(n_arr):
            slot = pl.place[e, c]
            if slot >= 0:
                gid = int(clusters[c][slot])
                table[c, e] = T[gid]
                gid_to_arr[c][gid] = e
    exec_idx = np.zeros((wg.D_s, wg.D_p), dtype=np.int32)
    step_cluster = labels.astype(np.int32)
    for s in range(wg.D_s):
        c = int(labels[s])
        m = gid_to_arr[c]
        exec_idx[s] = [m[int(g)] for g in idx[s]]

    # --- FPGA artifacts ---
    lut_inits = (
        lut.pack_lut_inits(T, pl.place, clusters, G, B_w) if pack_luts else None
    )
    res = hybrid_layer_cost(
        n_arr=n_arr, G=G, B_w=B_w, B_a=B_a, B_p=B_p,
        D_p=wg.D_p, D_s=wg.D_s, cnt=pl.cnt,
    )

    return TLMACLayerPlan(
        layout=wg.layout, orig_shape=wg.orig_shape, G=G, B_w=B_w,
        D_s=wg.D_s, D_p=wg.D_p, N_uwg=n_uwg, N_clus=n_clus, N_arr=n_arr,
        table=table, exec_idx=exec_idx, step_cluster=step_cluster,
        codebook=U, idx=idx, lut_inits=lut_inits, resources=res,
        anneal=ar, routes_before=routes_before, routes_after=routes_after,
    )


def verify_plan(plan: TLMACLayerPlan) -> bool:
    """Losslessness: every (step, output) group must be recoverable from
    (table, exec_idx, step_cluster) — single-bit probes reconstruct the
    weights exactly."""
    G = plan.G
    # weight g of group = table[..., 1<<g] (only bit g set)
    for g in range(G):
        w_rec = plan.table[
            plan.step_cluster[:, None], plan.exec_idx, 1 << g
        ]  # [D_s, D_p]
        w_ref = plan.codebook[plan.idx][..., g]
        if not np.array_equal(w_rec, w_ref):
            return False
    return True


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
    n_clus = lut.n_clus_slots(G)
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
