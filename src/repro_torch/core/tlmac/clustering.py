"""Clustering of the sequential dimension (paper §5.1).

Copy of ``repro.core.tlmac.clustering`` for the port (that package's
``__init__`` imports JAX); the two must stay identical in behaviour:
``tests/test_torch_tlmac.py`` holds the compiled plans equal.

Steps along D_s are clustered into exactly N_clus clusters so that steps
sharing many weight groups land in the same cluster — shared groups are
then stored only once per cluster, minimising N_arr (the number of LUT
arrays, i.e. the pool size).

The paper uses spectral clustering with the ClusterQR label-assignment
strategy (Damle, Minden & Ying, 2019).  sklearn is not available in this
environment, so both are implemented here from first principles with
numpy/scipy:

  1. binary assignment matrix C [D_s, N_uwg]
  2. cosine kNN affinity graph (symmetrised)
  3. normalised adjacency  M = D^-1/2 A D^-1/2
  4. top-N_clus eigenvectors of M (equivalently, smallest of the
     normalised Laplacian)
  5. ClusterQR: column-pivoted QR picks N_clus representative rows;
     labels = argmax over the polar factor projection.

For very large D_s a cheaper greedy fallback keeps compilation tractable
on one CPU core (the FPGA analogue would be a hierarchical flow).
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import scipy.sparse
import scipy.sparse.linalg


def _cosine_knn_affinity(C: np.ndarray, n_neighbors: int) -> scipy.sparse.csr_matrix:
    X = C.astype(np.float32)
    norms = np.linalg.norm(X, axis=1, keepdims=True)
    norms = np.maximum(norms, 1e-12)
    Xn = X / norms
    S = Xn @ Xn.T  # [D_s, D_s] cosine similarity
    np.fill_diagonal(S, 0.0)
    n = S.shape[0]
    k = min(n_neighbors, n - 1)
    # keep k largest per row
    keep = np.argpartition(-S, kth=k - 1, axis=1)[:, :k]
    rows = np.repeat(np.arange(n), k)
    cols = keep.reshape(-1)
    vals = S[rows, cols]
    A = scipy.sparse.csr_matrix((vals, (rows, cols)), shape=(n, n))
    A = A.maximum(A.T)  # symmetrise
    return A


def _cluster_qr(V: np.ndarray) -> np.ndarray:
    """ClusterQR label assignment (Damle et al. 2019; sklearn 'cluster_qr')."""
    k = V.shape[1]
    _, _, piv = scipy.linalg.qr(V.T, pivoting=True)
    ut, _, vt = np.linalg.svd(V[piv[:k], :].T)
    vectors = np.abs(V @ (ut @ vt))
    return vectors.argmax(axis=1).astype(np.int32)


def _greedy_cluster(C: np.ndarray, n_clusters: int, seed: int) -> np.ndarray:
    """Cheap fallback for very large D_s: greedy balanced assignment.

    Seeds clusters with spread-out rows, then assigns each step to the
    cluster whose accumulated group-usage footprint it overlaps most
    (ties broken toward smaller clusters to balance N_arr).
    """
    rng = np.random.default_rng(seed)
    n = C.shape[0]
    order = rng.permutation(n)
    seeds = order[:n_clusters]
    footprint = C[seeds].astype(np.float32).copy()  # [n_clusters, N_uwg]
    counts = np.ones(n_clusters)
    labels = np.full(n, -1, dtype=np.int32)
    labels[seeds] = np.arange(n_clusters)
    for i in order[n_clusters:]:
        row = C[i].astype(np.float32)
        overlap = footprint @ row  # shared groups with each cluster
        # prefer overlap, lightly penalise crowded clusters
        score = overlap - 0.01 * counts
        c = int(np.argmax(score))
        labels[i] = c
        footprint[c] = np.maximum(footprint[c], row)
        counts[c] += 1
    return labels


def spectral_cluster_steps(
    C: np.ndarray,
    n_clusters: int,
    n_neighbors: int = 10,
    seed: int = 0,
    max_spectral: int = 8192,
) -> np.ndarray:
    """Cluster D_s steps into <= n_clusters clusters. Returns labels [D_s]."""
    D_s = C.shape[0]
    if n_clusters <= 1 or D_s <= n_clusters:
        # trivially one step per cluster (constraint D_s <= N_clus)
        return np.arange(D_s, dtype=np.int32) % max(n_clusters, 1)
    if D_s > max_spectral:
        return _greedy_cluster(C, n_clusters, seed)

    A = _cosine_knn_affinity(C, n_neighbors)
    deg = np.asarray(A.sum(axis=1)).reshape(-1)
    deg = np.maximum(deg, 1e-12)
    d_inv_sqrt = 1.0 / np.sqrt(deg)
    Dm = scipy.sparse.diags(d_inv_sqrt)
    M = Dm @ A @ Dm  # normalised adjacency; top eigvecs == bottom of L_sym

    k = n_clusters
    if k >= D_s - 1:
        Md = M.toarray()
        w, V = np.linalg.eigh(Md)
        V = V[:, -k:]
    else:
        try:
            # deterministic start vector: eigsh otherwise draws from the
            # GLOBAL numpy RNG, making compilation order-dependent
            v0 = np.full(D_s, 1.0 / np.sqrt(D_s))
            w, V = scipy.sparse.linalg.eigsh(M, k=k, which="LA", tol=1e-4, v0=v0)
        except Exception:
            Md = M.toarray()
            w, V = np.linalg.eigh(Md)
            V = V[:, -k:]
    # Row-normalise the embedding (standard for L_sym spectral clustering).
    rn = np.linalg.norm(V, axis=1, keepdims=True)
    V = V / np.maximum(rn, 1e-12)
    labels = _cluster_qr(V)
    return labels
