"""Weight-group extraction and MAC-table construction (paper §3.2, §5).

Copy of ``repro.core.tlmac.groups`` for the port (that package's
``__init__`` imports JAX); the two must stay identical in behaviour:
``tests/test_torch_tlmac.py`` holds the compiled plans equal.

The TLMAC compiler is an *offline* stage (the FPGA analogue is synthesis),
so everything here is numpy — deterministic, no devices touched.

Terminology (paper):
- weight group  W = {w_0..w_{G-1}}: G consecutive weights processed by one
  LUT array; for convolutions, one kernel row (G = D_k).
- weight tensor reshaped to [D_s, D_p, G]: D_p groups are evaluated in
  parallel per sequential step, D_s steps in sequence.
- unique weight groups: the codebook; low-bit quantisation means
  N_uwg << D_s * D_p (Fig. 5).
- MAC table T[u, c] = sum_g bit(c, g) * U[u, g]: the pre-computed result of
  a one-bit-plane MAC between input pattern c and unique group u.  On the
  FPGA this is the LUT truth-table content; on the GPU it is an int32
  table read by the lookup-GEMM kernels.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class WeightGroups:
    """Weight tensor reorganised into groups (paper Fig. 4, left)."""

    groups: np.ndarray  # [D_s, D_p, G] int
    D_s: int
    D_p: int
    G: int
    layout: str  # 'conv' | 'matmul'
    orig_shape: tuple


def extract_groups_conv(w_codes: np.ndarray, d_p_channels: int = 64) -> WeightGroups:
    """Conv weights [D_o, D_i, D_k, D_k] -> groups [D_s, D_p, D_k].

    Paper §3.2: a weight group is one kernel row. D_p = 64 * D_k (64 output
    channels x D_k kernel rows in parallel); D_s = D_i * D_o / 64.
    """
    w = np.asarray(w_codes)
    assert w.ndim == 4, f"conv weights must be 4D, got {w.shape}"
    D_o, D_i, D_k, D_k2 = w.shape
    assert D_k == D_k2, "square kernels only"
    c = min(d_p_channels, D_o)
    assert D_o % c == 0, (D_o, c)
    n_otile = D_o // c
    # [D_o, D_i, D_k(rows), G=D_k] -> s = (otile, i), p = (o_in_tile, row)
    g = w.reshape(n_otile, c, D_i, D_k, D_k)
    g = g.transpose(0, 2, 1, 3, 4)  # [otile, D_i, c, rows, G]
    g = g.reshape(n_otile * D_i, c * D_k, D_k)
    return WeightGroups(
        groups=g, D_s=n_otile * D_i, D_p=c * D_k, G=D_k,
        layout="conv", orig_shape=w.shape,
    )


def extract_groups_matmul(
    w_codes: np.ndarray, G: int = 4, d_p: int = 64
) -> WeightGroups:
    """Matmul weights [K, N] -> groups [D_s, D_p, G].

    LM adaptation (DESIGN.md §2): group G consecutive weights along the
    reduction dimension K.  D_p = d_p output features in parallel;
    D_s = (K/G) * (N/d_p) sequential steps, ordered (n_tile, k_group) so a
    full output tile completes before moving on — mirroring the paper's
    row-major window sweep.
    """
    w = np.asarray(w_codes)
    assert w.ndim == 2, f"matmul weights must be 2D, got {w.shape}"
    K, N = w.shape
    assert K % G == 0, f"K={K} not divisible by G={G}"
    p = min(d_p, N)
    assert N % p == 0, (N, p)
    n_tiles = N // p
    kg = K // G
    # [K, N] -> [kg, G, n_tiles, p] -> s = (n_tile, kgroup), p = out feature
    g = w.reshape(kg, G, n_tiles, p)
    g = g.transpose(2, 0, 3, 1)  # [n_tiles, kg, p, G]
    g = g.reshape(n_tiles * kg, p, G)
    return WeightGroups(
        groups=g, D_s=n_tiles * kg, D_p=p, G=G,
        layout="matmul", orig_shape=w.shape,
    )


def unique_groups(wg: WeightGroups):
    """Extract the codebook.

    Returns (U [N_uwg, G] int, idx [D_s, D_p] int32) with
    groups[s, p] == U[idx[s, p]].
    """
    flat = wg.groups.reshape(-1, wg.G)
    U, inv = np.unique(flat, axis=0, return_inverse=True)
    idx = inv.reshape(wg.D_s, wg.D_p).astype(np.int32)
    return U.astype(np.int32), idx


def mac_table(U: np.ndarray, G: int) -> np.ndarray:
    """MAC table T[u, c] = sum_g bit(c, g) * U[u, g]  (int32, [N_uwg, 2^G]).

    Bit g of the code corresponds to weight w_g (LSB = w_0), matching the
    bit-serial LUT input ordering in paper §3.1.2.
    """
    U = np.asarray(U, dtype=np.int64)
    codes = np.arange(2**G, dtype=np.int64)
    bits = (codes[:, None] >> np.arange(G)[None, :]) & 1  # [2^G, G]
    T = U @ bits.T  # [N_uwg, 2^G]
    return T.astype(np.int32)


def assignment_matrix(idx: np.ndarray, n_uwg: int) -> np.ndarray:
    """Binary C [D_s, N_uwg]: which unique groups each step uses (Fig. 4)."""
    D_s = idx.shape[0]
    C = np.zeros((D_s, n_uwg), dtype=bool)
    rows = np.repeat(np.arange(D_s), idx.shape[1])
    C[rows, idx.reshape(-1)] = True
    return C
