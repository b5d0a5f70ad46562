"""LUT-6 truth-table packing (paper §3.1.2, §5 "LUT initialisations").

Copy of ``repro.core.tlmac.lut`` for the port (that package's
``__init__`` imports JAX); the two must stay identical in behaviour:
``tests/test_torch_tlmac.py`` holds the compiled plans equal.

Each LUT array holds N_lut = B_w + ceil(log2 G) LUT-6 primitives.  A LUT-6
maps 6 input bits -> 1 output bit and is configured by a 64-bit INIT value
(AMD UltraScale+ CLB, UG574).  Address layout (LSB first):

    address = { select s (6-G bits, high) , activation code (G bits, low) }

The LUT array at (array e) stores, for every cluster slot s = c, the MAC
table row of the group placed at (e, c):  out = T[group, code], encoded
two's-complement in N_lut bits across the N_lut LUTs.

Empty slots encode 0.  ``eval_lut_array`` re-evaluates the truth tables so
round-trip tests can prove bit-exactness of the packing.
"""

from __future__ import annotations

import math

import numpy as np


def n_lut_bits(B_w: int, G: int) -> int:
    """Equation 4: N_lut = B_w + ceil(log2 G)."""
    return B_w + int(math.ceil(math.log2(G))) if G > 1 else B_w


def n_clus_slots(G: int) -> int:
    """Equation 5: N_clus = 2^(6-G) selectable weight groups per array."""
    assert 1 <= G <= 6
    return 2 ** (6 - G)


def pack_lut_inits(
    T: np.ndarray,           # [N_uwg, 2^G] int32 MAC table
    place: np.ndarray,       # [N_arr, N_clus] slot->group-index (into cluster list), -1 empty
    clusters,                # list of per-cluster group-id arrays
    G: int,
    B_w: int,
) -> np.ndarray:
    """Returns LUT INIT values, uint64 [N_arr, N_lut]."""
    N_arr, N_clus = place.shape
    assert N_clus <= n_clus_slots(G), (N_clus, n_clus_slots(G))
    B_l = n_lut_bits(B_w, G)
    n_codes = 2**G
    mask = (1 << B_l) - 1

    inits = np.zeros((N_arr, B_l), dtype=np.uint64)
    for e in range(N_arr):
        for c in range(N_clus):
            slot = place[e, c]
            if slot < 0:
                continue
            gid = clusters[c][slot]
            row = T[gid].astype(np.int64) & mask  # two's complement in B_l bits
            for code in range(n_codes):
                addr = (c << G) | code
                bits = row[code]
                for j in range(B_l):
                    if (bits >> j) & 1:
                        inits[e, j] |= np.uint64(1) << np.uint64(addr)
    return inits


def eval_lut_array(
    inits: np.ndarray,       # uint64 [N_arr, N_lut]
    e: int,
    select: int,
    code: int,
    G: int,
    B_w: int,
) -> int:
    """Read the LUT array exactly as the hardware would: 6-bit address
    lookup per LUT, reassemble two's complement."""
    B_l = n_lut_bits(B_w, G)
    addr = (select << G) | code
    val = 0
    for j in range(B_l):
        bit = int(inits[e, j] >> np.uint64(addr)) & 1
        val |= bit << j
    # sign-extend from B_l bits
    if val & (1 << (B_l - 1)):
        val -= 1 << B_l
    return val
