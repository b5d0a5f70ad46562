"""Plain-torch oracles (ports of ``repro.kernels.ref``).  Integer paths
are bit-exact int32, so tests compare with equality."""

from __future__ import annotations

import torch


def dense_int_matmul_ref(a_codes: torch.Tensor,
                         w_codes: torch.Tensor) -> torch.Tensor:
    """out[m, n] = sum_k a[m, k] * w[k, n]  in int32.

    Computed in float64, which holds every integer below 2^53 exactly, so
    the same code runs on the CPU and on the card (where no integer matmul
    takes arbitrary shapes)."""
    return torch.matmul(a_codes.to(torch.float64),
                        w_codes.to(torch.float64)).to(torch.int32)


def bitserial_matmul_ref(a_codes: torch.Tensor, w_codes: torch.Tensor,
                         B_a: int) -> torch.Tensor:
    """Paper Eq. 3 WITHOUT the lookup: bit-serial binary x int matmuls,
    ``out = sum_b 2^b (a_bits_b @ W)`` in int32 (each plane's product in
    float64, exact, as ``dense_int_matmul_ref``).  The ablation point
    between the dense integer GEMM and TLMAC: the same serialisation, no
    weight-group reuse."""
    a = a_codes.to(torch.int32)
    w = w_codes.to(torch.float64)
    out = torch.zeros((a_codes.shape[0], w_codes.shape[-1]),
                      dtype=torch.int32, device=a_codes.device)
    for b in range(B_a):
        bits = ((a >> b) & 1).to(torch.float64)
        out = out + (torch.matmul(bits, w).to(torch.int32) << b)
    return out


def pack_bitplanes_ref(a_codes: torch.Tensor, B_a: int, G: int) -> torch.Tensor:
    """Activation codes [M, K] -> per-bit-plane group codes [B_a, M, K/G].

    code_b[m, kg] = sum_g bit_b(a[m, kg*G + g]) << g   (paper Eq. 3)."""
    M, K = a_codes.shape
    assert K % G == 0
    a = a_codes.to(torch.int32).reshape(M, K // G, G)
    shifts = torch.arange(G, dtype=torch.int32, device=a.device)
    planes = [(((a >> b) & 1) << shifts).sum(-1).to(torch.int8)
              for b in range(B_a)]
    return torch.stack(planes)  # [B_a, M, K/G] int8 (codes < 2^G <= 64)


# index-tensor budget of one gather in lookup_gemm_ref (elements): rows
# of M are processed in blocks so full-width shapes stay within memory
_GATHER_ELEMS = 1 << 26


def lookup_gemm_ref(codes: torch.Tensor, rowbase: torch.Tensor,
                    table2d: torch.Tensor, B_a: int) -> torch.Tensor:
    """The lookup GEMM on packed codes, the arithmetic every lookup
    kernel computes:

    out[m, nt*D_p + p] = sum_b 2^b sum_kg T2D[rowbase[nt, kg, p], codes[b, m, kg]]

    codes ``[B_a, M, KG]`` (any int dtype), rowbase ``[n_tiles, KG, D_p]``,
    table2d ``[R, 2^G]`` int32 -> int32 ``[M, n_tiles*D_p]``."""
    _, M, KG = codes.shape
    n_tiles, KG2, D_p = rowbase.shape
    assert KG == KG2, (codes.shape, rowbase.shape)
    C = table2d.shape[-1]
    flat = table2d.reshape(-1)
    base = (rowbase.to(torch.int64) * C).unsqueeze(0)     # [1, nt, KG, D_p]
    out = torch.zeros((M, n_tiles, D_p), dtype=torch.int32,
                      device=codes.device)
    mb = max(1, _GATHER_ELEMS // max(rowbase.numel(), 1))
    for m0 in range(0, M, mb):
        m1 = min(M, m0 + mb)
        for b in range(B_a):
            code = codes[b, m0:m1].to(torch.int64)[:, None, :, None]
            sel = flat[base + code]                         # [mb, nt, KG, D_p]
            out[m0:m1] += sel.sum(dim=2, dtype=torch.int32) << b
    return out.reshape(M, n_tiles * D_p)


def rowbase_from_plan(table: torch.Tensor, exec_idx: torch.Tensor,
                      step_cluster: torch.Tensor, n_tiles: int,
                      kg: int) -> torch.Tensor:
    """int32 ``[n_tiles, kg, D_p]`` rows of the 2-D table ``[N_clus*N_arr,
    2^G]``: ``step_cluster * N_arr + exec_idx`` (the paper's select and
    switch pair).  exec_idx ``[D_s, D_p]`` or ``[n_tiles, kg, D_p]``."""
    D_p = exec_idx.shape[-1]
    n_arr = table.shape[1]
    rb = (step_cluster.reshape(-1, 1).to(torch.int32) * n_arr
          + exec_idx.reshape(-1, D_p).to(torch.int32))
    return rb.reshape(n_tiles, kg, D_p)


def tlmac_matmul_ref(
    a_codes: torch.Tensor,      # [M, K] uint codes (B_a bits)
    table: torch.Tensor,        # [N_clus, N_arr, 2^G] int32
    exec_idx: torch.Tensor,     # [D_s, D_p] (or [n_tiles, kg, D_p]) int
    step_cluster: torch.Tensor, # [D_s] (or [n_tiles, kg]) int
    B_a: int,
    G: int,
    N: int,
) -> torch.Tensor:
    """Direct table-lookup evaluation (paper Eq. 3 + Fig. 3 switches):

    out[m, n] = sum_b 2^b sum_kg T[cl[s], e[s, p], code_b[m, kg]]
    with s = n_tile * (K/G) + kg,  n = n_tile * D_p + p.
    """
    M, K = a_codes.shape
    D_p = exec_idx.shape[-1]
    n_tiles = N // D_p
    kg = K // G
    assert exec_idx.numel() == n_tiles * kg * D_p, (exec_idx.shape, n_tiles, kg)
    codes = pack_bitplanes_ref(a_codes, B_a, G)                 # [B_a, M, kg]
    rowbase = rowbase_from_plan(table, exec_idx, step_cluster, n_tiles, kg)
    return lookup_gemm_ref(codes, rowbase, table.reshape(-1, table.shape[-1]),
                           B_a)
