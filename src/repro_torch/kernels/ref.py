"""Plain-torch oracles (ports of ``repro.kernels.ref``).  Integer paths
are bit-exact int32, so tests compare with equality."""

from __future__ import annotations

import torch


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


# index-tensor budget of one gather in tlmac_matmul_ref (elements): rows
# of M are processed in blocks so full-width shapes stay within memory
_GATHER_ELEMS = 1 << 26


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
    C = table.shape[-1]
    n_arr = table.shape[1]
    codes = pack_bitplanes_ref(a_codes, B_a, G).to(torch.int64)  # [B_a,M,kg]
    rowbase = (
        step_cluster.reshape(n_tiles, kg, 1).to(torch.int64) * n_arr
        + exec_idx.reshape(n_tiles, kg, D_p).to(torch.int64)
    )                                            # [nt, kg, D_p]
    flat = table.reshape(-1)
    base = (rowbase * C).unsqueeze(0)            # [1, nt, kg, D_p]
    out = torch.zeros((M, n_tiles, D_p), dtype=torch.int32,
                      device=a_codes.device)
    mb = max(1, _GATHER_ELEMS // max(rowbase.numel(), 1))
    for m0 in range(0, M, mb):
        m1 = min(M, m0 + mb)
        for b in range(B_a):
            code = codes[b, m0:m1][:, None, :, None]    # [mb, 1, kg, 1]
            sel = flat[base + code]                     # [mb, nt, kg, D_p]
            out[m0:m1] += sel.sum(dim=2, dtype=torch.int32) << b
    return out.reshape(M, N)
