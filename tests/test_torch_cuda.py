"""The CUDA kernels of the compile-and-execute path (kernels 3-6) against
their plain versions on the card, on plans compiled by the port.  This
file imports nothing of JAX, so it also runs where only the port is
installed:

    PYTHONPATH=src python -m pytest -m requires_cuda tests/test_torch_cuda.py

Every test needs a CUDA device and skips without one (the hand kernels
have no CPU mode)."""

import numpy as np
import pytest
import torch

from repro_torch.core.tlmac.compile import compile_layer
from repro_torch.kernels import bitplanes as bp
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import tlmac_clustered as tc
from repro_torch.kernels import tlmac_gemm as tg


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand kernels have no CPU mode)")
    return torch.device("cuda")


def _compiled(K, N, M, B_w, B_a, G, d_p, seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(-(2 ** (B_w - 1)), 2 ** (B_w - 1), size=(K, N))
    plan = compile_layer(w, B_w=B_w, B_a=B_a, G=G, d_p=d_p, anneal_iters=100,
                         seed=0)
    a = rng.integers(0, 2**B_a, size=(M, K)).astype(np.int8)
    return w, plan, torch.from_numpy(a)


# (K, N, M, B_w, B_a, G): G 2/3/4/6, ragged kg against the 32-group step,
# M ragged against the 64-row block
SWEEP = [(16, 64, 4, 2, 2, 2), (24, 64, 8, 3, 3, 3), (32, 128, 16, 3, 4, 4),
         (48, 64, 5, 4, 4, 6), (64, 192, 33, 2, 3, 4), (40, 128, 97, 3, 8, 4)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("K,N,M,B_w,B_a,G", SWEEP)
def test_pack_and_lookup_gemm_equal_plain_on_card(cuda, K, N, M, B_w, B_a, G):
    w, plan, a = _compiled(K, N, M, B_w, B_a, G, 64, K + M)
    a = a.to(cuda)
    n0, g0 = bp.launches, tg.launches
    codes = bp.pack_bitplanes(a, B_a=B_a, G=G)
    assert torch.equal(codes, bp.pack_bitplanes_plain(a, B_a=B_a, G=G))
    table = torch.from_numpy(plan.table).to(cuda)
    rb = kref.rowbase_from_plan(table, torch.from_numpy(plan.exec_idx).to(cuda),
                                torch.from_numpy(plan.step_cluster).to(cuda),
                                N // 64, K // G)
    t2d = table.reshape(-1, 2**G)
    got = tg.tlmac_gemm(codes, rb, t2d, B_a=B_a, G=G, N=N)
    want = tg.tlmac_gemm_plain(codes, rb, t2d, B_a=B_a, G=G, N=N)
    torch.cuda.synchronize()
    assert (bp.launches, tg.launches) == (n0 + 1, g0 + 1)
    assert torch.equal(got, want)
    dense = ops.dense_int_matmul(a, torch.from_numpy(w).to(cuda))
    assert torch.equal(got, dense)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("K,N,M,B_w,B_a,G,d_p,bk", [
    (64, 64, 21, 3, 3, 4, 64, 4), (24, 32, 7, 2, 2, 3, 32, 2),
    (48, 128, 9, 4, 4, 4, 128, 8), (64, 128, 21, 3, 3, 4, 64, 4),
    (24, 96, 7, 2, 2, 3, 32, 2), (96, 192, 70, 3, 3, 3, 64, 8)])
def test_clustered_kernels_equal_plain_on_card(cuda, K, N, M, B_w, B_a, G,
                                               d_p, bk):
    w, plan, a = _compiled(K, N, M, B_w, B_a, G, d_p, K + N)
    a = a.to(cuda)
    dense = ops.dense_int_matmul(a, torch.from_numpy(w).to(cuda))
    n_tiles = N // d_p
    s = tc.device_schedule(plan, n_tiles, bk, cuda, tiled=True)
    cs = bp.pack_bitplanes(a, B_a=B_a, G=G).index_select(2, s["cols"])
    m0 = tc.launches_multi
    got = tc.tlmac_gemm_clustered_multi(cs, s["idx_sorted"], s["table_pad"],
                                        B_a=B_a, G=G)
    want = tc.tlmac_gemm_clustered_multi_plain(cs, s["idx_sorted"],
                                               s["table_pad"], B_a=B_a, G=G)
    torch.cuda.synchronize()
    assert tc.launches_multi == m0 + 1
    assert torch.equal(got, want) and torch.equal(got, dense)
    if n_tiles == 1:
        s1 = tc.device_schedule(plan, 1, bk, cuda, tiled=False)
        c1 = bp.pack_bitplanes(a, B_a=B_a, G=G).index_select(2, s1["cols"])
        l0 = tc.launches
        one = tc.tlmac_gemm_clustered(c1, s1["idx_sorted"], s1["table_pad"],
                                      B_a=B_a, G=G)
        torch.cuda.synchronize()
        assert tc.launches == l0 + 1
        assert torch.equal(one, tc.tlmac_gemm_clustered_plain(
            c1, s1["idx_sorted"], s1["table_pad"], B_a=B_a, G=G))
        assert torch.equal(one, dense)


@pytest.mark.requires_cuda
def test_clustered_kernel_rejects_a_slice_too_large_for_shared_memory(cuda):
    # a G=4 plan at N_arr = 4096 has a 262 KB table slice
    n_clus, n_arr1, ms, dp = 4, 4097, 8, 64
    codes = torch.zeros((3, 5, n_clus * ms), dtype=torch.int8, device=cuda)
    idx = torch.zeros((n_clus, ms, dp), dtype=torch.int32, device=cuda)
    table = torch.zeros((n_clus, n_arr1, 16), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared"):
        tc.tlmac_gemm_clustered(codes, idx, table, B_a=3, G=4)
