"""The CUDA kernels against their plain versions on the card: kernels 3-6
(the compile-and-execute path) and kernel 1 on plans compiled by the
port, kernel 1 through ``TLMACLinear``'s serve params, and kernel 2's
single launch over every pool kind.  This file imports nothing of JAX,
so it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest -m requires_cuda tests/test_torch_cuda.py

Every test needs a CUDA device and skips without one (the hand kernels
have no CPU mode)."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.tlmac.compile import compile_layer
from repro_torch.kernels import bitplanes as bp
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import tlmac_clustered as tc
from repro_torch.kernels import tlmac_fused as tf
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
    # the kernel reads the plan's table as narrow rows, made once
    table = tf.narrow_table(torch.from_numpy(plan.table)).to(cuda)
    rb = kref.rowbase_from_plan(table, torch.from_numpy(plan.exec_idx).to(cuda),
                                torch.from_numpy(plan.step_cluster).to(cuda),
                                N // 64, K // G)
    t2d = table.reshape(-1, 2**G)
    got = tg.tlmac_gemm(codes, rb, t2d, B_a=B_a, G=G, N=N)
    want = tg.tlmac_gemm_plain(codes, rb, t2d, B_a=B_a, G=G, N=N)
    torch.cuda.synchronize()
    assert (bp.launches, tg.launches) == (n0 + 1, g0 + 1)
    assert torch.equal(got, want)
    # the codes are B_a-bit unsigned; int8 holds those of B_a = 8 above 127
    # as negative bytes, so the dense oracle reads them back unsigned
    dense = ops.dense_int_matmul(a.to(torch.int32) & 0xFF,
                                 torch.from_numpy(w).to(cuda))
    assert torch.equal(got, dense)


# ---------------------------------------------------------------------------
# kernel 3 over its whole domain, on tables built from weight groups
# ---------------------------------------------------------------------------


def _lookup_case(dev, M, KG, n_tiles, dp, B_a, G, wide, seed, R=37):
    """Packed codes, rowbase, the narrow table and the dense integer GEMM
    of one lookup GEMM: table row r holds sum_g bit_g(e) * w[r, g] for R
    random weight groups (|w| < 4, or < 2000 so that the rows are int16),
    so the lookup GEMM equals ``a @ W`` with W's group (kg, column) the
    weights of row rowbase[nt, kg, p]."""
    rng = np.random.default_rng(seed)
    lim = 2000 if wide else 4
    wrows = rng.integers(-lim, lim, size=(R, G))
    bits = (np.arange(2**G)[:, None] >> np.arange(G)) & 1       # [2^G, G]
    table = tf.narrow_table(torch.from_numpy(wrows @ bits.T)).to(dev)
    assert table.dtype == (torch.int16 if wide else torch.int8)
    rb = rng.integers(0, R, size=(n_tiles, KG, dp)).astype(np.int32)
    a = rng.integers(0, 2**B_a, size=(M, KG * G))
    W = wrows[rb].transpose(1, 3, 0, 2).reshape(KG * G, n_tiles * dp)
    dense = torch.from_numpy((a @ W).astype(np.int32)).to(dev)
    codes = bp.pack_bitplanes_plain(
        torch.from_numpy(a.astype(np.uint8).view(np.int8)), B_a=B_a,
        G=G).to(dev)
    return codes, torch.from_numpy(rb).to(dev), table, dense


def _check_lookup(codes, rb, table, dense, B_a, G):
    N = rb.shape[0] * rb.shape[2]
    n0 = tg.launches
    got = tg.tlmac_gemm(codes, rb, table, B_a=B_a, G=G, N=N)
    want = tg.tlmac_gemm_plain(codes, rb, table, B_a=B_a, G=G, N=N)
    torch.cuda.synchronize()
    assert tg.launches == n0 + 1
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(got, dense)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B_a", [1, 3, 8])
@pytest.mark.parametrize("G", [1, 2, 3, 4, 5, 6])
def test_lookup_gemm_kernel_domain_on_card(cuda, G, B_a):
    """G 1-6 and B_a 1/3/8 at M 1, 63, 64, 65, 129 and D_p 5, 30, 64,
    120, 192 (two output tiles each); KG ragged against the kernel's chunk
    of 128 / 2^G groups (one and a half chunks and one more group), and
    below one chunk.  These small M split kg over the grid (atomics)."""
    kc = 128 >> G
    for ci, (M, dp) in enumerate([(1, 5), (63, 30), (64, 64), (65, 120),
                                  (129, 192)]):
        for KG in (kc + kc // 2 + 1, max(1, kc // 2 - 1)):
            case = _lookup_case(cuda, M, KG, 2, dp, B_a, G, False,
                                100 * G + 10 * B_a + ci + KG)
            _check_lookup(*case, B_a, G)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("M,KG,n_tiles,dp,G", [
    (4100, 64, 2, 64, 3),     # 64-row tiles, kg split in two
    (20000, 128, 2, 64, 3),   # 128-row tiles, B resident (int8 rows)
    (4100, 300, 2, 120, 3),   # two column blocks, ragged KG, B streamed
    (6000, 512, 3, 64, 4),    # B streamed
    (5000, 77, 1, 192, 2),    # three column blocks, ragged KG, B resident
])
def test_lookup_gemm_kernel_large_m_on_card(cuda, M, KG, n_tiles, dp, G,
                                            wide):
    """M >= 4096: 64- and 128-row tiles, the B tile resident or streamed,
    int8 and int16 rows."""
    case = _lookup_case(cuda, M, KG, n_tiles, dp, 3, G, wide, M + KG + dp)
    _check_lookup(*case, 3, G)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("G", [1, 2, 3, 4, 5, 6])
def test_lookup_gemm_kernel_int16_rows_on_card(cuda, G):
    """Entries outside int8: rows read as int16 and split exactly into a
    low u8 and a high s8 byte, two products summed."""
    for M, dp, B_a in ((7, 30, 3), (130, 64, 8), (65, 192, 1)):
        case = _lookup_case(cuda, M, 40, 2, dp, B_a, G, True, G * M + dp)
        assert case[2].abs().max() > 127
        _check_lookup(*case, B_a, G)


@pytest.mark.requires_cuda
def test_lookup_gemm_kernel_full_stage1_row_on_card(cuda):
    """One full ResNet-18 stage-1 row GEMM: M = 32 * 56 * 56, KG 64, dp 64."""
    case = _lookup_case(cuda, 100352, 64, 1, 64, 3, 3, False, 1)
    _check_lookup(*case, 3, 3)


@pytest.mark.requires_cuda
def test_lookup_gemm_kernel_refuses_an_int32_table_on_card(cuda):
    codes, rb, table, dense = _lookup_case(cuda, 9, 16, 1, 64, 3, 3, False, 2)
    with pytest.raises(ValueError, match="narrow_table"):
        tg.tlmac_gemm(codes, rb, table.int(), B_a=3, G=3, N=64)
    # the plain version on the CPU takes the int32 table as it is
    got = tg.tlmac_gemm(codes.cpu(), rb.cpu(), table.int().cpu(), B_a=3, G=3,
                        N=64)
    assert torch.equal(got, dense.cpu())


# ---------------------------------------------------------------------------
# kernel 4 over its whole domain
# ---------------------------------------------------------------------------


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B_a", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("G", [1, 2, 3, 4, 5, 6])
def test_pack_kernel_domain_on_card(cuda, G, B_a):
    """G 1-6 and B_a 1-8: K a multiple of 16*G and not, M*K/G a multiple
    of 16 and not (the tail of fewer than 16 groups), and an input that is
    not 16-byte aligned, which the kernel handles with byte loads."""
    rng = np.random.default_rng(10 * G + B_a)
    for M, kg in ((1000, 64), (37, 53), (5, 3), (1, 16)):
        a = torch.from_numpy(rng.integers(0, 2**B_a, size=(M, kg * G)).astype(
            np.uint8).view(np.int8))
        want = bp.pack_bitplanes_plain(a, B_a=B_a, G=G)
        assert torch.equal(bp.pack_bitplanes_words_plain(a, B_a=B_a, G=G),
                           want)
        # aligned, then one byte past a 16-byte boundary
        buf = torch.empty(a.numel() + 16, dtype=torch.int8, device=cuda)
        for off in (0, 1):
            x = buf[off:off + a.numel()].view(M, kg * G)
            x.copy_(a.to(cuda))
            assert x.data_ptr() % 16 == off
            n0 = bp.launches
            got = bp.pack_bitplanes(x, B_a=B_a, G=G)
            torch.cuda.synchronize()
            assert bp.launches == n0 + 1
            assert torch.equal(got.cpu(), want), (M, kg, off)


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


def _clustered_random(dev, n_tiles, n_clus, ms, dp, M, B_a, G, n_arr1, dtype,
                      seed):
    """Random operands of kernels 5-6: a table with its zero row, indices
    into the real rows with the last five steps of every run padding."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    lo, hi = (-128, 128) if dtype == torch.int8 else (-3000, 3000)
    table = torch.randint(lo, hi, (n_clus, n_arr1, 2**G), generator=gen,
                          device=dev).to(dtype)
    table[:, -1] = 0                                      # the zero row
    idx = torch.randint(0, n_arr1 - 1, (n_tiles, n_clus, ms, dp),
                        generator=gen, device=dev).to(torch.int32)
    idx[:, :, ms - 5:] = n_arr1 - 1                       # padding steps
    codes = torch.randint(0, 2**G, (B_a, M, n_tiles * n_clus * ms),
                          generator=gen, device=dev).to(torch.int8)
    return codes, idx, table


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n_clus,n_arr1,G,dtype", [
    (4, 4097, 6, torch.int8),       # a 262 KB slice: held in part
    (3, 4097, 6, torch.int16),      # 524 KB
    (2, 9001, 5, torch.int8),       # 288 KB
])
def test_clustered_kernel_takes_a_slice_too_large_for_shared_memory(
        cuda, n_clus, n_arr1, G, dtype):
    """Kernels 5 and 6 on slices past shared memory: the head of each
    slice stays resident, the rows past it are read from device memory by
    the same kernel; equal to the plain versions."""
    ms, dp, M, B_a = 24, 96, 70, 3
    codes, idx, table = _clustered_random(cuda, 2, n_clus, ms, dp, M, B_a, G,
                                          n_arr1, dtype, n_arr1 + G)
    m0, l0 = tc.launches_multi, tc.launches
    got = tc.tlmac_gemm_clustered_multi(codes, idx, table, B_a=B_a, G=G)
    want = tc.tlmac_gemm_clustered_multi_plain(codes, idx, table, B_a=B_a,
                                               G=G)
    L = n_clus * ms
    one = tc.tlmac_gemm_clustered(codes[:, :, :L].contiguous(), idx[0], table,
                                  B_a=B_a, G=G)
    torch.cuda.synchronize()
    assert (tc.launches_multi, tc.launches) == (m0 + 1, l0 + 1)
    assert torch.equal(got, want)
    assert torch.equal(one, want[:, :dp])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n_clus,n_arr1,G,dtype", [
    (130, 33, 3, torch.int8), (200, 17, 4, torch.int16),
    (4, 37, 1, torch.int8), (5, 64, 1, torch.int16), (131, 9, 1, torch.int8),
])
@pytest.mark.parametrize("dp", [5, 64, 192])
def test_clustered_kernel_g1_and_many_clusters_on_card(cuda, n_clus, n_arr1,
                                                       G, dtype, dp):
    """G = 1 (two entries per row; an odd row count makes a 2-byte-aligned
    int8 slice) and more than 128 clusters, at dp 5 / 64 / 192."""
    ms, M, B_a = 12, 67, 4
    codes, idx, table = _clustered_random(cuda, 2, n_clus, ms, dp, M, B_a, G,
                                          n_arr1, dtype, n_clus + dp)
    got = tc.tlmac_gemm_clustered_multi(codes, idx, table, B_a=B_a, G=G)
    want = tc.tlmac_gemm_clustered_multi_plain(codes, idx, table, B_a=B_a,
                                               G=G)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


_PLANS = {}


def _clustered_plan(K, N, B_w, G, d_p, scale=1):
    """A compiled plan and its weights, cached across the M cases; with
    ``scale`` the table (so every weight) is multiplied, which turns the
    narrow rows int16 when an entry leaves int8."""
    key = (K, N, B_w, G, d_p, scale)
    if key not in _PLANS:
        w, plan, _ = _compiled(K, N, 1, B_w, 3, G, d_p, K + N + G)
        plan = dataclasses.replace(plan, table=plan.table * scale,
                                   device_cache={})
        _PLANS[key] = (w * scale, plan)
    return _PLANS[key]


# (K, N, B_w, B_a, G, d_p): G 1-6, B_a 1-8, D_p 32/120/192, 1 to 8 tiles;
# D_p 30 (idx rows copied 4 bytes at a time) and 5 (odd: scalar stores)
CLUSTERED_CARD = [(16, 64, 2, 1, 2, 32), (24, 96, 3, 2, 3, 32),
                  (16, 64, 2, 3, 1, 32), (12, 192, 3, 4, 1, 192),
                  (32, 240, 3, 3, 4, 120), (40, 192, 3, 5, 5, 192),
                  (24, 256, 2, 8, 6, 32), (96, 384, 3, 3, 3, 192),
                  (64, 128, 3, 6, 4, 64), (48, 120, 3, 7, 3, 120),
                  (32, 64, 3, 4, 2, 64), (48, 60, 3, 3, 3, 30),
                  (24, 15, 2, 4, 2, 5)]


def _run_clustered_both(cuda, w, plan, M, B_a, N, d_p, bk, seed):
    """Kernels 6 (and 5 for one tile) on ``plan`` against their plain
    versions and the dense integer GEMM of the plan's weights."""
    a = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 2**B_a, size=(M, w.shape[0])).astype(np.int8)).to(cuda)
    # B_a = 8 codes above 127 are negative int8 bytes: read them unsigned
    dense = ops.dense_int_matmul(a.to(torch.int32) & 0xFF,
                                 torch.from_numpy(w).to(cuda))
    n_tiles = N // d_p
    for tiled in (True, False) if n_tiles == 1 else (True,):
        s = tc.device_schedule(plan, n_tiles, bk, cuda, tiled=tiled)
        assert s["table_pad"].dtype in (torch.int8, torch.int16)
        cs = bp.pack_bitplanes(a, B_a=B_a, G=plan.G).index_select(2, s["cols"])
        idx = s["idx_sorted"]
        fn, plain, count = (
            (tc.tlmac_gemm_clustered_multi, tc.tlmac_gemm_clustered_multi_plain,
             "launches_multi") if tiled else
            (tc.tlmac_gemm_clustered, tc.tlmac_gemm_clustered_plain,
             "launches"))
        n0 = getattr(tc, count)
        got = fn(cs, idx, s["table_pad"], B_a=B_a, G=plan.G)
        want = plain(cs, idx, s["table_pad"], B_a=B_a, G=plan.G)
        torch.cuda.synchronize()
        assert getattr(tc, count) == n0 + 1
        assert torch.equal(got, want), (tiled, (got != want).sum().item())
        assert torch.equal(got, dense)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("M", [1, 15, 16, 17, 129])
@pytest.mark.parametrize("K,N,B_w,B_a,G,d_p", CLUSTERED_CARD)
def test_clustered_kernel_edges_on_card(cuda, M, K, N, B_w, B_a, G, d_p):
    w, plan = _clustered_plan(K, N, B_w, G, d_p)
    _run_clustered_both(cuda, w, plan, M, B_a, N, d_p, 8, M + K)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("G,K,d_p,bk", [(3, 24, 192, 8), (4, 32, 64, 64),
                                        (2, 16, 32, 8), (6, 24, 32, 32)])
def test_clustered_kernel_int16_rows_and_padded_schedules_on_card(
        cuda, G, K, d_p, bk):
    """Entries outside int8 (int16 rows, split exactly into two mma), and
    schedules padded far past their runs (bk 32 / 64)."""
    N = 2 * d_p
    for scale in (1, 50):
        w, plan = _clustered_plan(K, N, 3, G, d_p, scale)
        if scale > 1:
            assert np.abs(plan.table).max() > 127
        _run_clustered_both(cuda, w, plan, 130, 4, N, d_p, bk, G + scale)


@pytest.mark.requires_cuda
def test_clustered_kernel_refuses_an_int32_table_on_card(cuda):
    w, plan = _clustered_plan(24, 64, 3, 3, 64)
    s = tc.device_schedule(plan, 1, 8, cuda, tiled=False)
    cs = torch.zeros((3, 4, s["idx_sorted"].shape[0] * s["idx_sorted"].shape[1]),
                     dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="narrow_table"):
        tc.tlmac_gemm_clustered(cs, s["idx_sorted"], s["table_pad"].int(),
                                B_a=3, G=3)
    # the plain version on the CPU takes the int32 table as it is
    tc.tlmac_gemm_clustered(cs.cpu(), s["idx_sorted"].cpu(),
                            s["table_pad"].int().cpu(), B_a=3, G=3)


# The kernel's int32-slice version double-buffered its slices beside
# 41,220 bytes of static staging (its B_a = 8 instance): on a card with
# 232,448 bytes of opt-in shared memory per block, a slice of at most
# 95,614 bytes, so 23,903 table entries.  At G = 4 that is N_arr + 1 =
# 1,493.
_INT32_ENTRIES = (232448 - 41220) // 2 // 4


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n_arr1,dtype,lo,hi", [
    (_INT32_ENTRIES // 16, torch.int16, -300, 300),    # its largest slice
    (_INT32_ENTRIES // 16, torch.int8, -128, 128),
    (4 * _INT32_ENTRIES // 16, torch.int8, -128, 128),  # four times as many
])
def test_clustered_kernel_takes_every_int32_era_slice_and_4x_as_int8(
        cuda, n_arr1, dtype, lo, hi):
    gen = torch.Generator(device=cuda).manual_seed(n_arr1)
    n_tiles, n_clus, ms, dp, M, B_a, G = 2, 3, 24, 96, 150, 3, 4
    table = torch.randint(lo, hi, (n_clus, n_arr1, 16), generator=gen,
                          device=cuda).to(dtype)
    table[:, -1] = 0                                      # the zero row
    idx = torch.randint(0, n_arr1 - 1, (n_tiles, n_clus, ms, dp),
                        generator=gen, device=cuda).to(torch.int32)
    idx[:, :, ms - 5:] = n_arr1 - 1                       # padding steps
    codes = torch.randint(0, 16, (B_a, M, n_tiles * n_clus * ms),
                          generator=gen, device=cuda).to(torch.int8)
    got = tc.tlmac_gemm_clustered_multi(codes, idx, table, B_a=B_a, G=G)
    want = tc.tlmac_gemm_clustered_multi_plain(codes, idx, table, B_a=B_a,
                                               G=G)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# The reference's FUSED_SWEEP rows (tests/test_fused_autotune.py): (kg, M,
# B_a), kg ragged against the kernels' steps and M against their row
# blocks; widened here to every G and to D_p 5..192 (above 128 the tile
# runs as two column tiles).
FUSED_SWEEP = [(10, 7, 2), (12, 13, 3), (8, 37, 2), (12, 5, 3)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("G", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("kg,M,B_a", FUSED_SWEEP)
def test_fused_lookup_gemm_domain_on_card(cuda, kg, M, B_a, G):
    gen = torch.Generator(device=cuda).manual_seed(100 * G + kg + M)
    n_tiles, n_clus = 2, 3
    for dp in (5, 64, 128, 130, 192):
        for n_arr, rows in ((40, torch.int8), (300, torch.int16)):
            lim = 128 if rows == torch.int8 else 3000
            table = torch.randint(-lim, lim, (n_clus, n_arr, 2**G),
                                  generator=gen, device=cuda).to(rows)
            ex = torch.randint(0, n_arr, (n_tiles, kg, dp), generator=gen,
                               device=cuda).to(
                torch.uint8 if n_arr <= 256 else torch.int16)
            cl = torch.randint(0, n_clus, (n_tiles, kg), generator=gen,
                               device=cuda).to(torch.int8)
            a = torch.randint(0, 2**B_a, (M, kg * G), generator=gen,
                              device=cuda).to(torch.int8)
            for m in (M, 1, 64):
                am = a[:m] if m <= M else a.repeat(-(-m // M), 1)[:m]
                am = am.contiguous()
                n0 = tf.launches
                got = tf.tlmac_gemm_fused(am, ex, cl, table, B_a=B_a, G=G)
                want = tf.tlmac_gemm_fused_plain(am, ex, cl, table, B_a=B_a,
                                                 G=G)
                torch.cuda.synchronize()
                assert tf.launches == n0 + 1
                assert torch.equal(got, want), (dp, rows, m)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("M", [4, 17, 150])
@pytest.mark.parametrize("K,N,B_w,B_a,G,d_p", [(48, 128, 3, 3, 3, 64),
                                              (64, 240, 3, 3, 4, 120)])
def test_fused_lookup_gemm_on_compiled_plans_equals_plain_and_dense(
        cuda, M, K, N, B_w, B_a, G, d_p):
    w, plan, a = _compiled(K, N, M, B_w, B_a, G, d_p, K + M)
    n_tiles, kg = N // d_p, K // G
    idx_t = torch.uint8 if plan.N_arr <= 256 else torch.int16
    ex = torch.from_numpy(plan.exec_idx.reshape(n_tiles, kg, d_p)).to(
        cuda).to(idx_t)
    cl = torch.from_numpy(plan.step_cluster.reshape(n_tiles, kg)).to(
        cuda).to(torch.int8)
    table = torch.from_numpy(plan.table).to(cuda)
    a = a.to(cuda)
    n0 = tf.launches
    got = tf.tlmac_gemm_fused(a, ex, cl, tf.narrow_table(table), B_a=B_a, G=G)
    want = tf.tlmac_gemm_fused_plain(a, ex, cl, table, B_a=B_a, G=G)
    torch.cuda.synchronize()
    assert tf.launches == n0 + 1
    assert torch.equal(got, want)
    assert torch.equal(got, ops.dense_int_matmul(a, torch.from_numpy(w).to(
        cuda)))


@pytest.mark.requires_cuda
def test_serve_linear_of_tlmac_linear_runs_kernel_1_on_card(cuda):
    from repro_torch.configs import smoke_config
    from repro_torch.core.tlmac.api import TLMACLinear
    from repro_torch.models import nn

    rng = np.random.default_rng(0)
    K, N = 64, 128
    lin = TLMACLinear.from_weights(rng.normal(size=(K, N)) * 0.05, w_bits=3,
                                   a_bits=3, G=4, d_p=64, anneal_iters=100,
                                   device=cuda)
    p = lin.as_serve_params()
    assert p["table_narrow"].dtype == torch.int8
    x = torch.as_tensor(np.abs(rng.normal(size=(5, K))), dtype=torch.float32)
    cfg = smoke_config("codeqwen1.5-7b")
    n0 = tf.launches
    got = nn.serve_linear_apply(p, x.to(cuda).bfloat16(), cfg)
    torch.cuda.synchronize()
    assert tf.launches == n0 + 1
    want = nn.serve_linear_apply({k: v.cpu() for k, v in p.items()},
                                 x.bfloat16(), cfg)
    assert torch.equal(got.cpu(), want)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n_splits", [1, 5])
@pytest.mark.parametrize("kv", ["fp", "int8", "int4"])
def test_flash_decode_single_launch_equals_plain(cuda, kv, n_splits):
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import paged

    gen = torch.Generator(device=cuda).manual_seed(n_splits)
    B, KV, rep, hd, P, MB = 4, 4, 2, 128, 16, 8
    n_pages = B * MB + 1
    k, v = (torch.randn((n_pages, P, KV, hd), generator=gen, device=cuda)
            for _ in range(2))
    qs = paged.KVQuantSpec(kv)
    if kv == "fp":
        pools = dict(k_pages=k.bfloat16(), v_pages=v.bfloat16())
    else:
        (kc, ks), (vc, vs) = paged.quantise_kv(k, qs), paged.quantise_kv(v, qs)
        pools = dict(k_pages=kc, v_pages=vc, k_scales=ks, v_scales=vs)
    bt = (torch.randperm(n_pages - 1, generator=gen, device=cuda)[:B * MB]
          + 1).reshape(B, MB).to(torch.int32)
    bt[1] = 0                                        # an idle slot
    lengths = torch.tensor([100, 1, 128, 37], dtype=torch.int32, device=cuda)
    q = torch.randn((B, KV, rep, hd), generator=gen, device=cuda).bfloat16()
    kw = dict(pools, n_splits=n_splits, kv_dtype=kv)
    n0 = fd.launches
    got = fd.flash_decode(q, block_table=bt, lengths=lengths, **kw)
    want = fd.combine_splits(*fd.flash_decode_partials_plain(
        q, block_table=bt, lengths=lengths, **kw))
    torch.cuda.synchronize()
    assert fd.launches == n0 + 1
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# the serve loop's forward set as CUDA graphs
# ---------------------------------------------------------------------------


def _smoke_loop(cuda, **kw):
    from repro_torch.configs import smoke_config
    from repro_torch.models import lm
    from repro_torch.serve.paged import PagedServeLoop

    cfg = smoke_config("codeqwen1.5-7b")
    params = lm.init_lm(cfg, torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    return cfg, PagedServeLoop(params, cfg, batch_slots=2, s_max=48,
                               page_size=4, chunk=8, device=cuda,
                               check_invariants=True, **kw)


@pytest.mark.requires_cuda
def test_graph_replay_equals_eager_and_one_graph_per_forward_on_card(cuda):
    """Every forward of a mixed-length, shared-prefix run is replayed from
    the loop's CUDA graphs and also run eagerly on the same inputs: the
    logits are bit-equal, including chunks that start after a prefix hit.
    Afterwards one graph per forward exists, and the launch counters add
    up: launches recorded at capture x replays + eager launches."""
    from repro_torch.kernels import flash_decode as fd

    cfg, loop = _smoke_loop(cuda)
    rng = np.random.default_rng(3)
    system = rng.integers(0, cfg.vocab, 12).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(0, cfg.vocab, n)
                               .astype(np.int32)]) for n in (3, 7, 1, 10, 5)]
    prompts += [rng.integers(0, cfg.vocab, n).astype(np.int32)
                for n in (2, 19, 33)]
    checked = {"chunk": 0, "decode": 0, "hit_chunk": 0}

    def parity(kind, graph_fn, eager_fn):
        def wrapper(*a):
            got = graph_fn(*a).clone()
            want = eager_fn(*[torch.as_tensor(np.asarray(x, np.int32),
                                              device=cuda) for x in a])
            torch.cuda.synchronize()
            assert torch.equal(got, want), kind
            checked[kind] += 1
            if kind == "chunk" and int(a[1]) > 0 and loop.prefix.hit_blocks:
                checked["hit_chunk"] += 1
            return got
        return wrapper

    loop._prefill_chunk = parity("chunk", loop._prefill_chunk,
                                 loop._chunk_fn)
    loop._decode = parity("decode", loop._decode, loop._decode_fn)
    from repro_torch.serve.loop import Request

    for i, p in enumerate(prompts):
        loop.submit(Request(rid=i, prompt=p, max_new_tokens=4 + i % 3))
    k1, k2 = tf.launches, fd.launches
    done = loop.run()
    torch.cuda.synchronize()
    assert len(done) == len(prompts)
    assert loop.prefill_tokens_saved > 0 and checked["hit_chunk"] > 0
    loop.check_compiled()
    assert loop.compiled_shapes() == {"chunk": 1, "decode": 1}
    fw = loop.forwards
    assert fw["chunk"].replays == checked["chunk"]
    assert fw["decode"].replays == checked["decode"]
    # eager launches: the warm-ups and the parity runs (one per forward)
    n_eager = {k: f.eager + f.replays for k, f in fw.items()}
    want_k1 = 7 * cfg.n_layers * sum(f.eager + 2 * f.replays
                                     for f in fw.values())
    got_k1 = (tf.launches - k1 - sum(f.graph_launches["tlmac_gemm_fused"]
                                     for f in fw.values())
              + sum(f.graph_launches["tlmac_gemm_fused"] * f.replays
                    for f in fw.values()))
    assert got_k1 == want_k1, (got_k1, want_k1, n_eager)
    got_k2 = (fd.launches - k2 - fw["decode"].graph_launches["flash_decode"]
              + fw["decode"].graph_launches["flash_decode"]
              * fw["decode"].replays)
    assert got_k2 == cfg.n_layers * (fw["decode"].eager
                                     + 2 * fw["decode"].replays)
    loop.pages.check()


# ---------------------------------------------------------------------------
# speculation: kernel 1 at the verify window's M, the verify graph
# ---------------------------------------------------------------------------


@pytest.mark.requires_cuda
@pytest.mark.parametrize("K,N,dp", [(64, 128, 8), (128, 240, 120)])
def test_fused_lookup_gemm_at_verify_m_equals_plain_on_card(cuda, K, N, dp):
    """Kernel 1 at M = 20 (4 slots x a 5-token verify window, past the
    dp4a path's 16 rows) on narrow tables, int32-equal to its plain
    version."""
    gen = torch.Generator(device=cuda).manual_seed(K + N)
    G, B_a, n_arr = 4, 3, 600
    ex = torch.randint(0, n_arr, (N // dp, K // G, dp), generator=gen,
                       device=cuda).to(torch.int16)
    cl = torch.randint(0, 4, (N // dp, K // G), generator=gen,
                       device=cuda).to(torch.int8)
    table = tf.narrow_table(torch.randint(-8, 8, (4, n_arr, 2**G),
                                          dtype=torch.int32, generator=gen,
                                          device=cuda))
    a = torch.randint(0, 2**B_a, (20, K), generator=gen,
                      device=cuda).to(torch.int8)
    n0 = tf.launches
    got = tf.tlmac_gemm_fused(a, ex, cl, table, B_a=B_a, G=G)
    torch.cuda.synchronize()
    assert tf.launches == n0 + 1
    assert torch.equal(got, tf.tlmac_gemm_fused_plain(a, ex, cl, table,
                                                      B_a=B_a, G=G))


def _replay_drafter(streams, corrupt_p, vocab, seed):
    from repro_torch.serve.spec import Drafter

    class ReplayDrafter(Drafter):
        """``tests/test_spec_decode.py::ReplayDrafter``."""

        def __init__(self):
            self.rng = np.random.default_rng(seed)

        def propose(self, context, k):
            ctx = np.asarray(context, np.int64)
            for s in streams:
                if len(s) >= len(ctx) and np.array_equal(s[: len(ctx)], ctx):
                    d = s[len(ctx): len(ctx) + k].astype(np.int32)
                    flip = self.rng.random(len(d)) < corrupt_p
                    return np.where(flip, (d + 1) % vocab, d)
            return np.zeros(0, np.int32)

    return ReplayDrafter()


@pytest.mark.requires_cuda
def test_verify_graph_replay_equals_eager_on_card(cuda):
    """The verify forward's CUDA graph replays bit-equal to the eager
    verify forward (a padded row and an idle slot included), and the
    speculative loop's three forwards are one graph each."""
    cfg, loop = _smoke_loop(cuda, spec_k=3,
                            drafter=_replay_drafter([], 0.0, 1, 0))
    rng = np.random.default_rng(5)
    MB = loop.spec.max_blocks
    bt = (np.arange(2 * MB, dtype=np.int32).reshape(2, MB) + 1) \
        % (loop.spec.n_pages - 1) + 1
    for pos, nw in (([9, 0], [4, 0]), ([30, 5], [2, 4])):
        toks = rng.integers(0, cfg.vocab, (2, 4)).astype(np.int32)
        args = (toks, np.array(pos, np.int32), np.array(nw, np.int32), bt)
        got = loop._verify(*args).clone()
        want = loop._verify_fn(*[torch.as_tensor(x, device=cuda)
                                 for x in args])
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert loop.compiled_shapes()["verify"] == 1
    assert loop.forwards["verify"].graph_launches["flash_decode"] == 0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("corrupt_p", [0.0, 0.4, 1.0])
def test_spec_loop_gives_spec_off_tokens_on_card(cuda, corrupt_p):
    """On the smoke config, a speculative run with the replay drafter over
    the spec-off ('lax') run's tokens T emits T, with decode and verify
    replayed from graphs and no flash-decode launch."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.serve.loop import Request

    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, n).astype(np.int32)   # smoke vocab
               for n in (6, 11, 3, 9)]
    cfg, off = _smoke_loop(cuda, attn_impl="lax")
    for i, p in enumerate(prompts):
        off.submit(Request(rid=i, prompt=p, max_new_tokens=6 + i))
    want = {r.rid: r.output.tolist() for r in off.run()}
    streams = [np.concatenate([p, want[i]]).astype(np.int64)
               for i, p in enumerate(prompts)]
    _, on = _smoke_loop(cuda, spec_k=3, drafter=_replay_drafter(
        streams, corrupt_p, cfg.vocab, 2))
    for i, p in enumerate(prompts):
        on.submit(Request(rid=i, prompt=p, max_new_tokens=6 + i))
    k2 = fd.launches
    got = {r.rid: r.output.tolist() for r in on.run()}
    torch.cuda.synchronize()
    assert got == want
    assert fd.launches == k2
    assert on.spec_steps > 0 and on.forwards["verify"].replays > 0
    on.check_compiled()
    on.pages.check()


@pytest.mark.requires_cuda
def test_swap_restores_in_place_and_the_graphs_read_them_on_card(cuda):
    """Swap pinned on, in a pool that preempts: every restored page's
    bytes on the card carry the host page's CRC-32 seal, and the run ends
    with nothing leaked.  Then new bytes scattered into a page with
    ``cache_swap_in`` change the captured decode graph's logits exactly as
    they change the eager decode's: the scatter writes the pool the
    graphs hold, in place."""
    from repro_torch.models import lm
    from repro_torch.serve.faults import tree_leaves, tree_map
    from repro_torch.serve.loop import Request
    from repro_torch.serve.swap import host_array, page_checksum

    cfg, loop = _smoke_loop(cuda, swap=True, swap_policy="always", n_pages=9)
    restore, restored = loop._swap_restore, []

    def checked(host_pages, dest):
        restore(host_pages, dest)
        for hp, d in zip(host_pages, dest):
            got = tree_map(lambda leaf: host_array(leaf[:, int(d)].cpu()),
                           loop.caches)
            assert page_checksum(got) == hp.checksum
            restored.append(int(d))
    loop._swap_restore = checked
    rng = np.random.default_rng(11)
    for i, (n, mn) in enumerate(((9, 12), (10, 11), (7, 10), (12, 9))):
        loop.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab, n)
                            .astype(np.int32), max_new_tokens=mn))
    assert len(loop.run()) == 4
    assert loop.preemptions > 0 and restored
    loop.check_compiled()
    loop.prefix.evict(10**6)
    assert loop.pages.in_use == 0
    loop.swap.check()

    MB = loop.spec.max_blocks
    bt = np.zeros((loop.B, MB), np.int32)
    bt[0, :3] = [1, 2, 3]
    args = (np.array([[5], [0]], np.int32), np.array([9, 0], np.int32), bt)
    outs = []
    for seed in (1, 2):
        gen = torch.Generator(device=cuda).manual_seed(seed)
        staged = tree_map(lambda leaf: torch.randn(
            leaf[:, :1].shape, device=cuda, generator=gen).to(leaf.dtype),
            loop.caches)
        ptrs = [t.data_ptr() for t in tree_leaves(loop.caches)]
        lm.cache_swap_in(loop.caches, staged, torch.tensor([2], device=cuda))
        assert ptrs == [t.data_ptr() for t in tree_leaves(loop.caches)]
        got = loop._decode(*args).clone()
        want = loop._decode_fn(*[torch.as_tensor(x, device=cuda)
                                 for x in args])
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        outs.append(got)
    assert not torch.equal(outs[0], outs[1])


# ---------------------------------------------------------------------------
# the dense families: kernel 2 at their shapes, the int8 layout, the window
# ---------------------------------------------------------------------------


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kv", ["fp", "int8"])
@pytest.mark.parametrize("rep,hd,window,P,MB", [
    (8, 128, None, 16, 64),     # command-r / internvl2: 64 heads over 8
    (1, 64, None, 16, 64),      # minicpm: hd 64, MHA
    (1, 128, 2048, 16, 256),    # the window family: 2048 of up to 4096
])
def test_flash_decode_at_the_families_shapes_equals_plain(cuda, kv, rep, hd,
                                                          window, P, MB):
    """One launch against the plain version at the new families' decode
    shapes; with the window, slots past it (3000, 2300), one inside it
    (100) and an idle slot."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import paged

    gen = torch.Generator(device=cuda).manual_seed(rep * hd)
    B, KV = 4, 8 if rep == 8 else 4
    n_pages = B * MB + 1
    k, v = (torch.randn((n_pages, P, KV, hd), generator=gen, device=cuda)
            for _ in range(2))
    qs = paged.KVQuantSpec(kv)
    if kv == "fp":
        pools = dict(k_pages=k.bfloat16(), v_pages=v.bfloat16())
    else:
        (kc, ks), (vc, vs) = paged.quantise_kv(k, qs), paged.quantise_kv(v, qs)
        pools = dict(k_pages=kc, v_pages=vc, k_scales=ks, v_scales=vs)
    bt = (torch.randperm(n_pages - 1, generator=gen, device=cuda)[:B * MB]
          + 1).reshape(B, MB).to(torch.int32)
    bt[2] = 0
    S = MB * P
    lengths = torch.tensor([min(3000, S), min(2300, S - 7), 1, 100],
                           dtype=torch.int32, device=cuda)
    q = torch.randn((B, KV, rep, hd), generator=gen, device=cuda).bfloat16()
    kw = dict(pools, n_splits=4, kv_dtype=kv, window=window)
    n0 = fd.launches
    got = fd.flash_decode(q, block_table=bt, lengths=lengths, **kw)
    want = fd.combine_splits(*fd.flash_decode_partials_plain(
        q, block_table=bt, lengths=lengths, **kw))
    torch.cuda.synchronize()
    assert fd.launches == n0 + 1
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("M", [1, 4, 16, 17, 64])
def test_int8_layout_equals_the_cpu_product_on_card(cuda, M):
    """The int8 serve linear on the card (``torch._int_mm``, rows padded
    past 16) against the same linear on the CPU (exact int32): equal; a
    ragged one (K 250, N 130: ``w8`` zero-padded to multiples of 8 where
    the params are made) too."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import nn

    cfg = dataclasses.replace(smoke_config("codeqwen1.5-7b"),
                              serve_impl="int8")
    gen = torch.Generator().manual_seed(M)
    p = nn.init_serve_linear(gen, 256, 136, cfg, use_bias=True, device="cpu")
    p["a_step"] = torch.tensor(1.0 / 32)
    p["w_step"] = torch.rand(136, generator=gen) * 1e-3
    x = torch.randn((M, 256), generator=gen).bfloat16() * 3
    want = nn.serve_linear_apply(p, x, cfg, use_bias=True)
    aq = torch.clamp(torch.round(x.float() / 0.03125), -127, 127).to(torch.int8)
    yi = nn.int8_matmul(aq.to(cuda), p["w8"].to(cuda))
    assert torch.equal(yi.cpu(), nn.int8_matmul(aq, p["w8"]))
    got = nn.serve_linear_apply({k: t.to(cuda) for k, t in p.items()},
                                x.to(cuda), cfg, use_bias=True)
    assert torch.equal(got.cpu(), want)
    pr = nn.init_serve_linear(gen, 250, 130, cfg, device="cpu")
    assert tuple(pr["w8"].shape) == (256, 136)
    xr = torch.randn((M, 250), generator=gen).bfloat16() * 3
    got = nn.serve_linear_apply({k: t.to(cuda) for k, t in pr.items()},
                                xr.to(cuda), cfg)
    assert torch.equal(got.cpu(), nn.serve_linear_apply(pr, xr, cfg))


@pytest.mark.requires_cuda
def test_window_decode_graph_reads_pages_past_the_window_on_card(cuda):
    """A sliding-window family (``attn_local``, window 8) served with its
    decode step replayed from a CUDA graph: replay equals eager bit for
    bit on slots whose history runs past the window, and the flash reader
    stays within the kernel tolerance of the gathered one."""
    from repro_torch.configs import smoke_config
    from repro_torch.kernels import paged
    from repro_torch.models import lm
    from repro_torch.serve.loop import Request
    from repro_torch.serve.paged import PagedServeLoop

    cfg = dataclasses.replace(smoke_config("codeqwen1.5-7b"), family="hybrid",
                              block_pattern=("attn_local",), local_window=8)
    params = lm.init_lm(cfg, torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    loop = PagedServeLoop(params, cfg, batch_slots=2, s_max=48, page_size=4,
                          chunk=8, device=cuda, check_invariants=True)
    seen = []

    def parity(graph_fn, eager_fn):
        def wrapper(*a):
            got = graph_fn(*a).clone()
            args = [torch.as_tensor(np.asarray(x, np.int32), device=cuda)
                    for x in a]
            want = eager_fn(*args)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
            seen.append(int(np.max(a[1])))
            return got
        return wrapper

    loop._decode = parity(loop._decode, loop._decode_fn)
    rng = np.random.default_rng(0)
    for i, n in enumerate((19, 5, 30)):
        loop.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab, n)
                            .astype(np.int32), max_new_tokens=6))
    assert len(loop.run()) == 3
    assert max(seen) >= 3 * cfg.local_window
    assert loop.compiled_shapes() == {"chunk": 1, "decode": 1}
    # the two readers on one state past the window
    spec = paged.spec_for(48, 2, page_size=4)
    caches = lm.init_caches(cfg, spec, device=cuda)
    for leaf in caches[0]["b0"].values():
        leaf.copy_(torch.randn(leaf.shape, device=cuda).to(leaf.dtype))
    bt = torch.arange(1, 25, device=cuda, dtype=torch.int32).reshape(2, 12)
    pos = torch.tensor([40, 17], dtype=torch.int32, device=cuda)
    cur = torch.tensor([[3], [9]], dtype=torch.int32, device=cuda)
    out = {}
    for impl in ("lax", "flash"):
        c = [{b: {n: t.clone() for n, t in p.items()} for b, p in s.items()}
             for s in caches]
        out[impl] = lm.decode_step_paged(
            params, c, cur, pos, bt,
            dataclasses.replace(cfg, serve_paged_attn_impl=impl))[0].float()
    scale = out["lax"].abs().max()
    assert (out["lax"] - out["flash"]).abs().max() <= 2e-2 * scale


# ---------------------------------------------------------------------------
# kernel 1's expert axis, kernel 2 at ragged head dims, the MoE family
# ---------------------------------------------------------------------------


def _expert_stack(gen, cuda, E, M, K, N, dp, n_arr, n_clus, G, B_a):
    idx_t = torch.uint8 if n_arr <= 256 else torch.int16
    a = torch.randint(0, 2**B_a, (E, M, K), generator=gen,
                      device=cuda).to(torch.int8)
    idx = torch.randint(0, n_arr, (E, N // dp, K // G, dp), generator=gen,
                        device=cuda).to(idx_t)
    cl = torch.randint(0, n_clus, (E, N // dp, K // G), generator=gen,
                       device=cuda).to(torch.int8)
    tab = tf.narrow_table(torch.randint(-8, 8, (E, n_clus, n_arr, 2**G),
                                        generator=gen, device=cuda))
    return a, idx, cl, tab


@pytest.mark.requires_cuda
@pytest.mark.parametrize("M", [1, 2, 4, 17, 70])
@pytest.mark.parametrize("E,K,N,dp,n_arr,G", [
    (8, 64, 32, 2, 128, 4),        # the moe-gqa smoke's expert wi/wg
    (8, 32, 64, 4, 128, 4),        # ... and wo
    (5, 96, 260, 130, 300, 3),     # int16 indices, two column tiles, G 3
    (3, 4112, 256, 128, 64, 4),    # kg past one slice: split and summed
])
def test_fused_lookup_gemm_expert_axis_on_card(cuda, E, K, N, dp, n_arr, G,
                                               M):
    """One launch over E experts equals the plain version's loop and E
    single launches, int32 for int32; the expert launch counts once."""
    gen = torch.Generator(device=cuda).manual_seed(E * M + K)
    a, idx, cl, tab = _expert_stack(gen, cuda, E, M, K, N, dp, n_arr, 3, G, 3)
    n0, e0 = tf.launches, tf.expert_launches
    got = tf.tlmac_gemm_fused(a, idx, cl, tab, B_a=3, G=G)
    torch.cuda.synchronize()
    assert (tf.launches, tf.expert_launches) == (n0 + 1, e0 + 1)
    assert got.shape == (E, M, N)
    assert torch.equal(got, tf.tlmac_gemm_fused_plain(a, idx, cl, tab,
                                                      B_a=3, G=G))
    for e in range(E):
        assert torch.equal(got[e], tf.tlmac_gemm_fused(
            a[e], idx[e], cl[e], tab[e], B_a=3, G=G)), e


# (E, M, K, N): the 16-byte path (N % 16, K % 4), ragged N, ragged K, a
# K past the 2048-byte staging chunk, M past the 4-row block
INT8_EXPERT_SHAPES = [(3, 4, 64, 256), (2, 5, 100, 36), (4, 9, 7, 300),
                      (5, 3, 4100, 520), (2, 1, 33, 17), (8, 2, 256, 64)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("E,M,K,N", INT8_EXPERT_SHAPES)
def test_int8_experts_kernel_equals_twin_on_card(cuda, E, M, K, N):
    """One launch of the expert-stacked int8 kernel equals its plain twin
    (each expert's exact f64 product) int32 for int32, and the per-expert
    ``torch._int_mm`` loop where K and N are multiples of 8."""
    from repro_torch.kernels import int8_experts as I8

    gen = torch.Generator(device=cuda).manual_seed(E * K + N)
    a = torch.randint(-127, 128, (E, M, K), generator=gen, device=cuda,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (E, K, N), generator=gen, device=cuda,
                      dtype=torch.int8)
    n0 = I8.launches
    got = I8.int8_experts_matmul(a, w)
    torch.cuda.synchronize()
    assert I8.launches == n0 + 1 and got.shape == (E, M, N)
    want = I8.int8_experts_matmul_plain(a, w)
    assert torch.equal(got, want)
    if K % 8 == 0 and N % 8 == 0:
        assert torch.equal(I8.int8_experts_loop(a, w), want)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("K,N", [(64, 32), (100, 36)])
def test_int8_expert_linears_run_one_launch_on_card(cuda, K, N):
    """The int8 layout's expert stack runs through one launch of the int8
    expert kernel on the card and equals the same params' CPU forward (the
    plain batched int32 product) bit for bit."""
    from repro_torch.configs import smoke_config
    from repro_torch.kernels import int8_experts as I8
    from repro_torch.models import nn

    cfg = dataclasses.replace(smoke_config("deepseek-v3-671b"),
                              attn_kind="gqa", serve_impl="int8")
    p = nn.init_serve_linear(torch.Generator(device=cuda).manual_seed(0), K,
                             N, cfg, device=cuda, expert=8)
    p["a_step"].fill_(1 / 32)
    gen = torch.Generator(device=cuda).manual_seed(1)
    xe = torch.randn((2, 8, 3, K), generator=gen, device=cuda).bfloat16()
    n0 = I8.launches
    got = nn.serve_expert_linear_apply(p, xe, cfg)
    torch.cuda.synchronize()
    assert I8.launches == n0 + 1 and got.shape == (2, 8, 3, N)
    want = nn.serve_expert_linear_apply(
        {k: v.cpu() for k, v in p.items()}, xe.cpu(), cfg)
    assert torch.equal(got.cpu(), want)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("M", [1, 4, 17, 64])
def test_ragged_int8_linear_on_card(cuda, M):
    """A K = 100, N = 36 int8 serve linear (``w8`` zero-padded to 104 x 40
    where the params are made) on the card equals the plain int32
    product of the unpadded weight."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import nn

    cfg = dataclasses.replace(smoke_config("codeqwen1.5-7b"),
                              serve_impl="int8")
    K, N = 100, 36
    gen = torch.Generator(device=cuda).manual_seed(M)
    p = nn.init_serve_linear(gen, K, N, cfg, device=cuda)
    assert tuple(p["w8"].shape) == (104, 40)
    x = (torch.randn((M, K), generator=gen, device=cuda) * 2).bfloat16()
    aq = torch.clamp(torch.round(x.float() / p["a_step"]), -127, 127)
    yi = torch.matmul(aq.double(), p["w8"][:K, :N].double()).to(torch.int32)
    want = (yi.float() * (p["a_step"] * p["w_step"])).bfloat16()
    assert torch.equal(nn.serve_linear_apply(p, x, cfg), want)


@pytest.mark.requires_cuda
def test_auto_tuned_main_path_shape_equals_ref_on_card(cuda, tmp_path,
                                                       monkeypatch):
    """A codeqwen1.5-7b decode linear shape (M 4, 4096 -> 4096) tuned on
    the card between kernel 1 and kernels 4 + 3: the winner is recorded
    under a ``cuda`` key and ``'auto'`` then dispatches it, int32-equal
    to ``'ref'``; a capture refuses to tune."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import autotune as at
    from repro_torch.models import nn

    monkeypatch.setenv(at.CACHE_ENV, str(tmp_path / "at.json"))
    at.reset_cache()
    try:
        cfg = get_config("codeqwen1.5-7b")
        gen = torch.Generator(device=cuda).manual_seed(0)
        p = nn.init_serve_linear(gen, 4096, 4096, cfg, device=cuda)
        a = torch.randint(0, 8, (4, 4096), generator=gen, device=cuda,
                          dtype=torch.int8)
        args = (a, p["table_narrow"], p["exec_idx"], p["step_cluster"])
        kw = dict(B_a=3, G=4, N=4096)
        conf = at.tune(*args, **kw, reps=3)
        assert conf["impl"] in ("fused", "pallas")
        key = at.shape_key(4, 4096, 4096, B_a=3, G=4, D_p=128,
                           R=int(np.prod(p["table_narrow"].shape[:-1])),
                           device=cuda)
        assert key.split("|")[1] == "cuda" and at.lookup(key) == conf
        want = ops.tlmac_matmul(*args, **kw, impl="ref")
        assert torch.equal(ops.tlmac_matmul(*args, **kw, impl="auto"), want)
        graph = torch.cuda.CUDAGraph()
        with pytest.raises(RuntimeError, match="capture"):
            with torch.cuda.graph(graph):
                at.tune(*args, **kw, reps=1)
    finally:
        at.reset_cache()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("hd", [18, 36, 56, 100, 200])
@pytest.mark.parametrize("kv", ["fp", "int8", "int4"])
def test_flash_decode_at_ragged_head_dims_equals_plain(cuda, kv, hd):
    """Head dims off the 8-element lane pieces (18, 36, 100) and on them
    (56, 200), on every pool kind, GQA rep 4 and MHA, 1 and 4 splits:
    within the kernel tolerance of the plain version."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import paged

    gen = torch.Generator(device=cuda).manual_seed(hd)
    B, KV, P, MB = 3, 2, 8, 12
    n_pages = B * MB + 1
    k, v = (torch.randn((n_pages, P, KV, hd), generator=gen, device=cuda)
            for _ in range(2))
    qs = paged.KVQuantSpec(kv)
    if kv == "fp":
        pools = dict(k_pages=k.bfloat16(), v_pages=v.bfloat16())
    else:
        (kc, ks), (vc, vs) = paged.quantise_kv(k, qs), paged.quantise_kv(v, qs)
        pools = dict(k_pages=kc, v_pages=vc, k_scales=ks, v_scales=vs)
    bt = (torch.randperm(n_pages - 1, generator=gen, device=cuda)[:B * MB]
          + 1).reshape(B, MB).to(torch.int32)
    lengths = torch.tensor([77, 1, 96], dtype=torch.int32, device=cuda)
    for rep, n_splits in ((4, 4), (1, 1)):
        q = torch.randn((B, KV, rep, hd), generator=gen,
                        device=cuda).bfloat16()
        kw = dict(pools, n_splits=n_splits, kv_dtype=kv)
        n0 = fd.launches
        got = fd.flash_decode(q, block_table=bt, lengths=lengths, **kw)
        want = fd.combine_splits(*fd.flash_decode_partials_plain(
            q, block_table=bt, lengths=lengths, **kw))
        torch.cuda.synchronize()
        assert fd.launches == n0 + 1
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.requires_cuda
def test_moe_smoke_served_through_both_kernels_on_card(cuda):
    """The moe-gqa smoke (deepseek's config with GQA) served with CUDA
    graphs: every request finishes, one graph per forward, kernel 1's
    expert axis launched three times per MoE layer per forward (recorded
    at capture), and the card's decode logits within 3% of scale of the
    CPU's on the same state."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import lm
    from repro_torch.serve.loop import Request
    from repro_torch.serve.paged import PagedServeLoop

    cfg = dataclasses.replace(smoke_config("deepseek-v3-671b"),
                              attn_kind="gqa")
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    on_card = copy.deepcopy(params).to(cuda)
    loop = PagedServeLoop(on_card, cfg, batch_slots=2, s_max=48,
                          page_size=8, chunk=8, device=cuda)
    rng = np.random.default_rng(0)
    for i, n in enumerate((6, 11, 3)):
        loop.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab, n)
                            .astype(np.int32), max_new_tokens=5))
    assert len(loop.run()) == 3
    assert loop.compiled_shapes() == {"chunk": 1, "decode": 1}
    n_moe = cfg.n_layers - cfg.moe_layer_start
    for f in loop.forwards.values():
        assert f.graph_launches["tlmac_gemm_fused_expert"] == 3 * n_moe
    spec_cpu = lm.init_caches(cfg, loop.spec, device="cpu")
    bt = torch.arange(1, 13, dtype=torch.int32).reshape(2, 6)
    pos = torch.tensor([9, 4], dtype=torch.int32)
    cur = torch.tensor([[3], [7]], dtype=torch.int32)
    want, _ = lm.decode_step_paged(params, spec_cpu, cur, pos, bt, cfg)
    caches = lm.init_caches(cfg, loop.spec, device=cuda)
    got, _ = lm.decode_step_paged(on_card, caches, cur.to(cuda),
                                  pos.to(cuda), bt.to(cuda), cfg)
    scale = want.float().abs().max()
    assert (got.float().cpu() - want.float()).abs().max() <= 3e-2 * scale
