"""The CUDA kernels against their plain versions on the card: kernels 3-6
(the compile-and-execute path) and kernel 1 on plans compiled by the
port, kernel 1 through ``TLMACLinear``'s serve params, and kernel 2's
single launch over every pool kind.  This file imports nothing of JAX,
so it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest -m requires_cuda tests/test_torch_cuda.py

Every test needs a CUDA device and skips without one (the hand kernels
have no CPU mode)."""

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


@pytest.mark.requires_cuda
def test_clustered_kernel_rejects_a_slice_too_large_for_shared_memory(cuda):
    # a G=6 plan at N_arr = 4096 has a 262 KB table slice even as int8
    n_clus, n_arr1, ms, dp = 4, 4097, 8, 64
    codes = torch.zeros((3, 5, n_clus * ms), dtype=torch.int8, device=cuda)
    idx = torch.zeros((n_clus, ms, dp), dtype=torch.int32, device=cuda)
    table = torch.zeros((n_clus, n_arr1, 64), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="shared"):
        tc.tlmac_gemm_clustered(codes, idx, table, B_a=3, G=6)


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


# (K, N, B_w, B_a, G, d_p): G 2-6, B_a 1-8, D_p 32/120/192, 1 to 8 tiles;
# D_p 30 (idx rows copied 4 bytes at a time) and 5 (odd: scalar stores)
CLUSTERED_CARD = [(16, 64, 2, 1, 2, 32), (24, 96, 3, 2, 3, 32),
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
