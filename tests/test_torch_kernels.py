"""Port kernels vs the JAX reference, on the CPU, with the same numpy
inputs on both sides: the lookup GEMM and the KV codec bit-exact, the
paged flash-decode within a stated f32 tolerance.  ``requires_cuda``
variants hold each CUDA kernel against its plain version on the card
(they skip without one)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.kernels import paged as jpaged
from repro.kernels import ref as jref
from repro.kernels.flash_decode import flash_decode as jflash
from repro.kernels.tlmac_fused import tlmac_matmul_fused as jfused

from repro_torch.convert import to_torch
from repro_torch.kernels import paged as tpaged
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tlmac_fused as tfused
from repro_torch.kernels.flash_decode import flash_decode as tflash
from repro_torch.kernels.flash_decode import combine_splits
from repro_torch.kernels.flash_decode import flash_decode_partials_plain
from repro_torch.kernels.ops import tlmac_matmul

# f32 flash-decode tolerance: the port and JAX sum the softmax terms in
# different orders (and exp may differ in the last ulp); values are O(1)
FLASH_ATOL = 2e-5
B_A, G = 3, 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand kernels have no CPU mode)")
    return torch.device("cuda")


def _plan(rng, dp, kg, n_tiles, n_arr, idx_dtype, M):
    a = rng.integers(0, 2**B_A, (M, kg * G)).astype(np.int8)
    table = rng.integers(-8, 8, (4, n_arr, 2**G)).astype(np.int32)
    idx = rng.integers(0, n_arr, (n_tiles, kg, dp)).astype(idx_dtype)
    cl = rng.integers(0, 4, (n_tiles, kg)).astype(np.int8)
    return a, table, idx, cl


# (dp, kg, n_arr, idx dtype, M): dp 4 / 120 / 128, uint8 and int16
# indices, kg ragged against the JAX block (bk=8) and the CUDA tile (32)
GEMM_CASES = [
    (4, 16, 256, np.uint8, 1),
    (120, 20, 512, np.int16, 8),
    (128, 16, 512, np.int16, 64),
    (128, 20, 256, np.uint8, 8),
]


@pytest.mark.parametrize("dp,kg,n_arr,idx_dtype,M", GEMM_CASES)
def test_lookup_gemm_bitexact_vs_jax_ref_and_fused(dp, kg, n_arr, idx_dtype, M):
    rng = np.random.default_rng(dp + kg + M)
    n_tiles = 2
    N = n_tiles * dp
    a, table, idx, cl = _plan(rng, dp, kg, n_tiles, n_arr, idx_dtype, M)
    j_idx = jnp.asarray(idx.reshape(-1, dp).astype(np.int32))
    j_cl = jnp.asarray(cl.reshape(-1).astype(np.int32))
    want_ref = np.asarray(jref.tlmac_matmul_ref(
        jnp.asarray(a), jnp.asarray(table), j_idx, j_cl, B_A, G, N))
    want_fused = np.asarray(jfused(
        jnp.asarray(a), jnp.asarray(table), j_idx, j_cl, B_a=B_A, G=G, N=N,
        bk=8, interpret=True))
    assert np.array_equal(want_ref, want_fused)
    got = tfused.tlmac_gemm_fused(torch.from_numpy(a), torch.from_numpy(idx),
                                  torch.from_numpy(cl), torch.from_numpy(table),
                                  B_a=B_A, G=G)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want_ref)
    ref = tlmac_matmul(torch.from_numpy(a), torch.from_numpy(table),
                       torch.from_numpy(idx), torch.from_numpy(cl),
                       B_a=B_A, G=G, N=N, impl="ref")
    assert torch.equal(ref, got)


@pytest.mark.parametrize("lo,hi,want", [
    (-8, 8, torch.int8), (-128, 128, torch.int8), (-128, 129, torch.int16),
    (-129, 5, torch.int16), (-32768, 32768, torch.int16)])
def test_narrow_table_keeps_every_value_and_picks_int16_exactly_when_needed(
        lo, hi, want):
    rng = np.random.default_rng(hi - lo)
    t = rng.integers(lo, hi, (3, 50, 16)).astype(np.int32)
    t[0, 0, 0], t[-1, -1, -1] = lo, hi - 1           # both ends present
    got = tfused.narrow_table(torch.from_numpy(t))
    assert got.dtype == want and got.is_contiguous()
    assert np.array_equal(got.to(torch.int32).numpy(), t)
    assert tfused.narrow_table(got) is got       # already narrow: kept


def test_narrow_table_refuses_what_leaves_int16():
    t = torch.zeros((2, 4, 16), dtype=torch.int32)
    t[1, 2, 3] = 40000
    with pytest.raises(ValueError, match="int16"):
        tfused.narrow_table(t)
    with pytest.raises(ValueError, match="integer"):
        tfused.narrow_table(t.float())


# (G, B_a, dp, kg, n_arr, idx dtype, M, table range): the one-hot form on
# seeded plans, G 3 and 4, B_a up to 8 (coefficients up to 255), int8 and
# int16 rows
ONEHOT_CASES = [
    (4, 3, 128, 16, 512, np.int16, 4, (-8, 8)),
    (4, 8, 120, 20, 256, np.uint8, 17, (-8, 8)),
    (3, 3, 64, 37, 300, np.int16, 64, (-12, 10)),
    (3, 4, 5, 9, 100, np.uint8, 1, (-300, 300)),
    (2, 2, 4, 16, 64, np.uint8, 3, (-4, 4)),
    (1, 3, 8, 24, 16, np.uint8, 5, (-2, 2)),
]


@pytest.mark.parametrize("G_,B_a,dp,kg,n_arr,idx_dtype,M,rng_", ONEHOT_CASES)
def test_onehot_form_equals_both_lookup_refs(G_, B_a, dp, kg, n_arr, idx_dtype,
                                              M, rng_):
    """The kernel's algebra (one-hot coefficients times gathered narrow
    rows, the library yardstick's function) is int32-equal to the port's
    and to the JAX package's lookup oracle."""
    rng = np.random.default_rng(G_ * 1000 + dp + kg + M)
    n_tiles = 2
    N = n_tiles * dp
    a = rng.integers(0, 2**B_a, (M, kg * G_)).astype(np.uint8).view(np.int8)
    table = rng.integers(*rng_, (3, n_arr, 2**G_)).astype(np.int32)
    idx = rng.integers(0, n_arr, (n_tiles, kg, dp)).astype(idx_dtype)
    cl = rng.integers(0, 3, (n_tiles, kg)).astype(np.int8)
    want = np.asarray(jref.tlmac_matmul_ref(
        jnp.asarray(a), jnp.asarray(table),
        jnp.asarray(idx.reshape(-1, dp).astype(np.int32)),
        jnp.asarray(cl.reshape(-1).astype(np.int32)), B_a, G_, N))
    ta, tt, ti, tc = map(torch.from_numpy, (a, table, idx, cl))
    narrow = tfused.narrow_table(tt)
    ref = tref.tlmac_matmul_ref(ta, tt, ti, tc, B_a, G_, N)
    assert np.array_equal(ref.numpy(), want)
    coef = tfused.onehot_coefficients(ta, B_a, G_)
    assert coef.shape == (M, kg, 2**G_)
    assert int(coef.min()) >= 0 and int(coef.max()) <= 2**B_a - 1
    assert torch.equal(coef.sum(-1), torch.full((M, kg), 2**B_a - 1,
                                                dtype=torch.int32))
    for tab in (tt, narrow):
        got = tfused.tlmac_gemm_onehot_plain(ta, ti, tc, tab, B_a=B_a, G=G_)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
        assert torch.equal(tfused.tlmac_gemm_fused(ta, ti, tc, tab, B_a=B_a,
                                                   G=G_), ref)
    w = tfused.gathered_rows(ti, tc, narrow)
    assert w.dtype == narrow.dtype and w.shape == (kg * 2**G_, N)


def test_pack_bitplanes_bitexact_vs_jax():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 8, (5, 24)).astype(np.int8)
    want = np.asarray(jref.pack_bitplanes_ref(jnp.asarray(a), B_A, G))
    got = tref.pack_bitplanes_ref(torch.from_numpy(a), B_A, G)
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), want)


def test_lookup_gemm_wrapper_rejects_what_the_kernel_does_not_take():
    rng = np.random.default_rng(1)
    a, table, idx, cl = (torch.from_numpy(x) for x in
                         _plan(rng, 4, 16, 2, 256, np.uint8, 2))
    kw = dict(B_a=B_A, G=G)
    with pytest.raises(ValueError, match="int8"):
        tfused.tlmac_gemm_fused(a.to(torch.int32), idx, cl, table, **kw)
    with pytest.raises(ValueError, match="exec_idx"):
        tfused.tlmac_gemm_fused(a, idx.to(torch.int32), cl, table, **kw)
    with pytest.raises(ValueError, match="step_cluster"):
        tfused.tlmac_gemm_fused(a, idx, cl[:1], table, **kw)
    with pytest.raises(ValueError, match="K="):
        tfused.tlmac_gemm_fused(a[:, :-4], idx, cl, table, **kw)
    meta = [t.to("meta") for t in (a, idx, cl, table)]
    with pytest.raises(ValueError, match="device"):
        tfused.tlmac_gemm_fused(*meta, **kw)


# ---------------------------------------------------------------------------
# KV codec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["int8", "int4"])
@pytest.mark.parametrize("hd", [16, 128])
@pytest.mark.parametrize("src", ["f32", "bf16"])
def test_kv_codec_bitexact_vs_jax(dtype, hd, src):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((3, 5, 2, hd)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0                                  # all-zero vector: scale 1
    jx = jnp.asarray(x, jnp.bfloat16 if src == "bf16" else jnp.float32)
    jq = jpaged.KVQuantSpec(dtype)
    jc, js = jpaged.quantise_kv(jx, jq)
    tq = tpaged.KVQuantSpec(dtype)
    tc, ts = tpaged.quantise_kv(to_torch(np.asarray(jx), "cpu"), tq)
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert ts.dtype == torch.bfloat16
    assert np.array_equal(ts.view(torch.int16).numpy(),
                          np.asarray(js).view(np.int16))
    want = np.asarray(jpaged.dequantise_kv(jc, js, jq))
    got = tpaged.dequantise_kv(tc, ts, tq)
    assert np.array_equal(got.numpy(), want)


def test_int4_probe_matches_jax_rounding():
    """The reference rounds the int4 scale to bf16 before dividing, so
    -amax lands on code -7, not -8; the port copies that."""
    x = np.array([1.0, -2.0, 0.5, -0.25], np.float32)
    tc, ts = tpaged.quantise_kv(torch.from_numpy(x), tpaged.KVQuantSpec("int4"))
    codes = tpaged.unpack_int4(tc).numpy()
    assert codes.tolist() == [4, -7, 2, -1]
    assert abs(ts.float().item() - 0.267578) < 1e-6
    jc, js = jpaged.quantise_kv(jnp.asarray(x), jpaged.KVQuantSpec("int4"))
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert float(np.asarray(js, np.float32)) == ts.float().item()


def test_int4_pack_unpack_exhaustive_vs_jax():
    lo, hi = np.meshgrid(np.arange(-8, 8), np.arange(-8, 8))
    codes = np.stack([lo.ravel(), hi.ravel()], -1).astype(np.int8)  # [256, 2]
    packed = tpaged.pack_int4(torch.from_numpy(codes))
    assert np.array_equal(packed.numpy(),
                          np.asarray(jpaged.pack_int4(jnp.asarray(codes))))
    assert np.array_equal(tpaged.unpack_int4(packed).numpy(), codes)


@pytest.mark.parametrize("dtype", ["fp", "int8", "int4"])
def test_pool_writes_and_gather_match_jax(dtype):
    rng = np.random.default_rng(3)
    spec = jpaged.spec_for(32, 2, page_size=8)
    KV, hd = 2, 16
    jq, tq = jpaged.KVQuantSpec(dtype), tpaged.KVQuantSpec(dtype)
    jkv = jpaged.zero_kv_pool(spec, KV, hd, jq)
    tkv = tpaged.zero_kv_pool(tpaged.spec_for(32, 2, page_size=8), KV, hd,
                              tq, device="cpu")
    for name in jkv:
        assert np.array_equal(to_torch(np.asarray(jkv[name]), "cpu")
                              .view(torch.uint8).numpy(),
                              tkv[name].view(torch.uint8).numpy())
    row = np.zeros(spec.max_blocks, np.int32)
    row[:2] = [3, 5]
    k = rng.standard_normal((1, 8, KV, hd)).astype(np.float32)
    v = rng.standard_normal((1, 8, KV, hd)).astype(np.float32)
    jk, jv = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
    jkv = jpaged.write_chunk_kv(jkv, jk, jv, jnp.asarray(row), 4, jq)
    tpaged.write_chunk_kv(tkv, to_torch(np.asarray(jk), "cpu"),
                          to_torch(np.asarray(jv), "cpu"),
                          torch.from_numpy(row), 4, tq)
    bt = np.zeros((2, spec.max_blocks), np.int32)
    bt[0] = row
    pos = np.array([12, 0], np.int32)                  # slot 1 idle
    dk = jnp.asarray(k[:, :2].reshape(2, 1, KV, hd), jnp.bfloat16)
    jkv = jpaged.write_decode_kv(jkv, dk, dk, jnp.asarray(bt),
                                 jnp.asarray(pos), jq)
    tdk = to_torch(np.asarray(dk), "cpu")
    tpaged.write_decode_kv(tkv, tdk, tdk, torch.from_numpy(bt),
                           torch.from_numpy(pos), tq)
    for name in jkv:
        live = [3, 5]                                  # scratch page 0 aside
        assert np.array_equal(
            to_torch(np.asarray(jkv[name])[live], "cpu")
            .view(torch.uint8).numpy(),
            tkv[name][live].view(torch.uint8).numpy()), name
    jg = jpaged.gather_kv_deq(jkv, jnp.asarray(bt[:1]), jq)
    tg = tpaged.gather_kv_deq(tkv, torch.from_numpy(bt[:1]), tq)
    for a, b in zip(jg, tg):
        assert np.array_equal(np.asarray(a, np.float32), b.float().numpy())


# ---------------------------------------------------------------------------
# paged flash-decode
# ---------------------------------------------------------------------------


def _flash_inputs(rng, dtype, B, KV, rep, hd, P, MB, lens, idle=()):
    n_pages = B * MB + 1
    q = rng.standard_normal((B, KV, rep, hd)).astype(np.float32)
    k = rng.standard_normal((n_pages, P, KV, hd)).astype(np.float32)
    v = rng.standard_normal((n_pages, P, KV, hd)).astype(np.float32)
    bt = (rng.permutation(n_pages - 1)[: B * MB] + 1).reshape(B, MB)
    bt = bt.astype(np.int32)
    for b in idle:
        bt[b] = 0
    jq = jpaged.KVQuantSpec(dtype)
    jqv = jnp.asarray(q, jnp.bfloat16)
    if dtype == "fp":
        pools = {"k": jnp.asarray(k, jnp.bfloat16),
                 "v": jnp.asarray(v, jnp.bfloat16)}
    else:
        kc, ks = jpaged.quantise_kv(jnp.asarray(k), jq)
        vc, vs = jpaged.quantise_kv(jnp.asarray(v), jq)
        pools = {"k": kc, "v": vc, "ks": ks, "vs": vs}
    return jqv, pools, bt, np.asarray(lens, np.int32)


FLASH_CASES = [  # (rep, hd, window, n_splits)
    (1, 16, None, 4),
    (4, 16, 8, 1),
    (4, 16, None, 4),
    (1, 32, 5, 4),
]


@pytest.mark.parametrize("rep,hd,window,n_splits", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["fp", "int8", "int4"])
def test_flash_decode_vs_jax_interpret_and_lax(dtype, rep, hd, window,
                                               n_splits):
    rng = np.random.default_rng(rep * 100 + hd + n_splits)
    B, KV, P, MB = 3, 2, 8, 6
    lens = (1, 20, 45)                                  # slot 0 idle
    jqv, pools, bt, lens = _flash_inputs(rng, dtype, B, KV, rep, hd, P, MB,
                                         lens, idle=(0,))
    want = np.asarray(jflash(
        jqv, pools["k"], pools["v"], jnp.asarray(bt), jnp.asarray(lens),
        window=window, n_splits=n_splits, interpret=True,
        k_scales=pools.get("ks"), v_scales=pools.get("vs"), kv_dtype=dtype))
    t = {n: to_torch(np.asarray(x), "cpu") for n, x in pools.items()}
    got = tflash(to_torch(np.asarray(jqv), "cpu"), t["k"], t["v"],
                 torch.from_numpy(bt), torch.from_numpy(lens), window=window,
                 n_splits=n_splits, k_scales=t.get("ks"), v_scales=t.get("vs"),
                 kv_dtype=dtype)
    assert got.dtype == torch.float32 and got.shape == (B, KV, rep, hd)
    np.testing.assert_allclose(got.numpy(), want, atol=FLASH_ATOL, rtol=0)
    # and the oracle reader, on the same pool through the block table
    H = KV * rep
    jout = jpaged._attend_lax(
        jqv.reshape(B, 1, H, hd), pools, jnp.asarray(bt),
        jnp.asarray(lens - 1), window, jpaged.KVQuantSpec(dtype))
    tout = tpaged._attend_lax(
        to_torch(np.asarray(jqv), "cpu").reshape(B, 1, H, hd), t,
        torch.from_numpy(bt), torch.from_numpy(lens - 1), window,
        tpaged.KVQuantSpec(dtype))
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(jout, np.float32), atol=2e-2)
    np.testing.assert_allclose(got.reshape(B, 1, H * hd).numpy(),
                               np.asarray(jout, np.float32), atol=2e-2)


def test_flash_decode_wrapper_rejects_bad_operands():
    rng = np.random.default_rng(5)
    jqv, pools, bt, lens = _flash_inputs(rng, "int8", 2, 2, 1, 16, 8, 2,
                                         (3, 9))
    t = {n: to_torch(np.asarray(x), "cpu") for n, x in pools.items()}
    q = to_torch(np.asarray(jqv), "cpu")
    args = (q, t["k"], t["v"], torch.from_numpy(bt), torch.from_numpy(lens))
    with pytest.raises(ValueError, match="scales"):
        tflash(*args, kv_dtype="int8")
    with pytest.raises(ValueError, match="pools must be"):
        tflash(*args, kv_dtype="fp")
    with pytest.raises(ValueError, match="lengths"):
        tflash(*args[:4], torch.from_numpy(lens[:1]), kv_dtype="int8",
               k_scales=t["ks"], v_scales=t["vs"])


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dp,kg,n_arr,idx_dtype,M", GEMM_CASES)
def test_lookup_gemm_kernel_equals_plain_on_card(cuda, dp, kg, n_arr,
                                                 idx_dtype, M):
    rng = np.random.default_rng(dp + kg + M)
    arrs = [torch.from_numpy(x).to(cuda)
            for x in _plan(rng, dp, kg, 2, n_arr, idx_dtype, M)]
    a, table, idx, cl = arrs
    narrow = tfused.narrow_table(table)      # the kernel reads narrow rows
    n0 = tfused.launches
    got = tfused.tlmac_gemm_fused(a, idx, cl, narrow, B_a=B_A, G=G)
    want = tfused.tlmac_gemm_fused_plain(a, idx, cl, table, B_a=B_A, G=G)
    torch.cuda.synchronize()
    assert tfused.launches == n0 + 1
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="narrow"):
        tfused.tlmac_gemm_fused(a, idx, cl, table, B_a=B_A, G=G)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("M", [1, 4, 16, 17, 64])
@pytest.mark.parametrize("G_,B_a,dp,kg,n_arr,idx_dtype,_M,rng_", ONEHOT_CASES)
def test_lookup_gemm_kernel_both_inner_products_on_card(
        cuda, M, G_, B_a, dp, kg, n_arr, idx_dtype, _M, rng_):
    """dp4a (M <= 16, and every int16 table) and mma.sync (M > 16) paths
    across G 1-4, ragged kg, odd dp, uint8/int16 indices, int8/int16 rows
    and B_a up to 8."""
    rng = np.random.default_rng(G_ * 1000 + dp + kg + M)
    a = rng.integers(0, 2**B_a, (M, kg * G_)).astype(np.uint8).view(np.int8)
    table = rng.integers(*rng_, (3, n_arr, 2**G_)).astype(np.int32)
    idx = rng.integers(0, n_arr, (3, kg, dp)).astype(idx_dtype)
    cl = rng.integers(0, 3, (3, kg)).astype(np.int8)
    ta, tt, ti, tc = (torch.from_numpy(x).to(cuda) for x in (a, table, idx, cl))
    got = tfused.tlmac_gemm_fused(ta, ti, tc, tfused.narrow_table(tt),
                                  B_a=B_a, G=G_)
    want = tfused.tlmac_gemm_fused_plain(ta, ti, tc, tt, B_a=B_a, G=G_)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("rep,hd,window,n_splits", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["fp", "int8", "int4"])
def test_flash_decode_kernel_matches_plain_on_card(cuda, dtype, rep, hd,
                                                   window, n_splits):
    from repro_torch.kernels import flash_decode as fd

    rng = np.random.default_rng(rep * 100 + hd + n_splits)
    jqv, pools, bt, lens = _flash_inputs(rng, dtype, 3, 2, rep, hd, 8, 6,
                                         (1, 20, 45), idle=(0,))
    t = {n: to_torch(np.asarray(x), cuda) for n, x in pools.items()}
    q = to_torch(np.asarray(jqv), cuda)
    args = (q, t["k"], t["v"], torch.from_numpy(bt).to(cuda),
            torch.from_numpy(lens).to(cuda))
    kw = dict(window=window, n_splits=n_splits, k_scales=t.get("ks"),
              v_scales=t.get("vs"), kv_dtype=dtype)
    n0 = fd.launches
    got = tflash(*args, **kw)
    want = combine_splits(*flash_decode_partials_plain(*args, **kw))
    torch.cuda.synchronize()
    assert fd.launches == n0 + 1
    torch.testing.assert_close(got, want, atol=FLASH_ATOL, rtol=0)


# the kernel's own edges: one and many splits (more splits than keys),
# rep above the 8-head tile (two rep chunks), hd 128 (16 lanes a row) and
# 8 (one lane a row), a window shorter than a page
CARD_FLASH_CASES = [  # (rep, hd, window, n_splits)
    (1, 128, None, 1),
    (1, 128, None, 16),
    (12, 64, None, 3),
    (4, 8, 3, 7),
    (1, 128, 5, 64),
]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("rep,hd,window,n_splits", CARD_FLASH_CASES)
@pytest.mark.parametrize("dtype", ["fp", "int8", "int4"])
def test_flash_decode_kernel_edges_on_card(cuda, dtype, rep, hd, window,
                                           n_splits):
    from repro_torch.kernels import flash_decode as fd

    rng = np.random.default_rng(rep * 100 + hd + n_splits)
    jqv, pools, bt, lens = _flash_inputs(rng, dtype, 3, 2, rep, hd, 8, 6,
                                         (1, 20, 45), idle=(0,))
    t = {n: to_torch(np.asarray(x), cuda) for n, x in pools.items()}
    q = to_torch(np.asarray(jqv), cuda)
    args = (q, t["k"], t["v"], torch.from_numpy(bt).to(cuda),
            torch.from_numpy(lens).to(cuda))
    kw = dict(window=window, n_splits=n_splits, k_scales=t.get("ks"),
              v_scales=t.get("vs"), kv_dtype=dtype)
    n0 = fd.launches
    for _ in range(2):                  # the split tickets reset themselves
        got = tflash(*args, **kw)
    want = combine_splits(*flash_decode_partials_plain(*args, **kw))
    torch.cuda.synchronize()
    assert fd.launches == n0 + 2
    torch.testing.assert_close(got, want, atol=FLASH_ATOL, rtol=0)
