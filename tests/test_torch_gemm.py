"""The algebra of the lookup GEMM on packed codes (kernel 3) and of the
bit-plane pack (kernel 4) on the CPU.

``tlmac_gemm_onehot_plain`` (the B_a planes folded into u8 one-hot
coefficients times the narrow table rows that rowbase selects, int16 rows
split into a u8 low and an s8 high byte) and ``pack_bitplanes_words_plain``
(byte g of four groups in one word, each plane's codes formed four at a
time) are held int32/int8-equal to the port's plain versions and to the
reference: ``tlmac_gemm`` in interpret mode with both gathers, the Pallas
pack and its oracle.  The callers' narrow tables (made once per plan and
device) are checked too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.bitplanes import pack_bitplanes_pallas
from repro.kernels.tlmac_gemm import tlmac_gemm as jgemm

from repro_torch.core.tlmac import compile as ttc
from repro_torch.core.tlmac.api import TLMACLinear
from repro_torch.kernels import bitplanes as tbp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tlmac_gemm as tg
from repro_torch.kernels.tlmac_fused import narrow_table
from repro_torch.models import resnet as TR

# the reference's sweep (tests/test_kernels.py): (K, N, M, B_w, B_a, G)
SWEEP = [(16, 64, 4, 2, 2, 2), (24, 64, 8, 3, 3, 3), (32, 128, 16, 3, 4, 4),
         (48, 64, 5, 4, 4, 6), (64, 192, 33, 2, 3, 4)]


def _jax_gemm(codes, rb, t2d, B_a, G, gather):
    """The reference kernel in interpret mode (blocks smaller than the
    shapes, so a ragged KG pads to its zero row)."""
    return np.asarray(jgemm(jnp.asarray(codes, jnp.int32), jnp.asarray(rb),
                            jnp.asarray(t2d, jnp.int32), B_a=B_a, G=G,
                            N=rb.shape[0] * rb.shape[2], bm=16, bk=4,
                            gather=gather))


@pytest.mark.parametrize("K,N,M,B_w,B_a,G", SWEEP)
def test_onehot_plain_on_narrow_tables_equals_reference(K, N, M, B_w, B_a,
                                                        G):
    rng = np.random.default_rng(K * 11 + G)
    w = rng.integers(-(2 ** (B_w - 1)), 2 ** (B_w - 1), size=(K, N))
    plan = ttc.compile_layer(w, B_w=B_w, B_a=B_a, G=G, d_p=64,
                             anneal_iters=100, seed=0)
    a = rng.integers(0, 2**B_a, size=(M, K))
    dense = np.asarray(jref.dense_int_matmul_ref(jnp.asarray(a),
                                                 jnp.asarray(w)))
    codes = tbp.pack_bitplanes(torch.from_numpy(a.astype(np.int8)), B_a=B_a,
                               G=G)
    table = torch.from_numpy(plan.table)
    rb = tref.rowbase_from_plan(table, torch.from_numpy(plan.exec_idx),
                                torch.from_numpy(plan.step_cluster),
                                N // 64, K // G)
    t2d = table.reshape(-1, 2**G)
    narrow = narrow_table(t2d)
    assert narrow.dtype == torch.int8      # a compiled plan's sums fit int8
    kw = dict(B_a=B_a, G=G, N=N)
    got = tg.tlmac_gemm_onehot_plain(codes, rb, narrow, **kw)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), dense)
    for t in (t2d, narrow):
        assert torch.equal(tref.lookup_gemm_ref(codes, rb, t, B_a), got)
        assert torch.equal(tg.tlmac_gemm(codes, rb, t, **kw), got)
    for gather in ("take", "onehot"):
        assert np.array_equal(_jax_gemm(codes.numpy(), rb.numpy(),
                                        t2d.numpy(), B_a, G, gather), dense)


def _weight_group_case(rng, M, KG, n_tiles, dp, B_a, G, lim, R=29):
    """Rows of sum_g bit_g(e) * w[r, g] for R random weight groups: the
    lookup GEMM then equals ``a @ W`` for W's groups the selected rows."""
    wrows = rng.integers(-lim, lim, size=(R, G))
    bits = (np.arange(2**G)[:, None] >> np.arange(G)) & 1
    t2d = wrows @ bits.T
    rb = rng.integers(0, R, size=(n_tiles, KG, dp)).astype(np.int32)
    a = rng.integers(0, 2**B_a, size=(M, KG * G))
    W = wrows[rb].transpose(1, 3, 0, 2).reshape(KG * G, n_tiles * dp)
    return a, t2d, rb, (a @ W).astype(np.int32)


@pytest.mark.parametrize("G", [1, 2, 3, 4, 5, 6])
def test_onehot_plain_int16_rows_split_exactly(G):
    """Entries outside int8: the int16 rows split into a u8 low and an s8
    high byte, two products summed modulo 2^32; B_a 1 and 8, ragged KG
    and M."""
    rng = np.random.default_rng(G)
    for B_a, M, KG in ((1, 7, 9), (8, 13, 5)):
        a, t2d, rb, dense = _weight_group_case(rng, M, KG, 2, 6, B_a, G, 3000)
        narrow = narrow_table(torch.from_numpy(t2d))
        assert narrow.dtype == torch.int16
        codes = tbp.pack_bitplanes_plain(
            torch.from_numpy(a.astype(np.uint8).view(np.int8)), B_a=B_a, G=G)
        rbt = torch.from_numpy(rb)
        got = tg.tlmac_gemm_onehot_plain(codes, rbt, narrow, B_a=B_a, G=G,
                                         N=12)
        assert np.array_equal(got.numpy(), dense)
        assert torch.equal(tg.tlmac_gemm_plain(codes, rbt, narrow, B_a=B_a,
                                               G=G, N=12), got)
        assert np.array_equal(_jax_gemm(codes.numpy().astype(np.uint8), rb,
                                        t2d, B_a, G, "take"), dense)


@pytest.mark.parametrize("B_a", [1, 3, 8])
@pytest.mark.parametrize("G", [1, 2, 3, 4, 5, 6])
def test_words_pack_equals_reference(G, B_a):
    """The word-wise pack on shapes where K is a multiple of 16*G or not
    and M*K/G a multiple of 16 or not (the kernel's tail)."""
    rng = np.random.default_rng(10 * G + B_a)
    for M, kg in ((4, 16), (5, 7), (3, 21)):
        a = rng.integers(0, 2**B_a, size=(M, kg * G))
        ta = torch.from_numpy(a.astype(np.uint8).view(np.int8))
        got = tbp.pack_bitplanes_words_plain(ta, B_a=B_a, G=G)
        assert got.dtype == torch.int8 and got.shape == (B_a, M, kg)
        assert torch.equal(got, tbp.pack_bitplanes_plain(ta, B_a=B_a, G=G))
        assert torch.equal(got, tref.pack_bitplanes_ref(ta.to(torch.uint8),
                                                        B_a, G))
        want = np.asarray(jref.pack_bitplanes_ref(jnp.asarray(a), B_a, G))
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(got.numpy(), np.asarray(pack_bitplanes_pallas(
            jnp.asarray(a), B_a=B_a, G=G)))


def test_conv_row_plans_and_tlmac_linear_hold_narrow_tables():
    """conv_row_plan and TLMACLinear make the narrow table once per plan
    and device; ops.tlmac_matmul('pallas') reads it unchanged and equals
    the reference and the dense GEMM."""
    rng = np.random.default_rng(3)
    K, N, M = 24, 48, 9
    w = rng.integers(-4, 4, size=(K, N))
    plan = ttc.compile_layer(w, B_w=3, B_a=3, G=3, d_p=48, anneal_iters=100,
                             seed=0)
    a = rng.integers(0, 8, size=(M, K))
    ta = torch.from_numpy(a.astype(np.int8))
    for r in range(3):
        table, ex, cl = TR.conv_row_plan(plan, r, "cpu")
        assert table.dtype == torch.int8
        assert TR.conv_row_plan(plan, r, "cpu")[0] is table   # made once
        got = tops.tlmac_matmul(ta, table, ex, cl, B_a=3, G=3, N=N // 3,
                                impl="pallas")
        assert np.array_equal(got.numpy(), a @ w[:, r::3])
        want = np.asarray(jops.tlmac_matmul(
            jnp.asarray(a), jnp.asarray(plan.table), jnp.asarray(ex.numpy()),
            jnp.asarray(plan.step_cluster), B_a=3, G=3, N=N // 3,
            impl="pallas"))
        assert np.array_equal(got.numpy(), want)
    lin = TLMACLinear.from_weights(rng.normal(size=(32, 64)) * 0.05,
                                   w_bits=3, a_bits=3, G=4, d_p=64,
                                   anneal_iters=100, device="cpu")
    arrays = lin._plan_arrays("cpu")
    assert arrays[0].dtype == torch.int8 and lin._plan_arrays("cpu") is arrays
    assert np.array_equal(arrays[0].numpy(), lin.plan.table)


def test_lookup_gemm_cuts_tool_matches_the_kernel_source():
    """tools/lookup_gemm_cuts.py cuts phases out of the kernel source by
    text: every cut must still find its text exactly once."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "tools",
                        "lookup_gemm_cuts.py")
    spec = importlib.util.spec_from_file_location("lookup_gemm_cuts", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = open(tool.SOURCE).read()
    assert set(tool.CUTS) == {"none", "products", "coef build",
                              "code staging", "streamed rows"}
    for name, patches in tool.CUTS.items():
        for old, _ in patches:
            assert src.count(old) == 1, name
