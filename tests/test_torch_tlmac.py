"""The port's TLMAC compiler, quantisers and lookup kernels vs the JAX
reference, on the CPU, with the same numpy inputs on both sides: compiled
plans identical array for array, integer codes and every lookup-GEMM
output bit-exact, float quantiser outputs within a stated tolerance.
The plain versions of kernels 3-6 run here; their CUDA kernels are held
against them on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.configs import smoke_config as jsmoke
from repro.core.quant import quantizers as JQ
from repro.core.tlmac import compile as jtc
from repro.core.tlmac.api import TLMACLinear as JLinear
from repro.kernels import ops as jops
from repro.kernels import tlmac_clustered as jcl
from repro.kernels.bitplanes import pack_bitplanes_pallas
from repro.kernels.tlmac_gemm import tlmac_gemm as jgemm
from repro.models import nn as jnn

from repro_torch.configs import smoke_config as tsmoke
from repro_torch.core.quant import quantizers as TQ
from repro_torch.core.tlmac import compile as ttc
from repro_torch.core.tlmac.api import TLMACLinear as TLinear
from repro_torch.kernels import bitplanes as tbp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tlmac_clustered as tcl
from repro_torch.kernels import tlmac_gemm as tgemm
from repro_torch.models import nn as tnn

from _torch_parity import plans_equal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# float quantiser outputs: both sides do the same f32 operations, but
# XLA and torch may reduce a mean in another order (one ulp of the step)
QUANT_RTOL = 1e-6


def _w(rng, shape, B_w):
    return rng.integers(-(2 ** (B_w - 1)), 2 ** (B_w - 1), size=shape)


# (weights shape, B_w, G, d_p, cluster_max_spectral): matmul at G 2/4/6,
# a conv (G = 3 kernel rows, two output tiles), and both layouts through
# the greedy clustering branch (max_spectral below D_s)
COMPILE_CASES = [
    ((32, 128), 3, 4, 64, 8192),
    ((16, 64), 2, 2, 64, 8192),
    ((48, 64), 4, 6, 64, 8192),
    ((64, 16, 3, 3), 3, 3, 32, 8192),
    ((64, 128), 3, 4, 64, 16),
    ((32, 16, 3, 3), 3, 3, 16, 8),
]


@pytest.mark.parametrize("shape,B_w,G,d_p,max_spectral", COMPILE_CASES)
def test_compile_layer_plans_identical_to_jax(shape, B_w, G, d_p,
                                              max_spectral):
    rng = np.random.default_rng(len(shape) * 100 + G)
    w = _w(rng, shape, B_w)
    kw = dict(B_w=B_w, B_a=3, G=G, d_p=d_p, anneal_iters=300, seed=3,
              cluster_max_spectral=max_spectral)
    want = jtc.compile_layer(w, **kw)
    got = ttc.compile_layer(w, **kw)
    plans_equal(got, want)
    assert ttc.verify_plan(got)
    if max_spectral < got.D_s:
        # the greedy branch really ran: the labels differ from spectral's
        spec = ttc.compile_layer(w, **dict(kw, cluster_max_spectral=8192))
        assert not np.array_equal(spec.step_cluster, got.step_cluster)


def test_compile_layer_default_anneal_budget_identical():
    w = _w(np.random.default_rng(9), (16, 64), 3)
    plans_equal(ttc.compile_layer(w, B_w=3, B_a=3, G=4, pack_luts=False),
                 jtc.compile_layer(w, B_w=3, B_a=3, G=4, pack_luts=False))


# ---------------------------------------------------------------------------
# quantisers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("per_channel", [True, False])
def test_quantize_weights_int_codes_bitexact(per_channel):
    w = np.random.default_rng(1).normal(size=(96, 40)).astype(np.float32)
    cfg_j = JQ.QuantConfig(w_bits=3, a_bits=3, per_channel=per_channel)
    cfg_t = TQ.QuantConfig(w_bits=3, a_bits=3, per_channel=per_channel)
    jq, js = JQ.quantize_weights_int(jnp.asarray(w), cfg_j)
    tq, ts = TQ.quantize_weights_int(torch.from_numpy(w), cfg_t)
    assert tq.dtype == torch.int32
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=QUANT_RTOL)


@pytest.mark.parametrize("n", [1000, 4096 + 7])
def test_quantize_acts_int_codes_bitexact(n):
    a = np.random.default_rng(n).normal(size=(n,)).astype(np.float32) * 3
    cfg = TQ.QuantConfig(a_bits=3)
    jq, js = JQ.quantize_acts_int(jnp.asarray(a), JQ.QuantConfig(a_bits=3))
    tq, ts = TQ.quantize_acts_int(torch.from_numpy(a), cfg)
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=QUANT_RTOL)


def test_lsq_and_n2uq_forward_match_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(7, 33)).astype(np.float32)
    jstep = JQ.lsq_init(jnp.asarray(x), 3, per_channel=False)
    tstep = TQ.lsq_init(torch.from_numpy(x), 3, per_channel=False)
    np.testing.assert_allclose(tstep.numpy(), np.asarray(jstep),
                               rtol=QUANT_RTOL)
    for signed in (True, False):
        jy = JQ.lsq_quant(jnp.asarray(x), jstep, 3, signed=signed)
        ty = TQ.lsq_quant(torch.from_numpy(x), torch.from_numpy(
            np.asarray(jstep)), 3, signed=signed)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy),
                                   rtol=QUANT_RTOL, atol=0)
        jc = JQ.lsq_quant(jnp.asarray(x), jstep, 3, signed=signed,
                          dequant=False)
        tc = TQ.lsq_quant(torch.from_numpy(x), torch.from_numpy(
            np.asarray(jstep)), 3, signed=signed, dequant=False)
        assert np.array_equal(tc.numpy(), np.asarray(jc))
    # N2UQ at init and at trained-looking deltas (one above softplus's
    # linear switch of torch, x > 20: the port writes softplus out)
    for deltas in (None, np.array([0.1, -2.0, 0.5, 21.0, 0.3, -0.7, 1.2],
                                  np.float32)):
        jp = JQ.n2uq_act_init(3)
        tp = TQ.n2uq_act_init(3, device="cpu")
        if deltas is not None:
            jp = dict(jp, deltas=jnp.asarray(deltas))
            tp = dict(tp, deltas=torch.from_numpy(deltas))
        np.testing.assert_allclose(
            TQ._thresholds_from_deltas(tp["deltas"]).numpy(),
            np.asarray(JQ._thresholds_from_deltas(jp["deltas"])),
            rtol=QUANT_RTOL)
        xx = x * 4
        jy = JQ.n2uq_act_quant(jnp.asarray(xx), jp, 3)
        ty = TQ.n2uq_act_quant(torch.from_numpy(xx), tp, 3)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy),
                                   rtol=QUANT_RTOL)
        jc = JQ.n2uq_act_quant(jnp.asarray(xx), jp, 3, dequant=False)
        tc = TQ.n2uq_act_quant(torch.from_numpy(xx), tp, 3, dequant=False)
        assert np.array_equal(tc.numpy(), np.asarray(jc))


def test_configs_import_quantconfig_from_quantizers():
    from repro_torch.configs import QuantConfig

    assert QuantConfig is TQ.QuantConfig
    assert tsmoke("codeqwen1.5-7b").quant == TQ.QuantConfig(w_bits=3,
                                                            a_bits=3)


# ---------------------------------------------------------------------------
# kernels 3-6: plain versions vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B_a,G,M,K", [(2, 2, 3, 8), (3, 4, 7, 16),
                                       (4, 3, 2, 9), (8, 6, 5, 24)])
def test_pack_bitplanes_plain_bitexact_vs_pallas(B_a, G, M, K):
    K = K - (K % G)
    a = np.random.default_rng(M).integers(0, 2**B_a, (M, K))
    want = np.asarray(pack_bitplanes_pallas(jnp.asarray(a), B_a=B_a, G=G))
    got = tbp.pack_bitplanes(torch.from_numpy(a.astype(np.int8)), B_a=B_a,
                             G=G)
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(tops.pack_bitplanes(
        torch.from_numpy(a.astype(np.int8)), B_a, G, impl="pallas").numpy(),
        want)


# the reference's sweep (tests/test_kernels.py) plus its blocking-edge case
SWEEP = [(16, 64, 4, 2, 2, 2), (24, 64, 8, 3, 3, 3), (32, 128, 16, 3, 4, 4),
         (48, 64, 5, 4, 4, 6), (64, 192, 33, 2, 3, 4), (40, 128, 37, 3, 3, 4)]


def _compiled(K, N, M, B_w, B_a, G, d_p=64, seed=None):
    rng = np.random.default_rng(K * 7 + G if seed is None else seed)
    w = _w(rng, (K, N), B_w)
    plan = ttc.compile_layer(w, B_w=B_w, B_a=B_a, G=G, d_p=d_p,
                             anneal_iters=100, seed=0)
    a = rng.integers(0, 2**B_a, size=(M, K))
    return w, plan, a


@pytest.mark.parametrize("K,N,M,B_w,B_a,G", SWEEP)
def test_tlmac_gemm_plain_bitexact_vs_pallas(K, N, M, B_w, B_a, G):
    w, plan, a = _compiled(K, N, M, B_w, B_a, G)
    dense = np.asarray(jops.dense_int_matmul(jnp.asarray(a), jnp.asarray(w)))
    kg, n_tiles = K // G, N // 64
    codes = np.asarray(jops.pack_bitplanes(jnp.asarray(a), B_a, G))
    rb = (plan.step_cluster[:, None] * plan.N_arr
          + plan.exec_idx).reshape(n_tiles, kg, 64).astype(np.int32)
    t2d = plan.table.reshape(-1, 2**G)
    for gather in ("take", "onehot"):
        want = np.asarray(jgemm(jnp.asarray(codes, jnp.int32), jnp.asarray(rb),
                                jnp.asarray(t2d), B_a=B_a, G=G, N=N, bm=16,
                                bk=4, gather=gather))
        assert np.array_equal(want, dense), gather
    got = tgemm.tlmac_gemm(torch.from_numpy(codes), torch.from_numpy(rb),
                           torch.from_numpy(t2d), B_a=B_a, G=G, N=N)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), dense)
    # ops: impl names map one to one onto the reference's
    ta = torch.from_numpy(a.astype(np.int8))
    targs = [torch.from_numpy(x) for x in (plan.table, plan.exec_idx,
                                           plan.step_cluster)]
    for impl in ("ref", "pallas"):
        got = tops.tlmac_matmul(ta, *targs, B_a=B_a, G=G, N=N, impl=impl)
        want = np.asarray(jops.tlmac_matmul(
            jnp.asarray(a), *map(jnp.asarray, (plan.table, plan.exec_idx,
                                               plan.step_cluster)),
            B_a=B_a, G=G, N=N, impl=impl))
        assert np.array_equal(got.numpy(), want), impl
    assert np.array_equal(tops.dense_int_matmul(ta, torch.from_numpy(w))
                          .numpy(), dense)


def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
    w, plan, a = _compiled(32, 128, 4, 3, 3, 4)
    codes = tbp.pack_bitplanes(torch.from_numpy(a.astype(np.int8)), B_a=3,
                               G=4)
    rb = tref.rowbase_from_plan(*(torch.from_numpy(x) for x in (
        plan.table, plan.exec_idx, plan.step_cluster)), 2, 8)
    t2d = torch.from_numpy(plan.table.reshape(-1, 16))
    kw = dict(B_a=3, G=4, N=128)
    with pytest.raises(ValueError, match="int8"):
        tgemm.tlmac_gemm(codes.int(), rb, t2d, **kw)
    with pytest.raises(ValueError, match="rowbase"):
        tgemm.tlmac_gemm(codes, rb.long(), t2d, **kw)
    with pytest.raises(ValueError, match="N=64"):
        tgemm.tlmac_gemm(codes, rb, t2d, B_a=3, G=4, N=64)
    with pytest.raises(ValueError, match="device"):
        tgemm.tlmac_gemm(*(t.to("meta") for t in (codes, rb, t2d)), **kw)
    with pytest.raises(ValueError, match="int8"):
        tbp.pack_bitplanes(torch.from_numpy(a), B_a=3, G=4)
    with pytest.raises(ValueError, match="divide"):
        tbp.pack_bitplanes(torch.from_numpy(a[:, :30].astype(np.int8)),
                           B_a=3, G=4)
    s = tcl.device_schedule(plan, 2, 8, "cpu", tiled=True)
    cs = codes.index_select(2, s["cols"])
    with pytest.raises(ValueError, match="codes_sorted"):
        tcl.tlmac_gemm_clustered_multi(cs[:, :, 1:], s["idx_sorted"],
                                       s["table_pad"], B_a=3, G=4)
    with pytest.raises(ValueError, match="n_clus, ms, D_p"):
        tcl.tlmac_gemm_clustered(cs, s["idx_sorted"], s["table_pad"], B_a=3,
                                 G=4)
    with pytest.raises(ValueError, match="device"):
        tcl.tlmac_gemm_clustered_multi(
            *(t.to("meta") for t in (cs, s["idx_sorted"], s["table_pad"])),
            B_a=3, G=4)
    with pytest.raises(ValueError, match="unknown impl"):
        tops.tlmac_matmul(torch.from_numpy(a.astype(np.int8)),
                          *(torch.from_numpy(x) for x in (
                              plan.table, plan.exec_idx, plan.step_cluster)),
                          B_a=3, G=4, N=128, impl="pallas-onehot")


# the reference's clustered cases (tests/test_kernels.py: d_p = N, one
# tile; tests/test_fused_autotune.py: several tiles)
CLUSTERED = [(64, 64, 21, 3, 3, 4, 64, 4), (24, 32, 7, 2, 2, 3, 32, 2),
             (48, 128, 9, 4, 4, 4, 128, 8)]
CLUSTERED_MULTI = [(64, 128, 21, 3, 3, 4, 64, 4), (24, 96, 7, 2, 2, 3, 32, 2),
                   (48, 128, 9, 4, 4, 4, 128, 8)]


@pytest.mark.parametrize("K,N,M,B_w,B_a,G,d_p,bk", CLUSTERED)
def test_run_clustered_and_schedule_bitexact_vs_jax(K, N, M, B_w, B_a, G,
                                                    d_p, bk):
    w, plan, a = _compiled(K, N, M, B_w, B_a, G, d_p=d_p, seed=K + N)
    jplan = jtc.compile_layer(w, B_w=B_w, B_a=B_a, G=G, d_p=d_p,
                              anneal_iters=100, seed=0)
    plans_equal(plan, jplan)
    js, ts = jcl.cluster_schedule(jplan, bk=bk), tcl.cluster_schedule(plan,
                                                                      bk=bk)
    assert js["ms"] == ts["ms"]
    for f in ("order", "idx_sorted", "table_pad"):
        assert np.array_equal(js[f], ts[f]), f
    want = np.asarray(jcl.run_clustered(jplan, a, B_a=B_a, bk=bk, bm=16))
    assert np.array_equal(want, np.asarray(jops.dense_int_matmul(
        jnp.asarray(a), jnp.asarray(w))))
    got = tcl.run_clustered(plan, torch.from_numpy(a), B_a, bk=bk)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("K,N,M,B_w,B_a,G,d_p,bk", CLUSTERED_MULTI)
def test_run_clustered_multi_and_schedule_bitexact_vs_jax(K, N, M, B_w, B_a,
                                                          G, d_p, bk):
    w, plan, a = _compiled(K, N, M, B_w, B_a, G, d_p=d_p, seed=K + N + 1)
    jplan = jtc.compile_layer(w, B_w=B_w, B_a=B_a, G=G, d_p=d_p,
                              anneal_iters=100, seed=0)
    n_tiles = N // d_p
    js = jcl.cluster_schedule_tiled(jplan, n_tiles, bk=bk)
    ts = tcl.cluster_schedule_tiled(plan, n_tiles, bk=bk)
    assert js["ms"] == ts["ms"]
    for f in ("order", "idx_sorted", "table_pad"):
        assert np.array_equal(js[f], ts[f]), f
    want = np.asarray(jcl.run_clustered_multi(jplan, a, B_a=B_a, N=N, bk=bk,
                                              bm=16))
    got = tcl.run_clustered_multi(plan, torch.from_numpy(a), B_a, N=N, bk=bk)
    assert np.array_equal(got.numpy(), want)
    # the kernel-level wrapper on the scheduled operands, and its plain twin
    s = tcl.device_schedule(plan, n_tiles, bk, "cpu", tiled=True)
    cs = tbp.pack_bitplanes(torch.from_numpy(a.astype(np.int8)), B_a=B_a,
                            G=G).index_select(2, s["cols"])
    out = tcl.tlmac_gemm_clustered_multi(cs, s["idx_sorted"], s["table_pad"],
                                         B_a=B_a, G=G)
    assert np.array_equal(out.numpy(), want)


# ---------------------------------------------------------------------------
# TLMACLinear
# ---------------------------------------------------------------------------


def test_tlmac_linear_matches_jax_and_feeds_serve_linear_apply():
    rng = np.random.default_rng(0)
    K, N, M = 64, 128, 6
    w = (rng.normal(size=(K, N)) * 0.05).astype(np.float32)
    x = np.abs(rng.normal(size=(2, M, K))).astype(np.float32)
    jl = JLinear.from_weights(w, w_bits=3, a_bits=3, G=4, d_p=64,
                              anneal_iters=300)
    tl = TLinear.from_weights(w, w_bits=3, a_bits=3, G=4, d_p=64,
                              anneal_iters=300, device="cpu")
    plans_equal(tl.plan, jl.plan)
    # the scales come from float32 means that XLA and torch reduce in
    # another order: equal within an ulp (QUANT_RTOL)
    np.testing.assert_allclose(tl.w_step.numpy(), np.asarray(jl.w_step),
                               rtol=QUANT_RTOL)
    jl.calibrate(x)
    tl.calibrate(torch.from_numpy(x))
    np.testing.assert_allclose(tl.a_step.numpy(), np.asarray(jl.a_step),
                               rtol=QUANT_RTOL)
    jy = np.asarray(jl(jnp.asarray(x)), np.float32)
    ty = tl(torch.from_numpy(x))
    assert ty.dtype == torch.bfloat16 and ty.shape == (2, M, N)
    # same int32 lookup sums times scales an ulp apart, rounded to bf16:
    # at most one bf16 ulp (2^-7 relative) apart
    np.testing.assert_allclose(ty.float().numpy(), jy, rtol=2**-7, atol=0)
    # the serve params feed the serve path's linear unchanged
    jp, tp = jl.as_serve_params(), tl.as_serve_params()
    for k in ("table", "exec_idx", "step_cluster", "w_step", "a_step"):
        assert str(tp[k].dtype).replace("torch.", "") == str(jp[k].dtype), k
        assert tp[k].shape == jp[k].shape, k
    for k in ("table", "exec_idx", "step_cluster"):
        assert np.array_equal(tp[k].numpy(), np.asarray(jp[k])), k
    jcfg, tcfg = jsmoke("codeqwen1.5-7b"), tsmoke("codeqwen1.5-7b")
    assert (jcfg.tlmac_G, jcfg.quant.a_bits) == (4, 3)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jnn.serve_linear_apply(jp, xb, jcfg), np.float32)
    from repro_torch.convert import to_torch

    same = {k: to_torch(np.asarray(v), "cpu") for k, v in jp.items()}
    got = tnn.serve_linear_apply(same, to_torch(np.asarray(xb), "cpu"), tcfg)
    assert np.array_equal(got.float().numpy(), want)
    own = tnn.serve_linear_apply(tp, to_torch(np.asarray(xb), "cpu"), tcfg)
    np.testing.assert_allclose(own.float().numpy(), want, rtol=2**-7, atol=0)


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------


def test_port_imports_with_jax_and_reference_blocked():
    """Every module of the port, and chip_smoke.py, imports in a process
    where importing jax or the reference package raises."""
    code = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "repro", "flax"):
    sys.modules[name] = None          # import raises ImportError
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for m in mods:
    importlib.import_module(m)
sys.path.insert(0, ROOT)
import chip_smoke
assert not [m for m in sys.modules if m.split(".")[0] in
            ("jax", "jaxlib", "repro") and sys.modules[m] is not None]
print(len(mods))
""".replace("ROOT", repr(ROOT))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) > 25
