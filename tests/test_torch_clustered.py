"""The cluster-scheduled lookup GEMM's algebra (kernels 5-6) on the CPU:
the kernel's one-hot decomposition in plain torch
(``tlmac_gemm_clustered_onehot_plain``: narrow slice, coef x the rows a
(tile, cluster) run selects, padding skipped) held int32-equal to the
reference's ``run_clustered`` / ``run_clustered_multi`` (Pallas, interpret
mode) and to the port's plain versions, and the narrow ``table_pad`` that
``device_schedule`` makes once."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tlmac import compile as jtc
from repro.kernels import tlmac_clustered as jcl
from repro.models import resnet as JR

from repro_torch.core.tlmac import compile as ttc
from repro_torch.kernels import bitplanes as tbp
from repro_torch.kernels import tlmac_clustered as tcl
from repro_torch.models import resnet as TR

from _torch_parity import plans_equal

# (K, N, M, B_w, B_a, G, d_p, bk): the reference's clustered shapes
# (tests/test_kernels.py, tests/test_fused_autotune.py), then B_a 1 and 8
# (coef up to 255) and G 2 and 6 (4 and 64 coef bytes per step)
CASES = [(64, 64, 21, 3, 3, 4, 64, 4), (24, 32, 7, 2, 2, 3, 32, 2),
         (48, 128, 9, 4, 4, 4, 128, 8), (64, 128, 21, 3, 3, 4, 64, 4),
         (24, 96, 7, 2, 2, 3, 32, 2), (48, 128, 9, 4, 4, 4, 128, 8),
         (32, 64, 9, 3, 1, 4, 32, 8), (24, 64, 13, 3, 8, 3, 64, 8),
         (16, 64, 7, 2, 3, 2, 32, 8), (48, 64, 5, 4, 4, 6, 64, 8),
         (48, 128, 6, 3, 8, 6, 64, 2)]


def _plans(K, N, B_w, B_a, G, d_p, seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(-(2 ** (B_w - 1)), 2 ** (B_w - 1), size=(K, N))
    plan = ttc.compile_layer(w, B_w=B_w, B_a=B_a, G=G, d_p=d_p,
                             anneal_iters=100, seed=0)
    jplan = jtc.compile_layer(w, B_w=B_w, B_a=B_a, G=G, d_p=d_p,
                              anneal_iters=100, seed=0)
    plans_equal(plan, jplan)
    return w, plan, jplan


def _all_forms(plan, a, B_a, n_tiles, bk, tiled):
    """The port's three CPU forms of the kernel on one schedule: the plain
    version, the one-hot decomposition, and the wrapper (plain on CPU)."""
    s = tcl.device_schedule(plan, n_tiles, bk, "cpu", tiled=tiled)
    cs = tbp.pack_bitplanes(torch.from_numpy(a.astype(np.int8)), B_a=B_a,
                            G=plan.G).index_select(2, s["cols"])
    idx, tab = s["idx_sorted"], s["table_pad"]
    if tiled:
        plain = tcl.tlmac_gemm_clustered_multi_plain(cs, idx, tab, B_a=B_a,
                                                     G=plan.G)
        wrapped = tcl.tlmac_gemm_clustered_multi(cs, idx, tab, B_a=B_a,
                                                 G=plan.G)
    else:
        plain = tcl.tlmac_gemm_clustered_plain(cs, idx, tab, B_a=B_a,
                                               G=plan.G)
        wrapped = tcl.tlmac_gemm_clustered(cs, idx, tab, B_a=B_a, G=plan.G)
    onehot = tcl.tlmac_gemm_clustered_onehot_plain(cs, idx, tab, B_a=B_a,
                                                   G=plan.G)
    return plain, onehot, wrapped


@pytest.mark.parametrize("K,N,M,B_w,B_a,G,d_p,bk", CASES)
def test_onehot_form_equals_jax_and_plain(K, N, M, B_w, B_a, G, d_p, bk):
    w, plan, jplan = _plans(K, N, B_w, B_a, G, d_p, K + N + B_a)
    a = np.random.default_rng(M).integers(0, 2**B_a, size=(M, K))
    dense = a.astype(np.int64) @ w
    n_tiles = N // d_p
    want = np.asarray(jcl.run_clustered_multi(jplan, a, B_a=B_a, N=N, bk=bk,
                                              bm=16))
    assert np.array_equal(want, dense)
    for got in _all_forms(plan, a, B_a, n_tiles, bk, tiled=True):
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    if n_tiles == 1:
        want1 = np.asarray(jcl.run_clustered(jplan, a, B_a=B_a, bk=bk, bm=16))
        assert np.array_equal(want1, dense)
        for got in _all_forms(plan, a, B_a, 1, bk, tiled=False):
            assert np.array_equal(got.numpy(), want1)


def test_onehot_form_on_a_conv_plan_with_two_output_tiles():
    """A conv plan as the ResNet path compiles it (G = 3, D_p = 192 = 64
    output channels x 3 kernel rows), two output tiles, on 1x3 windows."""
    cfg = TR.ResNetConfig(width=8, stages=((128, 1, 1),))
    w_codes = np.random.default_rng(3).integers(-4, 4, size=(128, 8, 3, 3))
    plan = ttc.compile_layer(w_codes, B_w=cfg.w_bits, B_a=cfg.a_bits, d_p=64,
                             anneal_iters=100, seed=0)
    jplan = jtc.compile_layer(w_codes, B_w=cfg.w_bits, B_a=cfg.a_bits, d_p=64,
                              anneal_iters=100, seed=0)
    plans_equal(plan, jplan)
    assert (plan.G, plan.D_p, plan.D_s // 8) == (3, 192, 2)
    img = np.random.default_rng(4).integers(0, 8, size=(2, 5, 5, 8))
    win = TR.conv_windows(torch.from_numpy(img.astype(np.int8))).numpy()
    want = np.array(jcl.run_clustered_multi(jplan, win, B_a=3, N=384,
                                            bm=16))
    for got in _all_forms(plan, win, 3, 2, 8, tiled=True):
        assert np.array_equal(got.numpy(), want)
    # de-interleaved kernel rows summed into the conv equal the integer conv
    rows = torch.from_numpy(want).reshape(2, 5, 5, 2, 64, 3)
    conv = TR.combine_row_sums([rows[..., r].reshape(2, 5, 5, 128)
                                for r in range(3)])
    assert torch.equal(conv, TR.tlmac_conv_forward(
        plan, torch.from_numpy(img.astype(np.int8)), cfg.quant))
    assert np.array_equal(conv.numpy(), np.asarray(JR.tlmac_conv_forward(
        jplan, jnp.asarray(img), cfg.quant)))


@pytest.mark.parametrize("scale,dtype", [(1, torch.int8), (40, torch.int16)])
def test_device_schedule_narrows_table_pad_and_keeps_every_value(scale,
                                                                 dtype):
    w, plan, _ = _plans(64, 128, 3, 3, 4, 64, 0)
    plan = dataclasses.replace(plan, table=plan.table * scale,
                               device_cache={})
    assert (np.abs(plan.table).max() > 127) == (dtype == torch.int16)
    for tiled, n_tiles in ((True, 2), (False, 1)):
        s = tcl.device_schedule(plan, n_tiles, 8, "cpu", tiled=tiled)
        want = (tcl.cluster_schedule_tiled(plan, n_tiles) if tiled
                else tcl.cluster_schedule(plan))["table_pad"]
        assert s["table_pad"].dtype == dtype
        assert np.array_equal(s["table_pad"].numpy().astype(np.int32), want)
    a = np.random.default_rng(1).integers(0, 8, size=(6, 64))
    plain, onehot, _ = _all_forms(plan, a, 3, 2, 8, tiled=True)
    dense = torch.from_numpy(a @ (w * scale))
    assert torch.equal(plain, dense.to(torch.int32))
    assert torch.equal(onehot, plain)


def test_onehot_form_skips_padding_whatever_its_codes():
    """Steps after a run's last real row add nothing, whatever codes sit
    there: the decomposition never reads them."""
    _, plan, _ = _plans(64, 128, 3, 3, 4, 64, 0)
    s = tcl.device_schedule(plan, 2, 8, "cpu", tiled=True)
    a = np.random.default_rng(2).integers(0, 8, size=(5, 64))
    cs = tbp.pack_bitplanes(torch.from_numpy(a.astype(np.int8)), B_a=3,
                            G=4).index_select(2, s["cols"])
    pad = (s["idx_sorted"] == s["table_pad"].shape[1] - 1).all(-1)
    assert bool(pad.any())           # the schedule does pad some runs
    noisy = cs.clone()
    noisy[:, :, pad.reshape(-1)] = 15
    kw = dict(B_a=3, G=4)
    want = tcl.tlmac_gemm_clustered_multi_plain(cs, s["idx_sorted"],
                                                s["table_pad"], **kw)
    assert torch.equal(tcl.tlmac_gemm_clustered_onehot_plain(
        noisy, s["idx_sorted"], s["table_pad"], **kw), want)
