"""The dry run's counted xLSTM scan: ``models.xlstm.chunked_scan`` on
``meta`` runs a few steps of each scan (and, under autograd, a few of its
checkpointed chunks) and counts the rest (``launch.comm_analysis.Work``,
``repeat``, ``repeated``, ``joined``), with placeholders of the bytes the
left-out steps would hold.

- **Equal to the full trace.**  xlstm-350m's smoke (one layer of 7 mLSTM
  and 1 sLSTM blocks), rank 0's train and prefill steps traced on a fake
  (2, 2) and (1, 4) mesh at 2, 3 and 5 chunks of ``CHUNK`` 8 steps, and at
  the real ``CHUNK`` 64 over 128 steps: the counted trace and the trace of
  every step (``COUNTED`` off) agree exactly in every field
  ``dryrun.traced_fields`` gives (cost, collectives with the backward
  split, kernel calls, output and alias bytes, temp bytes) and in
  ``peak_bytes``.
- **One scan alone.**  The mLSTM and sLSTM cells' scans traced alone (no
  grad, under autograd, inside a checkpointed layer), where their storages
  set the peak: counted and every-step traces agree in cost, peak and
  temp bytes.
- **Flat in length.**  The counted trace dispatches as many ops at 3
  chunks of train as at 64, and at 128 prefill steps as at 32768.
- **Real steps run every step.**  On the CPU an xLSTM block's train
  forward and backward go through the plain loop and equal, bit for bit,
  a copy of the loop as it was before the count.
"""

import dataclasses

import pytest
import torch
import torch.utils.checkpoint

from repro_torch.configs import smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.comm_analysis import trace_step
from repro_torch.launch.mesh import (fake_world, make_mesh_compat,
                                     mesh_context)
from repro_torch.models import nn, xlstm

import _torch_families  # noqa: F401  (one torch thread per worker)

ARCH = "xlstm-350m"
B = 4
# (kind, mesh, chunks, CHUNK): S = chunks x CHUNK
CASES = [(kind, mesh, n, 8) for kind in ("train", "prefill")
         for mesh in ((2, 2), (1, 4)) for n in (2, 3, 5)]
CASES += [("train", (2, 2), 2, 64), ("prefill", (2, 2), 2, 64)]


def _trace(kind, S, mesh=(2, 2), cfg=None):
    """Rank 0's step of the cell traced on ``meta`` under a fake group:
    its traced fields, peak bytes and dispatched ops."""
    cfg = cfg or smoke_config(ARCH)
    cell = ShapeConfig(kind, S, B, kind)
    with fake_world(mesh[0] * mesh[1]):
        m = make_mesh_compat(mesh, ("data", "model"), "cpu")
        with mesh_context(m):
            args = dryrun.step_args(cfg, cell, m)
            tr = dryrun.trace_cell(cfg, cell, m, args)
    return dict(dryrun.traced_fields(tr), peak_bytes=tr.peak_bytes), tr.ops


@pytest.mark.parametrize("kind,mesh,chunks,chunk", CASES)
def test_counted_trace_equals_full_trace(monkeypatch, kind, mesh, chunks,
                                         chunk):
    """Counted and every-step traces agree exactly, field by field."""
    monkeypatch.setattr(xlstm, "CHUNK", chunk)
    S = chunks * chunk
    got, ops = _trace(kind, S, mesh)
    monkeypatch.setattr(xlstm, "COUNTED", False)
    want, full_ops = _trace(kind, S, mesh)
    assert ops < full_ops
    for key in want:
        assert got[key] == want[key], key
    assert got["cost_analysis"]["flops"] > 0
    assert got["memory_analysis"]["temp_size_in_bytes"] > 0
    coll = got["hlo_collectives"]
    assert coll["count_by_kind"]["all-gather"] > 0
    if kind == "train":
        assert got["kernel_calls"] == {}
        assert coll["backward_count_by_kind"]["reduce-scatter"] > 0
    else:
        assert got["kernel_calls"]["tlmac_gemm_fused"] > 0


def _scan_step(block, S):
    """A step of one scan alone on ``meta`` (so its storages set the
    peak): the cell, its zero state, its inputs and the leaves a gradient
    is taken of."""
    g = lambda *s: torch.empty(s, device="meta", requires_grad=True)
    Bs, H, hd = 2, 2, 16
    if block == "mlstm":
        xs = (g(S, Bs, H, hd), g(S, Bs, H, hd), g(S, Bs, H, hd),
              g(S, Bs, H), g(S, Bs, H))
        st = xlstm.mlstm_zero_state(Bs, H, hd, device="meta")
        return (xlstm._mlstm_cell, {n: st[n] for n in ("C", "n", "m")}, xs,
                list(xs))
    d = H * hd
    params = {"r": {"w": g(4, H, hd, hd)}, "bias": {"b": g(4 * d)}}
    x4 = g(S, Bs, 4 * d)
    return ((lambda st, xt: xlstm._slstm_cell(params, st, xt, H)),
            xlstm.slstm_zero_state(Bs, d, device="meta"), x4,
            [x4, params["r"]["w"], params["bias"]["b"]])


def _scan_trace(block, S, mode):
    cell, state, xs, leaves = _scan_step(block, S)

    def body(xs, st):
        st, ys = xlstm.chunked_scan(cell, st, xs, S)
        return ys, st

    def step():
        if mode == "prefill":
            with torch.no_grad():
                return body(xs, state)
        ys, _ = (torch.utils.checkpoint.checkpoint(
            body, xs, state, use_reentrant=False) if mode == "remat"
            else body(xs, state))
        return torch.autograd.grad((ys * ys).sum(), leaves)

    tr = trace_step(step)
    return (tr.flops, tr.bytes_accessed, tr.transcendentals, tr.peak_bytes,
            tr.temp_bytes), tr.ops


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
@pytest.mark.parametrize("mode", ["prefill", "train", "remat"])
def test_counted_scan_alone_equals_full_scan(monkeypatch, block, mode):
    """One scan alone over 5 chunks, its storages the step's largest (no
    grad; under autograd; inside a checkpointed layer): counted and
    every-step traces
    agree in cost, peak and temp bytes, where a placeholder one step short
    or a step's work counted once too few would show."""
    monkeypatch.setattr(xlstm, "CHUNK", 8)
    got, ops = _scan_trace(block, 5 * 8, mode)
    monkeypatch.setattr(xlstm, "COUNTED", False)
    want, full_ops = _scan_trace(block, 5 * 8, mode)
    assert got == want and ops < full_ops


def test_counted_ops_flat_in_length():
    """At the real ``CHUNK`` the counted trace dispatches the same ops at
    3 and 64 chunks of train and at 128 and 32768 prefill steps, and the
    work it counts grows with the length."""
    short, ops_short = _trace("train", 3 * xlstm.CHUNK)
    long, ops_long = _trace("train", 64 * xlstm.CHUNK)
    assert ops_short == ops_long
    assert long["cost_analysis"]["flops"] > 20 * short["cost_analysis"][
        "flops"]
    assert long["hlo_collectives"]["count_by_kind"]["all-gather"] > 15 * (
        short["hlo_collectives"]["count_by_kind"]["all-gather"])
    short, ops_short = _trace("prefill", 2 * xlstm.CHUNK)
    long, ops_long = _trace("prefill", 32768)
    assert ops_short == ops_long
    assert long["memory_analysis"]["temp_size_in_bytes"] > 100 * short[
        "memory_analysis"]["temp_size_in_bytes"]


def _seed_chunked_scan(cell, state, xs, length):
    """``chunked_scan`` as it was before the count: every step, each chunk
    checkpointed under autograd."""
    def scan(cell, state, xs):
        ys = []
        for t in range((xs[0] if isinstance(xs, tuple) else xs).shape[0]):
            state, y = cell(state, tuple(a[t] for a in xs) if isinstance(
                xs, tuple) else xs[t])
            ys.append(y)
        return state, torch.stack(ys)

    if length <= xlstm.CHUNK or not torch.is_grad_enabled():
        return scan(cell, state, xs)
    ys = []
    for t0 in range(0, length, xlstm.CHUNK):
        chunk = (tuple(a[t0:t0 + xlstm.CHUNK] for a in xs)
                 if isinstance(xs, tuple) else xs[t0:t0 + xlstm.CHUNK])
        state, y = torch.utils.checkpoint.checkpoint(
            scan, cell, state, chunk, use_reentrant=False,
            preserve_rng_state=False)
        ys.append(y)
    return state, torch.cat(ys)


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_real_steps_run_every_step(monkeypatch, block):
    """A CPU train forward and backward of an xLSTM block over 3 chunks
    never reaches the counted scan and equals the loop before the count
    bit for bit (output and every gradient)."""
    monkeypatch.setattr(xlstm, "CHUNK", 8)
    cfg = dataclasses.replace(smoke_config(ARCH), d_model=32)
    gen = torch.Generator().manual_seed(0)
    init = xlstm.init_mlstm if block == "mlstm" else xlstm.init_slstm
    params = init(gen, cfg, device="cpu", linear_init=nn.init_linear)
    x = torch.randn((2, 24, cfg.d_model), generator=gen).to(torch.bfloat16)
    apply = xlstm.mlstm_apply if block == "mlstm" else xlstm.slstm_apply

    def run():
        leaves = [t.requires_grad_() for t in _float_leaves(params)]
        xi = x.clone().requires_grad_()
        y, state = apply(params, xi, cfg, apply_fn=nn.linear_apply)
        grads = torch.autograd.grad(y.float().square().sum(),
                                    [xi, *leaves], allow_unused=True)
        return [y, *state.values(), *grads]

    def refuse(*a, **k):
        raise AssertionError("a CPU step reached the counted scan")

    monkeypatch.setattr(xlstm, "_counted_scan", refuse)
    monkeypatch.setattr(xlstm, "_counted_chunks", refuse)
    got = run()
    monkeypatch.setattr(xlstm, "chunked_scan", _seed_chunked_scan)
    want = run()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == w.dtype and torch.equal(g, w)


def _float_leaves(tree):
    out = []
    for v in tree.values():
        if isinstance(v, dict):
            out += _float_leaves(v)
        elif v.is_floating_point():
            out.append(v)
    return out
