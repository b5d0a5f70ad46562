"""The dry run's traced step: ``launch.comm_analysis.trace_step`` (cost,
memory, collectives), ``launch.dryrun.trace_cell`` (rank 0's sharded step
on ``meta`` blocks under a fake process group) and the kernels' shape-only
paths on ``meta``.

- **Meta equals a real run.**  Four smoke cells on a (2, 2) mesh: a dense
  GQA train step with two accumulation microbatches, a MoE (and MLA)
  train step, a dense decode step and an enc-dec prefill.  Four spawned
  gloo ranks run each cell's real step on arguments drawn on the CPU
  (``dryrun.step_args(gen=)``), every op the card's (``nn.card_ops()``),
  under ``trace_step``; the test process traces the same cells on
  ``meta`` under ``fake_world(4)``.  Rank 0's collectives (count and
  bytes by kind, param and backward splits), flops, bytes accessed,
  transcendentals, kernel calls and output and alias bytes equal the meta
  trace's exactly, and so do the train cells' peak and temp bytes (they
  reach no kernel).  In the serve cells the CPU runs kernel 1's plain
  twin, which allocates temporaries (one-hot planes, gathered rows) the
  kernel does not: there meta's peak is at most the CPU run's.
- **Beside the reference.**  The reference's dry-run lowering
  (``_lower_train``/``_lower_decode``) of the dense train and decode cells
  compiled on 4 forced host devices in one subprocess: its
  ``memory_analysis``, ``cost_analysis`` and ``parse_collectives`` are
  printed beside the port's.  Output and alias bytes must agree (the same
  leaves in the same dtypes; XLA's CPU output buffer adds its output
  tuple's table, 8 bytes a leaf).  The rest differs by design (GSPMD's
  collectives, scan bodies counted once, XLA's fusions).
- **The long xLSTM cells are traced.**  ``run_cell`` of xlstm-350m's
  ``train_4k`` and ``prefill_32k`` (the config cut to its smoke, the real
  lengths and batches, the pod mesh) fills every traced field: the scan
  counts its steps on ``meta`` (``tests/test_torch_dryrun_scan.py``).
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

import _torch_ranks
from repro.launch.hlo_analysis import Roofline as JRoofline

from repro_torch.configs import smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import int8_experts as I8
from repro_torch.kernels import ops as kops
from repro_torch.kernels import tlmac_fused as tf
from repro_torch.launch import dryrun
from repro_torch.launch.comm_analysis import (Roofline, leaves,
                                              roofline_from_trace, trace_step)
from repro_torch.launch.mesh import (fake_world, make_mesh_compat,
                                     mesh_context)

import _torch_families  # noqa: F401  (one torch thread per worker)

ROOT = os.path.join(os.path.dirname(__file__), "..")
WORLD = 4
# name: (arch, config overrides, kind, S, B, mesh)
CELLS = {
    "dense-train-accum2": ("codeqwen1.5-7b", {"train_accum": 2}, "train",
                           32, 8, (2, 2)),
    "moe-mla-train": ("deepseek-v3-671b", {}, "train", 32, 8, (2, 2)),
    "dense-decode": ("codeqwen1.5-7b", {}, "decode", 32, 8, (2, 2)),
    "encdec-prefill": ("seamless-m4t-medium", {}, "prefill", 32, 8, (2, 2)),
}
SERVE = ("dense-decode", "encdec-prefill")
REF_CELLS = ("dense-train-accum2", "dense-decode")
XLA_TUPLE_ENTRY = 8     # bytes of XLA's output tuple table, a leaf

REF_SCRIPT = """
import dataclasses, json, sys
import jax
jax.devices()                       # 4 forced host devices, before the
import repro.launch.dryrun as D     # dry run's own 512-device flag
from repro.configs import smoke_config
from repro.configs.base import ShapeConfig
from repro.launch.hlo_analysis import parse_collectives
from repro.launch.mesh import make_mesh_compat, mesh_context

cells, out = json.loads(sys.argv[1]), {}
for name, (arch, over, kind, S, B, shape) in cells.items():
    cfg = dataclasses.replace(smoke_config(arch), **over)
    mesh = make_mesh_compat(tuple(shape), ("data", "model"))
    lower = {"train": D._lower_train, "prefill": D._lower_prefill,
             "decode": D._lower_decode}[kind]
    with mesh_context(mesh):
        lowered, mult = lower(cfg, ShapeConfig(name, S, B, kind), mesh)
        c = lowered.compile()
    coll = parse_collectives(c.as_text(), loop_multiplier=mult)
    out[name] = {"memory_analysis": D._mem_dict(c),
                 "cost_analysis": D._cost_dict(c),
                 "hlo_collectives": {"count_by_kind": coll.count_by_kind,
                                     "bytes_by_kind": coll.bytes_by_kind,
                                     "loop_multiplier": mult}}
json.dump(out, open(sys.argv[2], "w"))
"""


def _meta_trace(name):
    """The dry run's trace of a cell on ``meta``, rank 0 of a fake
    4-rank group."""
    arch, over, kind, S, B, shape = CELLS[name]
    cfg = dataclasses.replace(smoke_config(arch), **over)
    cell = ShapeConfig(name, S, B, kind)
    with fake_world(WORLD):
        mesh = make_mesh_compat(shape, ("data", "model"), "cpu")
        with mesh_context(mesh):
            args = dryrun.step_args(cfg, cell, mesh)
            trace = dryrun.trace_cell(cfg, cell, mesh, args)
            arg_bytes = dryrun._local_bytes(args, mesh)
    return dict(dryrun.traced_fields(trace), peak_bytes=trace.peak_bytes,
                output_leaves=sum(1 for _ in leaves(trace.outputs)),
                args=arg_bytes)


@pytest.fixture(scope="module")
def held(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_trace")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}")
    ref_cells = json.dumps({k: CELLS[k] for k in REF_CELLS})
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REF_SCRIPT), ref_cells,
         str(tmp / "ref.json")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=ROOT)
    try:
        ranks = _torch_ranks.spawn_ranks(_torch_ranks.dryrun_trace_rank,
                                         WORLD, tmp, CELLS)
        meta = {name: _meta_trace(name) for name in CELLS}
        err = proc.communicate(timeout=600)[1]
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    with open(tmp / "ref.json") as f:
        ref = json.load(f)
    return dict(ranks=ranks, meta=meta, ref=ref)


@pytest.mark.parametrize("name", list(CELLS))
def test_meta_trace_equals_real_step(held, name):
    """Rank 0's real step (4 gloo ranks, the card's ops on the CPU) and
    the dry run's meta trace of it count the same collectives, cost,
    kernel calls and output and alias bytes; the same peak and temp bytes
    in the train cells, at most the CPU run's in the serve cells."""
    got, want = held["meta"][name], held["ranks"][0][name]
    assert got["hlo_collectives"] == want["hlo_collectives"]
    assert got["cost_analysis"] == want["cost_analysis"]
    assert got["kernel_calls"] == want["kernel_calls"]
    mem, real = got["memory_analysis"], want["memory_analysis"]
    for key in ("output_size_in_bytes", "alias_size_in_bytes",
                "port_output_size_in_bytes", "port_alias_size_in_bytes"):
        assert mem[key] == real[key], key
    assert got["hlo_collectives"]["total_bytes"] > 0
    assert got["cost_analysis"]["flops"] > 0
    if name in SERVE:
        # the CPU's plain twin of kernel 1 allocates what the kernel does not
        assert got["kernel_calls"]["tlmac_gemm_fused"] > 0
        assert 0 < mem["temp_size_in_bytes"] <= real["temp_size_in_bytes"]
        assert got["peak_bytes"] <= want["peak_bytes"]
    else:
        assert got["kernel_calls"] == {}
        assert got["hlo_collectives"]["backward_count_by_kind"][
            "reduce-scatter"] > 0
        assert mem["temp_size_in_bytes"] == real["temp_size_in_bytes"] > 0
        assert got["peak_bytes"] == want["peak_bytes"]
        # params and moments are updated in place: all donated
        assert mem["alias_size_in_bytes"] == (
            got["args"]["by_argument"]["params"]
            + got["args"]["by_argument"]["opt_state"])
    if name == "dense-decode":       # the caches are written in place
        assert mem["alias_size_in_bytes"] == got["args"]["by_argument"][
            "caches"]


@pytest.mark.parametrize("name", REF_CELLS)
def test_beside_reference(held, name, capsys):
    """The reference's compiled step of the same cell on 4 host devices
    beside the port's trace: output and alias bytes agree (XLA's output
    buffer adds 8 bytes a leaf for its tuple table); the rest is printed
    (GSPMD's collectives, scan bodies counted once, fusions)."""
    ref, got = held["ref"][name], held["meta"][name]
    mem = got["memory_analysis"]
    with capsys.disabled():
        print(f"\n{name}: reference memory {ref['memory_analysis']}\n"
              f"  port memory {mem} (arguments "
              f"{got['args']['argument_size_in_bytes']})\n"
              f"  reference cost {ref['cost_analysis']}\n"
              f"  port cost {got['cost_analysis']}\n"
              f"  reference collectives {ref['hlo_collectives']}\n"
              f"  port collectives {got['hlo_collectives']['count_by_kind']}"
              f" {got['hlo_collectives']['bytes_by_kind']}")
    rmem = ref["memory_analysis"]
    assert rmem["output_size_in_bytes"] == (
        mem["output_size_in_bytes"]
        + XLA_TUPLE_ENTRY * got["output_leaves"])
    assert rmem["alias_size_in_bytes"] == mem["alias_size_in_bytes"]


def _plan(E=0, M=4, G=4, kg=8, n_tiles=2, dp=16, n_clus=2, n_arr=32,
          seed=0):
    """Kernel 1's operands at a small shape (a leading E: an expert
    stack), on the CPU."""
    g = torch.Generator().manual_seed(seed)
    lead = (E,) if E else ()
    a = torch.randint(0, 8, (*lead, M, kg * G), generator=g,
                      dtype=torch.int8)
    idx = torch.randint(0, n_arr, (*lead, n_tiles, kg, dp), generator=g,
                        dtype=torch.uint8)
    cl = torch.randint(0, n_clus, (*lead, n_tiles, kg), generator=g,
                       dtype=torch.int8)
    tab = torch.randint(-100, 100, (*lead, n_clus, n_arr, 2**G),
                        generator=g, dtype=torch.int8)
    return a, idx, cl, tab


def _gemm_work(a, idx, cl, tab, G):
    """``chip_smoke._gemm_bound``'s work of one lookup GEMM: the one-hot
    product's ``2 M 2^G kg N`` and the bytes read and written."""
    n_tiles, kg, dp = idx.shape[-3:]
    rows, N = a.numel() // a.shape[-1], n_tiles * dp
    nbytes = (a.numel() + idx.numel() * idx.element_size() + cl.numel()
              + tab.numel() * tab.element_size() + rows * N * 4)
    return 2 * rows * 2**G * kg * N, nbytes


CALLS = {
    "tlmac-single": lambda: (tf.tlmac_gemm_fused, _plan(),
                             dict(B_a=3, G=4), "tlmac_gemm_fused"),
    "tlmac-experts": lambda: (tf.tlmac_gemm_fused, _plan(E=3),
                              dict(B_a=3, G=4), "tlmac_gemm_fused"),
    "int8-experts": lambda: (I8.int8_experts_matmul, tuple(
        torch.randint(-128, 128, s, generator=torch.Generator().manual_seed(
            1), dtype=torch.int8) for s in ((3, 5, 24), (3, 24, 40))), {},
        "int8_experts_matmul"),
}


@pytest.mark.parametrize("case", list(CALLS))
def test_shape_only_kernel_paths(case):
    """On ``meta`` a kernel wrapper gives its CPU twin's output shape and
    dtype, no values, and notes the work of ``_gemm_bound`` (kernel 1) or
    ``2 E M K N`` (the int8 stack); the CPU call notes the same, and the
    twin's own ops inside the note are not counted again."""
    fn, args, kw, label = CALLS[case]()
    cpu = trace_step(lambda *a: fn(*a, **kw), *args)
    meta = trace_step(lambda *a: fn(*a, **kw), *(t.to("meta") for t in args))
    want = cpu.outputs
    assert meta.outputs.device.type == "meta"
    assert meta.outputs.shape == want.shape
    assert meta.outputs.dtype == want.dtype == torch.int32
    if label == "tlmac_gemm_fused":
        assert torch.equal(want, tf.tlmac_gemm_fused_plain(*args, **kw))
        flops, nbytes = _gemm_work(*args, G=kw["G"])
    else:
        assert torch.equal(want, I8.int8_experts_matmul_plain(*args))
        (E, M, K), N = args[0].shape, args[1].shape[2]
        flops, nbytes = 2 * E * M * K * N, args[0].numel() + \
            args[1].numel() + E * M * N * 4
    for tr in (cpu, meta):
        assert tr.kernels == {label: 1}
        assert (tr.flops, tr.bytes_accessed, tr.transcendentals) == (
            flops, nbytes, 0)
    assert meta.peak_bytes == want.numel() * 4


class _Elsewhere(torch.Tensor):
    """A tensor on a device the wrappers cannot shape (XLA), no data."""

    @staticmethod
    def __new__(cls, t):
        return torch.Tensor._make_wrapper_subclass(cls, t.shape,
                                                   dtype=t.dtype,
                                                   device="xla")

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"no data for {func}")


def test_kernels_refuse_other_devices_and_bad_meta_operands():
    """A device other than the CPU, the card and ``meta`` raises before
    any note; on ``meta`` the operands are checked as on the card (an
    int32 table is refused)."""
    a, idx, cl, tab = _plan()
    with pytest.raises(ValueError, match="unsupported device"):
        tf.tlmac_gemm_fused(*map(_Elsewhere, (a, idx, cl, tab)), B_a=3, G=4)
    w = torch.zeros(1, 8, 4, dtype=torch.int8)
    with pytest.raises(ValueError, match="unsupported device"):
        I8.int8_experts_matmul(_Elsewhere(a[None, :, :8].contiguous()),
                               _Elsewhere(w))
    meta = [t.to("meta") for t in (a, idx, cl, tab.to(torch.int32))]
    with pytest.raises(ValueError, match="narrow table rows"):
        tf.tlmac_gemm_fused(*meta, B_a=3, G=4)
    with pytest.raises(ValueError, match="K="):
        tf.tlmac_gemm_fused(a.to("meta")[:, :8], *meta[1:3],
                            tab.to("meta"), B_a=3, G=4)


def test_auto_resolves_on_meta_without_tuning(monkeypatch):
    """``'auto'`` on ``meta`` misses the cache and dispatches kernel 1,
    even where a miss would tune."""
    def no_tuning(*a, **k):
        raise AssertionError("tuned on meta")

    monkeypatch.setattr(kops.autotune, "tune", no_tuning)
    a, idx, cl, tab = (t.to("meta") for t in _plan())
    tr = trace_step(lambda: kops.tlmac_matmul(
        a, tab, idx, cl, B_a=3, G=4, N=32, impl="auto", tune_on_miss=True))
    assert tr.kernels == {"tlmac_gemm_fused": 1}
    assert tr.outputs.shape == (4, 32)


def test_trace_step_conventions():
    """The cost conventions on a small step: a product's ``2 M N K``, one
    flop an output element of an arithmetic op, transcendentals apart,
    views free, operand and output bytes of every other op; the peak and
    temp bytes of the storages the step makes; donated outputs alias."""
    x = torch.ones(4, 8)
    w = torch.ones(8, 16)
    acc = torch.zeros(4, 16)

    def step(x, w, acc):
        y = x @ w                       # 2*4*8*16 flops, (32+128+64)*4 B
        z = torch.exp(y.view(64))       # 64 transcendentals, 128*4 B
        acc.add_(z.view(4, 16))         # 64 flops, in place: 192*4 B
        return acc, z.sum()

    for dev in ("cpu", "meta"):
        args = [t.to(dev) for t in (x, w, acc)]
        tr = trace_step(step, *args, donated=(2,))
        assert tr.flops == 2 * 4 * 8 * 16 + 64
        assert tr.transcendentals == 64
        assert tr.bytes_accessed == 4 * ((32 + 128 + 64) + 128 + 192
                                         + (64 + 1))
        assert tr.peak_bytes == 4 * (64 + 64 + 1)   # y, z and the sum
        assert tr.temp_bytes == 4 * (64 + 64)       # less the output
        assert tr.aliased(tr.outputs[0]) and not tr.aliased(tr.outputs[1])
        assert tr.collectives.total_bytes == 0


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_long_xlstm_scans_are_traced(monkeypatch, shape):
    """``run_cell`` of xlstm-350m's train_4k and prefill_32k (the config
    cut to its smoke, the pod mesh) traces the step: every traced field is
    filled, no reason is left for one."""
    monkeypatch.setattr(dryrun, "get_config", smoke_config)
    res = dryrun.run_cell("xlstm-350m", shape, False)
    assert res["ok"], res.get("error")
    assert res["trace_s"] > 0 and res["trace_ops"] > 0
    mem = res["memory_analysis"]
    for key in ("output_size_in_bytes", "temp_size_in_bytes",
                "total_nonalias_bytes"):
        assert mem[key] > 0, key
    # training updates params and moments in place; prefill donates none
    assert (mem["alias_size_in_bytes"] > 0) == (shape == "train_4k")
    assert res["cost_analysis"]["flops"] > 0
    assert res["hlo_collectives"]["total_bytes"] > 0
    assert not set(dryrun.TRACED_FIELDS) & set(res["reasons"])


def test_roofline_from_trace():
    """``roofline_from_trace`` gives ``Roofline``'s fields (the
    reference's ``roofline_from_compiled``'s meanings) from a trace."""
    tr = trace_step(lambda x: (x @ x).sum(), torch.ones(8, 8))
    rl = roofline_from_trace(tr, n_chips=4, model_flops=100.0)
    want = Roofline(flops=tr.flops, hbm_bytes=tr.bytes_accessed,
                    collective_bytes=0.0, n_chips=4, model_flops=100.0)
    assert rl.as_dict() == want.as_dict()
    assert rl.flops == 2 * 8 * 8 * 8 + 0 and rl.hbm_bytes > 0
    ref = JRoofline(flops=tr.flops, hbm_bytes=tr.bytes_accessed,
                    collective_bytes=0.0, n_chips=4, model_flops=100.0)
    assert set(ref.as_dict()) <= set(rl.as_dict())
