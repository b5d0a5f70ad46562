"""The port's collective matmuls and pipeline (``repro_torch.parallel``)
on 4 gloo ranks against the reference's ``shard_map`` versions on 4
forced host devices, on the same numpy inputs.

The JAX side runs once, in a subprocess with
``--xla_force_host_platform_device_count=4`` (``tests/test_parallel.py``'s
scriptlets, on saved inputs); the port's ranks are spawned processes in
one gloo group (``tests/_torch_ranks.py``).  Bounds are
``tests/test_parallel.py``'s: 1e-5 (all-gather ring), 1e-4
(reduce-scatter ring), 1e-5 (pipeline).  The collectives each rank
issued are read from ``comm_analysis.record_collectives``.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_ranks
from repro_torch.launch.comm_analysis import record_collectives
from repro_torch.launch.mesh import make_host_mesh, mesh_context
from repro_torch.parallel.overlap import ring_ag_matmul, ring_rs_matmul
from repro_torch.parallel.pipeline import pipeline_apply

ROOT = os.path.join(os.path.dirname(__file__), "..")
WORLD = 4
M, K, N = 32, 16, 24            # tests/test_parallel.py's ring shapes
S, MB, MBS, D = 4, 6, 8, 16     # stages, microbatches, their rows, width
AG_TOL, RS_TOL, PIPE_TOL = 1e-5, 1e-4, 1e-5

JAX_SCRIPT = """
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.launch.mesh import make_mesh_compat
from repro.parallel.overlap import ring_ag_matmul, ring_rs_matmul
from repro.parallel.pipeline import pipeline_apply
d = dict(np.load(sys.argv[1]))
model = make_mesh_compat((4,), ("model",))
pod = make_mesh_compat((4,), ("pod",))
out = dict(
    ag=np.asarray(ring_ag_matmul(jnp.asarray(d["x"]), jnp.asarray(d["w"]),
                                 model)),
    rs=np.asarray(ring_rs_matmul(jnp.asarray(d["x"]), jnp.asarray(d["w"]),
                                 model)),
    pipe=np.asarray(pipeline_apply(lambda w, x: jnp.tanh(x @ w),
                                   jnp.asarray(d["params"]),
                                   jnp.asarray(d["xs"]), pod)),
)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Inputs, the JAX outputs and the 4 ranks' outputs."""
    tmp = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(0)
    inputs = dict(
        x=rng.standard_normal((M, K), dtype=np.float32),
        w=rng.standard_normal((K, N), dtype=np.float32),
        params=(rng.standard_normal((S, D, D), dtype=np.float32)
                * np.float32(0.3)),
        xs=rng.standard_normal((MB, MBS, D), dtype=np.float32),
    )
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_SCRIPT),
         str(tmp / "in.npz"), str(tmp / "jax.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ranks = _torch_ranks.spawn_ranks(_torch_ranks.parallel_rank, WORLD,
                                     tmp, inputs)
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    return inputs, dict(np.load(tmp / "jax.npz")), ranks


def test_ring_ag_matmul_equals_jax(runs):
    inputs, jx, ranks = runs
    dense = inputs["x"].astype(np.float64) @ inputs["w"].astype(np.float64)
    for r in ranks:        # the whole product on every rank
        np.testing.assert_allclose(r["ag"], jx["ag"], rtol=AG_TOL,
                                   atol=AG_TOL)
        np.testing.assert_allclose(r["ag"], dense, rtol=AG_TOL, atol=AG_TOL)


def test_ring_rs_matmul_equals_jax(runs):
    _, jx, ranks = runs
    y = np.concatenate([r["rs"] for r in ranks])   # the out_spec's rows
    assert all(r["rs"].shape == (M // WORLD, N) for r in ranks)
    np.testing.assert_allclose(y, jx["rs"], rtol=RS_TOL, atol=RS_TOL)


def test_pipeline_equals_jax_and_sequential(runs):
    inputs, jx, ranks = runs
    ref = inputs["xs"]
    for s in range(S):
        ref = np.tanh(ref @ inputs["params"][s])
    for r in ranks:         # replicated to every stage
        np.testing.assert_allclose(r["pipe"], jx["pipe"], rtol=PIPE_TOL,
                                   atol=PIPE_TOL)
        np.testing.assert_allclose(r["pipe"], ref, rtol=PIPE_TOL,
                                   atol=PIPE_TOL)


def test_rings_issue_p2p_hops_only(runs):
    """Each rank sends its block n - 1 times and gathers nothing: the
    all-gather is on no critical path (the reference's schedule check)."""
    _, _, ranks = runs
    blk = (M // WORLD) * K * 4
    acc = (M // WORLD) * N * 4
    for r in ranks:
        for key, nbytes in (("ag_stats", blk), ("rs_stats", acc)):
            st = r[key]
            assert st.count_by_kind["collective-permute"] == WORLD - 1
            assert st.bytes_by_kind["collective-permute"] == (
                (WORLD - 1) * nbytes)
            assert st.total_bytes == (WORLD - 1) * nbytes
            assert st.count_by_kind["all-gather"] == 0


def test_pipeline_schedule_hops(runs):
    """S + M - 1 slots: every stage but the last hands on one microbatch
    a slot; one all-reduce replicates the collected outputs."""
    _, _, ranks = runs
    for rank, r in enumerate(ranks):
        st = r["pipe_stats"]
        hops = 0 if rank == S - 1 else S + MB - 1
        assert st.count_by_kind["collective-permute"] == hops
        assert st.bytes_by_kind["collective-permute"] == hops * MBS * D * 4
        assert st.count_by_kind["all-reduce"] == 1
        assert st.bytes_by_kind["all-reduce"] == MB * MBS * D * 4


def test_one_rank_is_the_plain_product():
    """World size 1 (one card): a hop is the identity, nothing is sent,
    and the rings are one product (as the reference's size-1 axis)."""
    mesh = make_host_mesh()
    try:
        g = torch.Generator().manual_seed(0)
        x = torch.randn((8, 16), generator=g)
        w = torch.randn((16, 12), generator=g)
        with mesh_context(mesh), record_collectives() as st:
            ag = ring_ag_matmul(x, w)
            rs = ring_rs_matmul(x, w)
            pipe = pipeline_apply(lambda p, v: torch.tanh(v @ p), w[:, :12]
                                  [:12], x[None, :, :12])
        assert torch.equal(ag, x @ w) and torch.equal(rs, x @ w)
        assert torch.equal(pipe[0], torch.tanh(x[:, :12] @ w[:12, :12]))
        assert st.count_by_kind["collective-permute"] == 0
        assert st.count_by_kind["all-reduce"] == 1
    finally:
        dist.destroy_process_group()
