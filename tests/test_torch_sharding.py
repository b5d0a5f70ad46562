"""The port's partition specs and shardings (``repro_torch.parallel
.sharding``, the specs every init tags its leaves with, ``lm.param_axes``
and ``lm.cache_axes_tree``) against the reference's, and the parallel
config fields.

- every field the two ``ArchConfig``s share, ``SHAPES``, ``list_archs``
  and the analytic parameter counts equal the reference's;
- ``_filter_spec``, ``filter_specs`` and ``batch_spec`` equal JAX's on a
  table of specs;
- every param leaf's spec equals JAX's ``init_lm`` axes for the ten LM
  configs at full size, both purposes (JAX's side by ``eval_shape``; the
  port's from a meta init); every cache leaf's equals ``init_caches``'
  axes, dense and paged (fp and int8 pools);
- a real init tags the same specs as the meta init, with the same shapes;
- ``shard_hint`` is a no-op without a mesh and under a 1x1 mesh (a smoke
  forward's logits bit-equal), and raises on a plain tensor under a
  larger one; a dim that does not divide its shard count is refused.
"""

import dataclasses
import types

import pytest
import torch
import torch.distributed as dist

import jax
from jax.sharding import PartitionSpec as JP

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget
from repro.configs import list_archs as jlist
from repro.configs import smoke_config as jsmoke
from repro.kernels.paged import PageSpec as JPageSpec
from repro.models import lm as jlm
from repro.parallel import sharding as jsh

from repro_torch.configs import SHAPES, get_config, list_archs, smoke_config
from repro_torch.kernels.paged import PageSpec
from repro_torch.launch.mesh import (fake_world, make_host_mesh,
                                     make_mesh_compat, make_production_mesh,
                                     mesh_context)
from repro_torch.models import lm
from repro_torch.parallel import sharding as tsh
from repro_torch.parallel.sharding import P, NamedSharding

import _torch_families  # noqa: F401  (one torch thread per worker)

ARCHS = [a for a in jlist() if a != "resnet18"]


def _norm(spec):
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e
                 for e in spec)


def _flat(tree, path=()):
    """(path, leaf) of nested dicts and lists/tuples, specs as leaves."""
    if isinstance(tree, (JP, P)):
        yield path, _norm(tree)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (i,))
    else:
        yield path, tree


def _specs_equal(jtree, ttree, port_only=("table_narrow",)):
    J, T = dict(_flat(jtree)), dict(_flat(ttree))
    extra = {p for p in T if p not in J}
    assert all(p[-1] in port_only for p in extra), sorted(extra)[:5]
    assert set(J) <= set(T), sorted(set(J) - set(T))[:5]
    bad = {p: (J[p], T[p]) for p in J if J[p] != T[p]}
    assert not bad, list(bad.items())[:5]
    return len(J)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_reference(arch):
    for jf, tf in ((jget, get_config), (jsmoke, smoke_config)):
        j, t = jf(arch), tf(arch)
        shared = ({f.name for f in dataclasses.fields(j)}
                  & {f.name for f in dataclasses.fields(t)})
        assert {"fsdp", "pure_fsdp", "supports_long", "remat",
                "opt_state_dtype"} <= shared
        diff = {n: (getattr(j, n), getattr(t, n)) for n in shared
                if n != "quant" and getattr(j, n) != getattr(t, n)}
        assert not diff, diff
        assert dataclasses.astuple(j.quant) == dataclasses.astuple(t.quant)
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()


def test_shapes_and_registry_equal_reference():
    assert list_archs() == jlist()
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in JSHAPES.items()}


SPECS = [
    P(), P(None), P("model"), P(None, "model"), P("model", None),
    P(("pod", "data"), None), P(("pod", "data"), "model", None),
    P(("data", "model"), None, None), P("model", None, ("pod", "data"), None),
    P(None, None, "model", None), P("pod", ("data", "model")),
]
AXES = [set(), {"model"}, {"data", "model"}, {"pod", "data", "model"},
        {"pod"}]


def test_filter_spec_table_equals_jax():
    for spec in SPECS:
        for axes in AXES:
            want = _norm(jsh._filter_spec(JP(*spec), axes))
            assert _norm(tsh._filter_spec(spec, axes)) == want, (spec, axes)
    assert _norm(tsh.batch_spec()) == _norm(jsh.batch_spec())


def test_filter_specs_tree_equals_jax():
    tree = {"a": SPECS[:4], "b": {"c": SPECS[5], "d": [SPECS[8]]}}
    jtree = jax.tree.map(lambda s: JP(*s), tree,
                         is_leaf=lambda s: isinstance(s, P))
    for names in (("data", "model"), ("pod", "data", "model")):
        jm = types.SimpleNamespace(axis_names=names)
        tm = types.SimpleNamespace(mesh_dim_names=names)
        want = dict(_flat(jsh.filter_specs(jtree, jm)))
        assert dict(_flat(tsh.filter_specs(tree, tm))) == want


def _jax_axes(cfg, purpose):
    holder = {}

    def f(k):
        p, a = jlm.init_lm(k, cfg, purpose)
        holder["a"] = a
        return p

    jax.eval_shape(f, jax.random.PRNGKey(0))
    return holder["a"]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_equal_reference(arch):
    """Every param leaf's spec at full size, train and serve."""
    for purpose in ("train", "serve"):
        n = _specs_equal(_jax_axes(jget(arch), purpose),
                         lm.param_axes(get_config(arch), purpose))
        assert n > 20


def _jax_cache_axes(cfg, paged=None):
    holder = {}

    def f():
        c, a = jlm.init_caches(cfg, 2, 32, 4 if cfg.n_enc_layers else 0,
                               paged=paged)
        holder["a"] = a
        return c

    jax.eval_shape(f)
    return holder["a"]


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_axes_equal_reference(arch):
    """Dense caches, and the paged pools (fp and int8) of the families
    that page."""
    _specs_equal(_jax_cache_axes(jget(arch)),
                 lm.cache_axes_tree(get_config(arch)))
    if not lm.supports_paged(get_config(arch)):
        return
    for kv in ("fp", "int8"):
        jc = dataclasses.replace(jget(arch), serve_kv_dtype=kv)
        tc = dataclasses.replace(get_config(arch), serve_kv_dtype=kv)
        n = _specs_equal(_jax_cache_axes(jc, JPageSpec(16, 8, 2)),
                         lm.cache_axes_tree(tc, paged=PageSpec(16, 8, 2)))
        assert n == len(lm.segments_for(tc)) * (2 if kv == "fp" else 4)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "xlstm-350m",
                                  "recurrentgemma-2b", "seamless-m4t-medium",
                                  "minicpm-2b"])
def test_real_init_carries_the_meta_specs(arch):
    """The meta init (the dry run's) has the real init's structure,
    shapes, dtypes and specs; a real serve init's caches too."""
    cfg = smoke_config(arch)
    for purpose in ("train", "serve"):
        meta = lm.init_tree(cfg, torch.Generator(), purpose, "meta")
        real = lm.init_tree(cfg, torch.Generator().manual_seed(0), purpose,
                            "cpu")
        M, R = dict(_flat(meta)), dict(_flat(real))
        assert M.keys() == R.keys()
        for p in M:
            assert (M[p].shape, M[p].dtype) == (R[p].shape, R[p].dtype), p
            assert tsh.spec_of(M[p]) == tsh.spec_of(R[p]), p
        assert tsh.spec_tree(meta) == lm.param_axes(cfg, purpose)
    caches = lm.init_caches(cfg, device="meta", B=2, S_max=8,
                            enc_len=4 if cfg.n_enc_layers else 0)
    shapes = {p: len(v.shape) for p, v in _flat(caches)}
    specs = dict(_flat(lm.cache_axes_tree(cfg)))
    assert shapes.keys() == specs.keys()
    assert all(len(specs[p]) == shapes[p] for p in shapes)


def _smoke_logits(cfg, params):
    tokens = torch.tensor([[1, 5, 9, 3, 7, 2]], dtype=torch.int32)
    return lm.forward(params, {"tokens": tokens}, cfg)[1]


def test_shard_hint_noop_without_mesh_and_on_a_host_mesh():
    """The eight hint sites leave the forward bit-equal: no mesh, and a
    1x1 mesh (axes of size 1)."""
    cfg = smoke_config("codeqwen1.5-7b")
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), "train",
                        device="cpu")
    with torch.no_grad():
        plain = _smoke_logits(cfg, params)
        x = torch.randn(2, 3, 4)
        assert tsh.shard_hint(x, P(("pod", "data"), None, None)) is x
        mesh = make_host_mesh()
        try:
            with mesh_context(mesh):
                assert tsh._active_axes() == {"data", "model"}
                assert tsh.shard_hint(x, P("model")) is x
                hinted = _smoke_logits(cfg, params)
        finally:
            dist.destroy_process_group()
    assert tsh._active_axes() is None
    assert torch.equal(plain, hinted)


def test_shard_hint_refuses_plain_tensors_under_a_larger_mesh():
    """A hint the sharded code does not hold raises under a mesh of more
    than one device, and so does the train forward of a model the sharded
    step does not cover (xlstm's mLSTM with heads that divide the 'model'
    axis: the state's ``h_ok`` layout, which no reference config has)."""
    cfg = dataclasses.replace(smoke_config("xlstm-350m"), n_heads=16)
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), "train",
                        device="cpu")
    with fake_world(4):
        mesh = make_mesh_compat((2, 2), ("data", "model"), "cpu")
        with mesh_context(mesh):
            with pytest.raises(NotImplementedError, match="not run sharded"):
                tsh.shard_hint(torch.zeros(4, 2), P("data", None))
            with pytest.raises(NotImplementedError):
                with torch.no_grad():
                    _smoke_logits(cfg, params)
        assert mesh.size() == 4


def test_uneven_dims_are_refused_and_placements_split_pod_major():
    """minicpm's odd vocab cannot shard 16 ways (JAX refuses it at
    lowering; DTensor would split it unevenly); a ('pod', 'data') dim is
    split pod-major, rank r holding the rows JAX's device r holds."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    with fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        sh = NamedSharding(mesh, P("model", None))
        with pytest.raises(ValueError, match="divides by 16"):
            sh.shard_shape((122753, 2304))
        with pytest.raises(ValueError, match="divides by 16"):
            sh.distribute(torch.empty((122753, 2304), device="meta"))
        assert sh.shard_shape((122768, 2304)) == (7673, 2304)
        with pytest.raises(ValueError, match="minor axis first"):
            NamedSharding(mesh, P(("model", "data")))
    for rank in (0, 17, 300, 511):
        with fake_world(512, rank=rank):
            mesh = make_production_mesh(multi_pod=True, device_type="cpu")
            sh = NamedSharding(mesh, P(("pod", "data"), "model"))
            shape, off = compute_local_shape_and_global_offset(
                (1024, 64), mesh, sh.placements)
            pod, data, model = rank // 256, rank // 16 % 16, rank % 16
            assert tuple(shape) == (32, 4)
            assert tuple(off) == ((pod * 16 + data) * 32, model * 4)
