"""The sharded dense serve path on 4 gloo ranks against the reference's
4-device run (shared by ``test_torch_sharded_serve.py`` and
``test_torch_sharded_layouts.py``).

``run(tmp, cases)`` builds each case's JAX serve params once (a jitted
``init_lm``), saves them with its tokens under ``tmp``, then runs the
reference and the port side by side:

- the reference in ONE subprocess with 4 forced host devices
  (``REF_SCRIPT``): ``jax.jit`` of ``lm.prefill`` and ``lm.decode_step``
  with ``in_shardings`` from ``make_shardings`` of the specs (the caches'
  batch entry by the dry run's ``_fix_batch_axes``), as
  ``launch/dryrun.py`` lowers them, prefill then greedy steps; it saves
  the logits, tokens and caches, every param and cache leaf's per-device
  block (``devices_indices_map``, devices in mesh order: device ``r`` is
  the port's rank ``r``) and, where a case asks, the collectives of the
  compiled decode step (``hlo_analysis.parse_collectives``);
- the port on 4 spawned gloo ranks (``_torch_ranks.sharded_serve_rank``);
- the port unsharded, in this process (``lm.prefill``/``decode_step`` on
  the whole params).

Each case: ``arch`` (a smoke config), ``over`` (config overrides),
``mesh`` ``(data, model)``, and optionally ``hlo`` (parse the decode
step's collectives), ``spread`` (the reference also runs its forwards on
one device, fed the sharded run's tokens), ``forced`` (with ``spread``:
the port's unsharded run is fed them too, after the reference ends) or
``linear`` ``(K, N)`` (one serve linear instead of a model).  Prompts are
B 4 x 16 tokens into ``S_MAX`` 32, then ``STEPS`` greedy steps.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import jax
import ml_dtypes

from repro.configs import smoke_config as jsmoke
from repro.models import lm as jlm
from repro.models import nn as jnn

import _torch_families
import _torch_ranks
from repro_torch import convert
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.models import lm

ROOT = os.path.join(os.path.dirname(__file__), "..")
WORLD, B, S, S_MAX, STEPS = 4, 4, 16, 32, 10

REF_SCRIPT = """
import dataclasses, json, pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import smoke_config
from repro.models import lm, nn
from repro.launch.mesh import make_mesh_compat
from repro.launch.dryrun import (_batch_entry, _fix_batch_axes,
                                 abstract_caches, abstract_init)
from repro.launch.hlo_analysis import parse_collectives
from repro.parallel.sharding import make_shardings

tmp, names = sys.argv[1], sys.argv[2].split(",")

def bits(x):
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x

def blocks(tree, shardings, mesh):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    shs = jax.tree.leaves(shardings)
    out = {}
    for (path, leaf), sh in zip(leaves, shs):
        m = sh.devices_indices_map(leaf.shape)
        out[jax.tree_util.keystr(path)] = [
            [[s.start or 0, leaf.shape[d] if s.stop is None else s.stop]
             for d, s in enumerate(m[dev])] for dev in mesh.devices.flat]
    return out

for name in names:
    case = pickle.load(open(f"{tmp}/{name}.pkl", "rb"))
    cfg = dataclasses.replace(smoke_config(case["arch"]), **case["over"])
    mesh = make_mesh_compat(tuple(case["mesh"]), ("data", "model"))
    out = {}
    if "linear" in case:
        K, N = case["K"], case["N"]
        _, axes = nn.init_serve_linear(jax.random.PRNGKey(0), K, N, cfg)
        sh = make_shardings(mesh, axes)
        p = jax.device_put(jax.tree.map(jnp.asarray, case["linear"]), sh)
        x = jnp.asarray(case["x"])
        y = jax.jit(lambda p, x: nn.serve_linear_apply(p, x, cfg),
                    in_shardings=(sh, NamedSharding(mesh, P())))(p, x)
        out["y"] = bits(y)
        meta = {"param_blocks": blocks(case["linear"], sh, mesh)}
    else:
        tokens = jnp.asarray(case["tokens"])
        B, S = tokens.shape
        batch = {k: jnp.asarray(case[k]) for k in ("tokens", "frames",
                                                   "front") if k in case}
        enc_len = case["frames"].shape[1] if "frames" in case else 0
        pos0 = case.get("pos0", S)
        feed = case.get("feed")
        _, axes = abstract_init(cfg, "serve")
        _, cax = abstract_caches(cfg, B, case["S_max"], enc_len)
        cax = _fix_batch_axes(cax, B, mesh)
        be = _batch_entry(B, mesh)
        sh_p, sh_c = make_shardings(mesh, axes), make_shardings(mesh, cax)
        sh_t, rep = NamedSharding(mesh, P(be, None)), NamedSharding(mesh, P())
        sh_b = {k: NamedSharding(mesh, P(be, *[None] * (v.ndim - 1)))
                for k, v in batch.items()}
        params = jax.device_put(jax.tree.map(jnp.asarray, case["params"]),
                                sh_p)
        pre = jax.jit(lambda p, b: lm.prefill(p, b, cfg,
                                              S_max=case["S_max"]),
                      in_shardings=(sh_p, sh_b))
        dec = jax.jit(lambda p, c, t, pos: lm.decode_step(p, c, t, pos, cfg),
                      in_shardings=(sh_p, sh_c, sh_t, rep))
        logits, caches = pre(params, batch)
        out["prefill_logits"] = bits(logits)
        t = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        toks, fed = [t], []
        for i in range(case["steps"]):
            caches = jax.device_put(caches, sh_c)
            if feed is not None:    # teacher-forced: the case's tokens
                t = jnp.asarray(feed[i])
            fed.append(np.asarray(t))
            logits, caches = dec(params, caches, t[:, None],
                                 jnp.int32(pos0 + i))
            t = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            toks.append(t)
        out["tokens"] = np.stack([np.asarray(t) for t in toks])
        out["last_logits"] = bits(logits)
        for (path, leaf) in jax.tree_util.tree_flatten_with_path(caches)[0]:
            out["cache" + jax.tree_util.keystr(path)] = bits(leaf)
        if case.get("spread"):      # the same forwards on one device
            pre1 = jax.jit(lambda p, b: lm.prefill(p, b, cfg,
                                                   S_max=case["S_max"]))
            dec1 = jax.jit(lambda p, c, t, pos: lm.decode_step(p, c, t, pos,
                                                               cfg))
            p1 = jax.tree.map(jnp.asarray, case["params"])
            lg1, c1 = pre1(p1, batch)
            out["one_prefill_logits"] = bits(lg1)
            for i, t1 in enumerate(fed):
                lg1, c1 = dec1(p1, c1, jnp.asarray(t1)[:, None],
                               jnp.int32(pos0 + i))
            out["one_last_logits"] = bits(lg1)
            for (path, leaf) in jax.tree_util.tree_flatten_with_path(c1)[0]:
                out["one_cache" + jax.tree_util.keystr(path)] = bits(leaf)
        meta = {"param_blocks": blocks(case["params"], sh_p, mesh),
                "cache_blocks": blocks(caches, sh_c, mesh)}
        if case.get("hlo"):
            txt = dec.lower(params, jax.device_put(caches, sh_c),
                            jax.ShapeDtypeStruct(
                (B, 1), jnp.int32), jax.ShapeDtypeStruct(
                (), jnp.int32)).compile().as_text()
            st = parse_collectives(txt)
            meta["hlo"] = {"count": st.count_by_kind,
                           "bytes": st.bytes_by_kind}
    np.savez(f"{tmp}/{name}_ref.npz", **out)
    json.dump(meta, open(f"{tmp}/{name}_ref.json", "w"))
"""


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_params(arch, over, int8_steps: bool):
    """JAX serve params of a smoke config (jitted init), as numpy; int8
    linears get ``_torch_families``' calibrated steps."""
    jcfg = dataclasses.replace(jsmoke(arch), **over)
    p = jax.jit(lambda k: jlm.init_lm(k, jcfg, purpose="serve")[0])(
        jax.random.PRNGKey(0))
    if int8_steps:
        p = _torch_families._calibrate_int8(p)
    return _np(p)


def inputs(case, rows=None):
    """The case's ``frames``/``front`` (this rank's ``rows``, ``(start,
    n)``, where given) as ``lm.prefill``'s keywords."""
    r = slice(None) if rows is None else slice(rows[0], rows[0] + rows[1])
    return {k: torch.from_numpy(case[k][r]) for k in ("frames", "front")
            if k in case}


def _plain_run(case, forced=None):
    """The port unsharded on the whole params: prefill, greedy steps; with
    ``forced`` (tokens ``[steps + 1, B]``) step ``i`` is fed ``forced[i]``
    instead of its own argmax (the reference's one-device run of a
    ``spread`` case is fed so)."""
    cfg = dataclasses.replace(tsmoke(case["arch"]), **case["over"])
    params = convert.params_from_jax(case["params"], "cpu")
    tokens = torch.from_numpy(case["tokens"])
    logits, caches = lm.prefill(params, tokens, cfg, S_max=case["S_max"],
                                **inputs(case))
    out = {"prefill_logits": convert.to_numpy(logits)}
    t = lm.greedy(logits)
    toks = [t]
    forced = case.get("feed") if forced is None else forced
    for i in range(case["steps"]):
        if forced is not None:
            t = torch.from_numpy(forced[i]).long()
        logits, caches = lm.decode_step(params, caches, t[:, None].to(
            torch.int32), case.get("pos0", S) + i, cfg)
        t = lm.greedy(logits)
        toks.append(t)
    out.update(tokens=torch.stack(toks).numpy(),
               last_logits=convert.to_numpy(logits),
               caches=convert.to_numpy(caches))
    return out


def run(tmp, cases: dict, rank_timeout: float = _torch_ranks.TIMEOUT_S
        ) -> dict:
    """Every case through the reference (one subprocess), the port's 4
    ranks (given ``rank_timeout`` seconds) and the port unsharded.
    Returns ``{name: {'case', 'ref', 'meta', 'ranks', 'plain'}}``."""
    from repro_torch.models import nn as tnn
    from repro_torch.parallel.sharding import spec_tree

    models = [(n, c) for n, c in cases.items()
              if not c.get("collectives") and "linear" not in c]
    # the jitted inits compile in threads (XLA compiles outside the GIL)
    with ThreadPoolExecutor(max(len(models), 1)) as ex:
        drawn = {n: ex.submit(_jax_params, c["arch"], c["over"], c[
            "over"].get("serve_impl") == "int8") for n, c in models}
        drawn = {n: f.result() for n, f in drawn.items()}
    full = {}
    for i, (name, c) in enumerate(cases.items()):
        case = dict(c, steps=c.get("steps", STEPS), S_max=c.get("S_max",
                                                                 S_MAX))
        if c.get("collectives"):
            pass
        elif "linear" in c:
            K, N = c["linear"]
            jcfg = dataclasses.replace(jsmoke(c["arch"]), **c["over"])
            tcfg = dataclasses.replace(tsmoke(c["arch"]), **c["over"])
            p, _ = jnn.init_serve_linear(jax.random.PRNGKey(i), K, N, jcfg)
            rng = np.random.default_rng(i)
            case.update(K=K, N=N, linear=_np(p), specs=spec_tree(
                tnn.init_serve_linear(torch.Generator(), K, N, tcfg,
                                      device="meta")),
                x=rng.uniform(0, 16, (B * 2, K)).astype(np.float32))
        else:
            case["params"] = drawn[name]
            vocab = jsmoke(c["arch"]).vocab
            rng = np.random.default_rng(i)
            case["tokens"] = rng.integers(0, vocab, (B, S)).astype(np.int32)
            if c.get("frames"):     # an enc-dec case: Se frames
                case["frames"] = rng.standard_normal(
                    (B, c["frames"], 1024)).astype(np.float32)
            if c.get("front"):      # a VLM case: its frontend_len rows
                F = jsmoke(c["arch"]).frontend_len
                case["front"] = rng.standard_normal(
                    (B, F, 1152)).astype(np.float32)
                case["pos0"] = F + S
            if c.get("teacher"):    # decode fed these tokens, not argmax
                case["feed"] = rng.integers(
                    0, vocab, (case["steps"], B)).astype(np.int32)
        with open(os.path.join(tmp, f"{name}.pkl"), "wb") as f:
            pickle.dump(case, f)
        full[name] = case
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}")
    ref_names = [n for n, c in cases.items() if not c.get("collectives")]
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REF_SCRIPT), str(tmp),
         ",".join(ref_names)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        ranks = _torch_ranks.spawn_ranks(_torch_ranks.sharded_serve_rank,
                                         WORLD, tmp, list(cases),
                                         timeout=rank_timeout)
        plain = {n: _plain_run(c) for n, c in full.items()
                 if "params" in c and not c.get("forced")}
        _, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    out = {}
    for name in cases:
        out[name] = dict(case=full[name], ranks=[r[name] for r in ranks])
        if name in ref_names:
            with open(os.path.join(tmp, f"{name}_ref.json")) as f:
                out[name]["meta"] = json.load(f)
            out[name]["ref"] = dict(np.load(os.path.join(
                tmp, f"{name}_ref.npz")))
        if full[name].get("forced"):
            plain[name] = _plain_run(full[name], out[name]["ref"]["tokens"])
        out[name]["plain"] = plain.get(name)
    return out


def keystr_leaves(tree, path=""):
    """``(path, leaf)`` of nested dicts and lists in ``jax.tree_util
    .keystr`` form and JAX's flatten order (sorted dict keys)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from keystr_leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from keystr_leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def block(whole, slices):
    """The block of ``whole`` at the reference's ``[[start, stop], ...]``."""
    return whole[tuple(slice(a, b) for a, b in slices)]


def bf16(bits_u16):
    """uint16 bf16 bits as f32 values."""
    return bits_u16.view(ml_dtypes.bfloat16).astype(np.float32)


NEG_BITS = np.array([-1e30], dtype=ml_dtypes.bfloat16).view(np.uint16)[0]


def rank_logits(r, whole):
    """``(this rank's real vocab columns, the same block of the whole
    logits, its padded columns)``: a rank holds its batch rows and its
    'model' block of the padded vocab."""
    r0, nr = r["rows"]
    V = whole.shape[-1]

    def cut(local):
        lo = r["model_index"] * local.shape[-1]
        hi = min(lo + local.shape[-1], V)
        return local[:, :hi - lo], whole[r0:r0 + nr, lo:hi], local[:,
                                                                   hi - lo:]
    return cut


def assert_ranks_equal(out, whole: dict, cache_blocks, exact=True,
                       tol=0.0):
    """Every rank's tokens, prefill and last logits and cache blocks
    against ``whole`` (a run's gathered results: the reference's, or the
    port's unsharded one).  ``exact``: bits equal; else tokens equal and
    bf16 values within ``tol``."""
    ref_caches = {k: v for k, v in keystr_leaves(whole["caches"])} if (
        "caches" in whole) else {k[5:]: v for k, v in whole.items()
                                 if k.startswith("cache[")}
    for rank, r in enumerate(out["ranks"]):
        r0, nr = r["rows"]
        np.testing.assert_array_equal(r["tokens"],
                                      whole["tokens"][:, r0:r0 + nr])
        for key in ("prefill_logits", "last_logits"):
            mine, ref, pad = rank_logits(r, whole[key])(r[key])
            assert (pad == NEG_BITS).all(), (rank, key)
            if exact:
                np.testing.assert_array_equal(mine, ref, err_msg=key)
            else:
                np.testing.assert_allclose(bf16(mine), bf16(ref), rtol=0,
                                           atol=tol, err_msg=key)
        for path, leaf in keystr_leaves(r["caches"]):
            ref = block(ref_caches[path], cache_blocks[path][rank])
            assert leaf.shape == ref.shape, (path, leaf.shape, ref.shape)
            if exact:
                np.testing.assert_array_equal(leaf, ref, err_msg=path)
            else:
                np.testing.assert_allclose(bf16(leaf), bf16(ref), rtol=0,
                                           atol=tol, err_msg=path)


def assert_param_blocks(out):
    """Each rank's param leaves are the reference's blocks for its device:
    the shard shape of the leaf's spec, the whole leaf's contents there
    (``embed``/``head`` as the port stores them, rounded to bf16; a
    padded int8 ``w8`` holds the block and zeros); ``table_narrow`` is
    the narrow rows of the replicated table."""
    from repro_torch.kernels.tlmac_fused import narrow_table

    whole = dict(keystr_leaves(out["case"].get("params")
                               or out["case"]["linear"]))
    blocks = out["meta"]["param_blocks"]
    for rank, r in enumerate(out["ranks"]):
        local = dict(keystr_leaves(r["blocks"]))
        for path, leaf in local.items():
            if path.endswith("['table_narrow']"):
                table = local[path.replace("table_narrow", "table")]
                np.testing.assert_array_equal(
                    leaf, narrow_table(torch.from_numpy(table)).numpy())
                continue
            ref = block(whole[path], blocks[path][rank])
            if ref.dtype == np.float32 and leaf.dtype == np.uint16:
                ref = ref.astype(ml_dtypes.bfloat16).view(np.uint16)
            if ref.dtype.name == "bfloat16":
                ref = ref.view(np.uint16)
            if path.endswith("['w8']"):
                pad = leaf.copy()
                pad[tuple(slice(0, n) for n in ref.shape)] = 0
                assert not pad.any(), path
                leaf = leaf[tuple(slice(0, n) for n in ref.shape)]
            assert leaf.shape == ref.shape, (path, leaf.shape, ref.shape)
            np.testing.assert_array_equal(leaf, ref, err_msg=path)
        assert set(local) - {p for p in local if "table_narrow" in p} == set(
            whole), rank


def step_counts(out):
    """The per-decode-step collectives of rank 0, asserted the same at
    every step and on every rank: ``(all-gathers, all-reduces, parameter
    collectives, parameter bytes)``."""
    seen = set()
    for r in out["ranks"]:
        for st in r["stats"]:
            c = st.count_by_kind
            assert c["reduce-scatter"] == c["all-to-all"] == 0
            assert c["collective-permute"] == 0
            seen.add((c["all-gather"], c["all-reduce"], st.param_count,
                      st.param_bytes))
    assert len(seen) == 1, seen
    return seen.pop()
