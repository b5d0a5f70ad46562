"""Sharded serving of the recurrent, enc-dec and VLM families
(``lm.prefill``/``lm.decode_step`` under a ``(data, model)`` mesh) on 4
gloo ranks against the reference's 4-device run of the same jitted
forwards, on the same params and inputs (``tests/_torch_sharded.py``).

Cases (B 4 x 16 tokens, then 10 decode steps, recurrentgemma's 5):

- recurrentgemma-2b smoke with ``local_window`` 8, mesh (1, 4): the RG-LRU
  on each rank's 16 of 64 lru channels, the ``attn_local`` ring of 8
  slots cut 2 a rank; the prompt fills the ring and decode wraps it,
  writing slots 0-4 across three ranks' blocks;
- xlstm-350m smoke, mesh (2, 2): 7 mLSTM blocks (the matrix memory cut on
  its value dim) and the sLSTM (its state cut on d);
- seamless-m4t-medium smoke widened to 16 heads and 16 KV heads, mesh
  (1, 4): the encoder on each rank's heads, the self and cross caches cut
  on KV heads; 8 frames;
- the seamless smoke as it is (4 KV heads do not divide 16), mesh (2, 2):
  the self and cross caches cut on their positions;
- internvl2-76b smoke with ``fsdp`` and its ``front`` (8 rows of 1152),
  mesh (2, 2): the front's FSDP weight gathered at use, the cache of F + S
  positions cut on its positions.

Tolerances:

- every rank's param and cache blocks have the shapes of the reference
  device's blocks, and the params are its blocks bit for bit;
- seamless and internvl2: tokens, logits and cache blocks bit-equal to
  the reference's 4-device run, and to the port's unsharded run;
- recurrentgemma and xlstm are teacher-forced (each decode step fed the
  case's tokens, on every side): XLA's f32 ``exp``, ``sigmoid``, ``tanh``
  are its own (``tests/test_torch_recurrent.py``) and the RG-LRU's and
  mLSTM's gate products are f32 partial sums over 'model' (in the
  reference's compiled graph too), so their logits are held within
  ``OUT_RTOL`` of the scale, each state leaf within ``STATE_RTOL`` of its
  scale (the conv tails within ``CONV_RTOL``, the ring's K/V within
  ``OUT_RTOL``), or within twice the reference's own 4-vs-1 spread of that
  leaf where that is larger; the argmax must agree wherever the
  reference's top-2 margin clears ``MARGIN`` of the row's scale; the same
  against the port's unsharded run;
- the sLSTM's recurrence is summed whole on each rank, as the
  reference's graph sums it: xlstm's sLSTM state is the port's unsharded
  state bit for bit (the reference's own 4-vs-1 spread there is 0);
- a one-rank mesh is the unsharded forward bit for bit;
- the paged forwards and the train step of these families still raise
  under a mesh of more than one rank.

``test_front_prefill_matches_reference`` holds the unsharded
``lm.prefill(front=)`` of the internvl2 smoke against the reference's
``lm.prefill(params, {'tokens', 'front'})`` and greedy ``decode_step``s.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from repro.configs import smoke_config as jsmoke
from repro.models import lm as jlm

import _torch_families  # noqa: F401  (one torch thread per worker)
import _torch_sharded as H
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.launch.mesh import (fake_world, make_host_mesh,
                                     make_mesh_compat, mesh_context)
from repro_torch.models import lm, nn
from repro_torch.parallel.sharding import local_tree

SE = 8                      # encoder frames
STATE_RTOL = {"mlstm": 1e-5, "slstm": 1e-5, "rglru": 1e-4}
CONV_RTOL = 1e-5
OUT_RTOL = 5e-2
MARGIN = 3e-2

CASES = {
    "recurrentgemma-1x4": dict(arch="recurrentgemma-2b",
                               over=dict(local_window=8), mesh=(1, 4),
                               teacher=True, hlo=True, steps=5, ring=True),
    "xlstm-2x2": dict(arch="xlstm-350m", over={}, mesh=(2, 2), teacher=True,
                      spread=True, hlo=True),
    "seamless-heads-1x4": dict(arch="seamless-m4t-medium",
                               over=dict(n_heads=16, n_kv=16), mesh=(1, 4),
                               frames=SE),
    "seamless-seq-2x2": dict(arch="seamless-m4t-medium", over={},
                             mesh=(2, 2), frames=SE),
    "internvl2-fsdp-2x2": dict(arch="internvl2-76b", over=dict(fsdp=True),
                               mesh=(2, 2), front=True, S_max=40),
}
EXACT = ["seamless-heads-1x4", "seamless-seq-2x2", "internvl2-fsdp-2x2"]
RECURRENT = ["recurrentgemma-1x4", "xlstm-2x2"]
RANK_TIMEOUT_S = 300


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return H.run(tmp_path_factory.mktemp("sharded_recurrent"), CASES,
                 rank_timeout=RANK_TIMEOUT_S)


def _kind(cfg, path: str) -> str:
    """The block kind of a cache path ``[si]['b{bi}'][name]``."""
    si, bi = int(path[1]), int(path.split("'b")[1].split("'")[0])
    return lm.segments_for(cfg)[si].pattern[bi]


def _leaf_tol(cfg, path, want, spread):
    """The tolerance of one cache leaf (see the module's docstring)."""
    kind, name = _kind(cfg, path), path.rsplit("'", 2)[-2]
    scale = max(float(np.abs(want).max()), 1.0)
    if kind == "attn_local":
        tol = OUT_RTOL * scale
    elif name == "conv":
        tol = CONV_RTOL * scale
    else:
        tol = STATE_RTOL[kind] * scale
    return max(tol, 2 * spread)


def _values(a):
    return H.bf16(a) if a.dtype == np.uint16 else a.astype(np.float64)


def _hold_close(out, whole, cache_blocks, spreads):
    """Every rank's logits and cache blocks against ``whole`` (gathered
    results) within the recurrent tolerances; the argmax where the
    margin is clear."""
    cfg = dataclasses.replace(smoke_config(out["case"]["arch"]),
                              **out["case"]["over"])
    caches = ({k: v for k, v in H.keystr_leaves(whole["caches"])}
              if "caches" in whole else
              {k[5:]: v for k, v in whole.items() if k.startswith("cache[")})
    worst = {}
    for rank, r in enumerate(out["ranks"]):
        for key in ("prefill_logits", "last_logits"):
            mine, want, pad = H.rank_logits(r, whole[key])(r[key])
            assert (pad == H.NEG_BITS).all(), (rank, key)
            g, w = H.bf16(mine), H.bf16(want)
            tol = max(OUT_RTOL * np.abs(w).max(), 2 * spreads.get(key, 0))
            assert np.abs(g - w).max() <= tol, (rank, key)
            worst[key] = max(worst.get(key, 0), np.abs(g - w).max() / tol)
            top2 = np.sort(w, axis=-1)[:, -2:]
            clear = top2[:, 1] - top2[:, 0] > MARGIN * np.abs(w).max(-1)
            # a rank's vocab block: the argmax within it where clear
            np.testing.assert_array_equal(g.argmax(-1)[clear],
                                          w.argmax(-1)[clear])
        for path, leaf in H.keystr_leaves(r["caches"]):
            want = H.block(caches[path], cache_blocks[path][rank])
            assert leaf.shape == want.shape, (path, leaf.shape, want.shape)
            g, w = _values(leaf), _values(want)
            d = float(np.abs(g - w).max()) if g.size else 0.0
            tol = _leaf_tol(cfg, path, w, spreads.get(path, 0))
            assert d <= tol, (rank, path, d, tol)
            worst[path] = max(worst.get(path, 0), d / tol if tol else 0.0)
    return worst


def _print_worst(title, worst, sp):
    print(f"\n{title} (the reference's own 4-vs-1 spread):")
    for k, v in worst.items():
        print(f"  {k}: {v:.3g} ({sp.get(k, 0):.3g})")


def _spreads(out):
    """The reference's own 4-vs-1-device spread: the largest difference of
    its 4-device run from its one-device run, a logits key or cache leaf
    each."""
    ref = out["ref"]
    if "one_last_logits" not in ref:
        return {}
    sp = {k: float(np.abs(H.bf16(ref[k]) - H.bf16(ref["one_" + k])).max())
          for k in ("prefill_logits", "last_logits")}
    for k in ref:
        if k.startswith("cache["):
            sp[k[5:]] = float(np.abs(_values(ref[k])
                                     - _values(ref["one_" + k])).max())
    return sp


@pytest.mark.parametrize("name", EXACT)
def test_sharded_bit_equal_to_reference(runs, name):
    out = runs[name]
    H.assert_ranks_equal(out, out["ref"], out["meta"]["cache_blocks"])


@pytest.mark.parametrize("name", EXACT)
def test_sharded_bit_equal_to_unsharded(runs, name):
    out = runs[name]
    H.assert_ranks_equal(out, out["plain"], out["meta"]["cache_blocks"])


@pytest.mark.parametrize("name", RECURRENT)
def test_recurrent_sharded_close_to_reference(runs, name, capsys):
    out = runs[name]
    sp = _spreads(out)
    worst = _hold_close(out, out["ref"], out["meta"]["cache_blocks"], sp)
    with capsys.disabled():
        _print_worst(f"{name}: largest |port 4-rank - reference 4-device| "
                     "over its tolerance, by leaf", worst, sp)


@pytest.mark.parametrize("name", RECURRENT)
def test_recurrent_sharded_close_to_unsharded(runs, name, capsys):
    out = runs[name]
    sp = _spreads(out)
    worst = _hold_close(out, out["plain"], out["meta"]["cache_blocks"], sp)
    with capsys.disabled():
        _print_worst(f"{name}: largest |port 4-rank - port unsharded| over "
                     "its tolerance, by leaf", worst, sp)


@pytest.mark.parametrize("name", RECURRENT)
def test_decode_collectives_beside_reference_hlo(runs, name, capsys):
    """A decode step's collectives: the reference's compiled HLO
    (``hlo_analysis.parse_collectives``, ops in the layer loop counted
    once) beside the port's on rank 0 (printed with ``-s``).  GSPMD
    reshards the recurrent blocks' activations through all-to-alls; it
    all-reduces the RG-LRU's and mLSTM's f32 gate partials, as the port
    does, and takes the mLSTM's ``n . q`` and the sLSTM's recurrence
    whole.  The port gathers instead of resharding: the mLSTM's ``n`` once
    a call, the sLSTM's ``h`` each step and its recurrences ``r`` once a
    call (the one parameter it moves, where the reference's graph moves
    ``r`` by all-to-all).  Its counts are the same at every step and on
    every rank."""
    out = runs[name]
    hlo = out["meta"]["hlo"]
    st = out["ranks"][0]["stats"][-1]
    seen = {tuple(sorted(s.count_by_kind.items())) for r in out["ranks"]
            for s in r["stats"]}
    cfg = dataclasses.replace(smoke_config(out["case"]["arch"]),
                              **out["case"]["over"])
    n_slstm = sum(seg.pattern.count("slstm") * seg.n
                  for seg in lm.segments_for(cfg))
    assert len(seen) == 1 and st.param_count == n_slstm
    assert st.count_by_kind["all-to-all"] == 0
    assert st.count_by_kind["reduce-scatter"] == 0
    with capsys.disabled():
        print(f"\ncollectives a decode step, {name}: kind: reference HLO "
              "count/bytes | port count/bytes")
        for k in hlo["count"]:
            print(f"  {k}: {hlo['count'][k]}/{hlo['bytes'][k]} | "
                  f"{st.count_by_kind[k]}/{st.bytes_by_kind[k]}")


def test_slstm_state_bit_equal_to_unsharded(runs):
    """xlstm on (2, 2): each rank's sLSTM state block (``c``, ``n``,
    ``h``, ``m``) is the port's unsharded state bit for bit, as the
    reference's 4-device sLSTM state is its one-device one: the
    recurrence is summed whole over ``i`` on every rank."""
    out = runs["xlstm-2x2"]
    cfg = smoke_config("xlstm-350m")
    blocks = out["meta"]["cache_blocks"]
    whole = dict(H.keystr_leaves(out["plain"]["caches"]))
    ref = out["ref"]
    paths = [p for p in whole if _kind(cfg, p) == "slstm"]
    assert len(paths) == 4
    for path in paths:
        np.testing.assert_array_equal(ref["cache" + path],
                                      ref["one_cache" + path], err_msg=path)
        for rank, r in enumerate(out["ranks"]):
            leaf = dict(H.keystr_leaves(r["caches"]))[path]
            np.testing.assert_array_equal(
                leaf, H.block(whole[path], blocks[path][rank]),
                err_msg=path)


@pytest.mark.parametrize("name", CASES)
def test_rank_blocks_are_reference_blocks(runs, name):
    """Params as the reference's per-device blocks (an FSDP ``front``
    weight's rows on 'data'); ``lm.init_caches(..., mesh=)`` makes the
    state, ring and cross-cache blocks ``prefill`` fills."""
    H.assert_param_blocks(runs[name])
    for r in runs[name]["ranks"]:
        shapes = [{b: {k: v.shape for k, v in blk.items()}
                   for b, blk in seg.items()} for seg in r["caches"]]
        assert r["init_caches"] == shapes


def test_ring_wraps_across_ranks(runs):
    """recurrentgemma's ring of 8 slots on (1, 4), 2 a rank: the 16-token
    prompt fills it, and the 5 decode steps (positions 16-20) write slots
    0-4 (``pos % W``).  On each rank exactly the written slots of its
    block differ from its block after prefill, on both K and V, and they
    hold the reference's values there (within the ring's tolerance);
    the other slots keep their prefill values bit for bit."""
    out = runs["recurrentgemma-1x4"]
    cfg = dataclasses.replace(smoke_config("recurrentgemma-2b"),
                              local_window=8)
    W, steps = cfg.local_window, out["case"]["steps"]
    written = {(H.S + i) % W for i in range(steps)}
    assert written == set(range(5))
    ref = out["ref"]
    changed_on = {}
    for name in ("k", "v"):
        path = f"[0]['b2'][{name!r}]"
        whole = _values(ref["cache" + path])
        tol = _leaf_tol(cfg, path, whole, 0)
        for rank, r in enumerate(out["ranks"]):
            lo, hi = out["meta"]["cache_blocks"][path][rank][2]
            pre = dict(H.keystr_leaves(r["prefill_caches"]))[path]
            post = dict(H.keystr_leaves(r["caches"]))[path]
            assert post.shape[2] == hi - lo == 2
            for j in range(hi - lo):
                moved = (pre[:, :, j] != post[:, :, j]).any()
                assert moved == (lo + j in written), (name, rank, lo + j)
                if moved:
                    changed_on[lo + j] = rank
                    d = np.abs(_values(post[:, :, j])
                               - whole[:, :, lo + j]).max()
                    assert d <= tol, (name, rank, lo + j, d, tol)
    assert changed_on == {0: 0, 1: 0, 2: 1, 3: 1, 4: 2}


ONE_RANK = {
    "recurrentgemma": ("recurrentgemma-2b", dict(local_window=8), {}),
    "xlstm": ("xlstm-350m", {}, {}),
    "seamless": ("seamless-m4t-medium", {}, dict(frames=6)),
    "internvl2-fsdp": ("internvl2-76b", dict(fsdp=True), dict(front=True)),
}


@pytest.mark.parametrize("name", ONE_RANK)
def test_one_rank_mesh_is_unsharded_bit_for_bit(name):
    """On a one-rank gloo mesh (1, 1) the sharded forwards (every
    collective issued over one rank, each partial sum the whole sum)
    equal the unsharded ones bit for bit: prefill and 6 greedy steps'
    logits and caches."""
    arch, over, extra = ONE_RANK[name]
    cfg = dataclasses.replace(smoke_config(arch), **over)
    whole = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (4, 12), generator=g,
                           dtype=torch.int32)
    kw, F = {}, 0
    if extra.get("frames"):
        kw["frames"] = torch.randn(4, extra["frames"], 1024, generator=g)
    if extra.get("front"):
        F = cfg.frontend_len
        kw["front"] = torch.randn(4, F, 1152, generator=g)
    runs = []
    for sharded in (False, True):
        mesh = make_host_mesh() if sharded else None
        try:
            with mesh_context(mesh):
                params = whole if mesh is None else nn.ParamTree(local_tree(
                    whole.tree(), lm.param_axes(cfg), mesh))
                logits, caches = lm.prefill(params, tokens, cfg, S_max=32,
                                            **kw)
                outs = [logits]
                for i in range(6):
                    t = lm.greedy(logits)
                    logits, caches = lm.decode_step(
                        params, caches, t[:, None].to(torch.int32),
                        F + 12 + i, cfg)
                    outs.append(logits)
                runs.append((outs, convert.to_numpy(caches)))
        finally:
            if mesh is not None:
                dist.destroy_process_group()
    (o0, c0), (o1, c1) = runs
    for a, b in zip(o0, o1):
        assert torch.equal(a[..., :cfg.vocab], b[..., :cfg.vocab])
    for (p, a), (_, b) in zip(H.keystr_leaves(c0), H.keystr_leaves(c1)):
        np.testing.assert_array_equal(a, b, err_msg=p)


def test_front_prefill_matches_reference():
    """internvl2-76b's smoke (``frontend_len`` 8, ``d_front`` 1152):
    ``lm.prefill(tokens, front=)`` and 4 greedy ``decode_step``s equal the
    reference's jitted ``lm.prefill(params, {'tokens', 'front'})`` and
    ``decode_step``s bit for bit: logits, tokens and every cache leaf (the
    cache holds the F + S positions)."""
    jcfg, cfg = jsmoke("internvl2-76b"), smoke_config("internvl2-76b")
    jp = jax.jit(lambda k: jlm.init_lm(k, jcfg, purpose="serve")[0])(
        jax.random.PRNGKey(0))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(3)
    F, S, S_max = jcfg.frontend_len, 10, 24
    tokens = rng.integers(0, jcfg.vocab, (2, S)).astype(np.int32)
    front = rng.standard_normal((2, F, 1152)).astype(np.float32)
    jpre = jax.jit(lambda p, b: jlm.prefill(p, b, jcfg, S_max=S_max))
    jdec = jax.jit(lambda p, c, t, pos: jlm.decode_step(p, c, t, pos, jcfg))
    jl, jc = jpre(jp, {"tokens": jnp.asarray(tokens),
                       "front": jnp.asarray(front)})
    tl, tc = lm.prefill(params, torch.from_numpy(tokens), cfg, S_max=S_max,
                        front=torch.from_numpy(front))
    for i in range(5):
        np.testing.assert_array_equal(convert.to_numpy(tl),
                                      np.asarray(jl).view(np.uint16))
        for (p, a), (_, b) in zip(H.keystr_leaves(convert.to_numpy(tc)),
                                  H.keystr_leaves(jax.tree.map(
                                      np.asarray, jc))):
            np.testing.assert_array_equal(
                a, b.view(np.uint16) if b.dtype.name == "bfloat16" else b,
                err_msg=p)
        if i == 4:
            break
        jt = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        tt = lm.greedy(tl)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jl, jc = jdec(jp, jc, jt[:, None], jnp.int32(F + S + i))
        tl, tc = lm.decode_step(params, tc, tt[:, None].to(torch.int32),
                                F + S + i, cfg)
    with pytest.raises(ValueError, match="no VLM frontend"):
        lm.prefill(params, torch.from_numpy(tokens),
                   smoke_config("minicpm-2b"), front=torch.from_numpy(front))


def test_paged_and_train_still_refused_under_a_mesh():
    """Under a mesh of 4 ranks: the paged pools and the paged forwards of
    recurrentgemma's ``attn_local`` blocks raise ``NotImplementedError``
    naming what runs sharded instead.  The four families' sharded train
    step is admitted (``test_torch_sharded_train_recurrent.py``,
    ``test_torch_sharded_train_encdec.py``); what of it no reference config
    trains still raises: the recurrent blocks under ``pure_fsdp``, an
    mLSTM whose heads divide the 'model' axis."""
    from repro_torch.kernels.paged import PageSpec

    cfg = dataclasses.replace(smoke_config("recurrentgemma-2b"),
                              local_window=8)
    whole = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    with fake_world(4):
        mesh = make_mesh_compat((1, 4), ("data", "model"), "cpu")
        with pytest.raises(NotImplementedError, match="paged"):
            lm.init_caches(cfg, paged=PageSpec(n_pages=8, page_size=4,
                                               max_blocks=4), mesh=mesh)
        with mesh_context(mesh):
            blk = whole.layers(0)[0]["b2"]
            x = torch.zeros((1, 4, cfg.d_model), dtype=torch.bfloat16)
            with pytest.raises(NotImplementedError, match="paged"):
                lm.apply_block("attn_local", blk, x, cfg,
                               nn.serve_linear_apply, paged_ctx={
                                   "block_table": None, "start": 0})
            for arch in ("recurrentgemma-2b", "xlstm-350m",
                         "seamless-m4t-medium", "internvl2-76b"):
                lm.check_sharded_train(smoke_config(arch))
            for arch, over in (("recurrentgemma-2b", {"pure_fsdp": True}),
                               ("xlstm-350m", {"pure_fsdp": True}),
                               ("xlstm-350m", {"n_heads": 16})):
                with pytest.raises(NotImplementedError,
                                   match="no reference config"):
                    lm.check_sharded_train(dataclasses.replace(
                        smoke_config(arch), **over))
