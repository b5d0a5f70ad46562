"""MLA (multi-head latent attention) in the port against the JAX package,
on the deepseek-v3 and kimi-k2 smoke configs (params from ``lm.init_lm(...,
purpose='serve')``, converted).

- ``mla_train`` and ``mla_decode`` of one layer on the same inputs: the
  output and the latent caches bit-equal, but for the vocab head's kind of
  allowance (``_torch_families.HEAD_ULP_SHARE``: the f32 einsums of the
  absorbed decode sum in torch's order, not XLA's, so a bf16 output may
  round to its neighbour).  The lookup linears run at calibrated steps
  (``calibrate_tlmac``), where a wrong rounding would move a code.
- The absorbed decode against the train forward's last row in the port
  (the reference's ``tests/test_attention.py``), dense serve linears,
  within the reference's ``rtol = atol = 3e-2``.
- The dense ``ServeLoop``, teacher-forced against the JAX one: inputs
  equal at every call, the latent caches ``ckv``/``kr`` bit-equal, logits
  rows under the head's allowance, tokens and refills equal.
- The paged loop refuses an MLA config with the reference's error.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.models import attention as jattn
from repro.models import nn as jnn

from repro_torch import convert
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.serve.loop import Request, ServeLoop
from repro_torch.serve.paged import PagedServeLoop

import _torch_families as F
from test_torch_dense_loop import _caches_equal, _run_jax_loop

FAMILIES = list(F.MLA_FAMILIES)


def _layer(family, steps="calibrated"):
    jcfg, tcfg, params, tp = F.model(family, steps=steps)
    jl = jax.tree.map(lambda x: x[0], params["segments"][0]["b0"]["attn"])
    return jcfg, tcfg, jl, tp.layers(0)[0]["b0"]["attn"]


def _bf16_pair(rng, shape):
    x = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    return x, torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


def _close(got, want):
    d = F.bf16_ulps(got.float().numpy(), np.asarray(want, np.float32))
    return d.max() <= 1 and (d > 0).sum() <= max(1, F.HEAD_ULP_SHARE * d.size)


@pytest.mark.parametrize("family", FAMILIES)
def test_mla_train_and_decode_vs_jax(family):
    jcfg, tcfg, jl, tl = _layer(family)
    rng = np.random.default_rng(0)
    B, S, S_max = 2, 7, 12
    xj, xt = _bf16_pair(rng, (B, S, jcfg.d_model))
    yj, (cj, kj) = jax.jit(lambda p, x: jattn.mla_train(
        p, x, jcfg, apply_fn=jnn.serve_linear_apply))(jl, xj)
    yt, (ct, kt) = tattn.mla_train(tl, xt, tcfg)
    assert _close(yt, yj)
    assert torch.equal(ct, convert.to_torch(np.asarray(cj), "cpu"))
    assert torch.equal(kt, convert.to_torch(np.asarray(kj), "cpu"))

    ckv = np.zeros((B, S_max, jcfg.mla_kv_lora), np.float32)
    kr = np.zeros((B, S_max, jcfg.mla_rope_dim), np.float32)
    ckv[:, :S], kr[:, :S] = np.asarray(cj, np.float32), np.asarray(
        kj, np.float32)
    x1j, x1t = _bf16_pair(rng, (B, 1, jcfg.d_model))
    yj2, (cj2, kj2) = jax.jit(lambda p, x, c: jattn.mla_decode(
        p, x, jcfg, c, S, apply_fn=jnn.serve_linear_apply))(
        jl, x1j, (jnp.asarray(ckv, jnp.bfloat16),
                  jnp.asarray(kr, jnp.bfloat16)))
    cache = (torch.from_numpy(ckv).to(torch.bfloat16),
             torch.from_numpy(kr).to(torch.bfloat16))
    yt2, (ct2, kt2) = tattn.mla_decode(tl, x1t, tcfg, cache, S)
    assert ct2 is cache[0] and kt2 is cache[1]          # written in place
    assert _close(yt2, yj2)
    assert torch.equal(ct2, convert.to_torch(np.asarray(cj2), "cpu"))
    assert torch.equal(kt2, convert.to_torch(np.asarray(kj2), "cpu"))


@pytest.mark.parametrize("family", FAMILIES)
def test_mla_absorbed_decode_matches_train(family):
    _, tcfg = F.cfgs(family, impl="dense")
    gen = torch.Generator().manual_seed(0)
    p = tattn.init_mla(gen, tcfg, device="cpu")
    assert set(p["wkv_b"]) == {"w"}                      # always dense
    B, S = 2, 10
    x = torch.randn((B, S, tcfg.d_model), generator=gen).to(torch.bfloat16)
    y_train, (ckv, kr) = tattn.mla_train(p, x, tcfg)
    ckv_c = torch.zeros((B, S, tcfg.mla_kv_lora), dtype=torch.bfloat16)
    kr_c = torch.zeros((B, S, tcfg.mla_rope_dim), dtype=torch.bfloat16)
    ckv_c[:, :S - 1], kr_c[:, :S - 1] = ckv[:, :S - 1], kr[:, :S - 1]
    y_dec, _ = tattn.mla_decode(p, x[:, S - 1:], tcfg, (ckv_c, kr_c), S - 1)
    np.testing.assert_allclose(y_dec[:, 0].float().numpy(),
                               y_train[:, -1].float().numpy(),
                               rtol=3e-2, atol=3e-2)


LENGTHS = (6, 11, 3)
MAX_NEW = (4, 5, 3)
S_MAX = 32


def _workload(vocab):
    rng = np.random.default_rng(11)
    return [(rng.integers(0, vocab, n).astype(np.int32), mn)
            for n, mn in zip(LENGTHS, MAX_NEW)]


@pytest.mark.parametrize("family", FAMILIES)
def test_mla_dense_loop_teacher_forced_vs_jax(family, monkeypatch):
    import test_torch_dense_loop as D

    jcfg, tcfg, params, tp = F.model(family)
    monkeypatch.setattr(D, "S_MAX", S_MAX)
    monkeypatch.setattr(D, "_workload", _workload)
    log, jdone, jrefills = _run_jax_loop(jcfg, params, monkeypatch)
    it = iter(log)
    pairs = []
    real_prefill, real_decode = tlm.prefill, tlm.decode_step

    def prefill(p, tokens, cfg, S_max=None):
        kind, jt, jl, jc = next(it)
        assert kind == "prefill" and np.array_equal(tokens.numpy(), jt)
        lg, c = real_prefill(p, tokens, cfg, S_max=S_max)
        assert set(c[0]["b0"]) == {"ckv", "kr"}
        pairs.extend((f"prefill {b}", F.to_np(jl[b]), lg[b].float().numpy())
                     for b in range(lg.shape[0]))
        assert _caches_equal(c, jc), "prefill caches"
        return convert.to_torch(jl, "cpu"), c

    def decode(p, c, tokens, pos, cfg):
        kind, jt, jpos, jl, jc = next(it)
        assert kind == "decode" and pos == jpos
        assert np.array_equal(tokens.numpy(), jt)
        lg, c = real_decode(p, c, tokens, pos, cfg)
        pairs.extend((f"decode {pos}.{b}", F.to_np(jl[b]),
                      lg[b].float().numpy()) for b in range(lg.shape[0]))
        assert _caches_equal(c, jc), ("decode caches", pos)
        return convert.to_torch(jl, "cpu"), c

    monkeypatch.setattr(tlm, "prefill", prefill)
    monkeypatch.setattr(tlm, "decode_step", decode)
    loop = ServeLoop(tp, tcfg, batch_slots=2, s_max=S_MAX, device="cpu")
    for i, (p, mn) in enumerate(_workload(tcfg.vocab)):
        loop.submit(Request(rid=i, prompt=p, max_new_tokens=mn))
    done = {r.rid: r.output.tolist() for r in loop.run()}
    assert next(it, None) is None                 # every call replayed
    assert done == jdone and loop.refills == jrefills >= 1
    bad, exact = F.rows_match(pairs)
    assert not bad, bad
    assert exact >= len(pairs) - 2, (exact, len(pairs))


@pytest.mark.parametrize("family", FAMILIES)
def test_mla_is_not_paged(family):
    _, tcfg, _, tp = F.model(family)
    assert not tlm.supports_paged(tcfg)
    with pytest.raises(ValueError, match="non-pageable"):
        PagedServeLoop(tp, tcfg, device="cpu")
    caches = tlm.init_caches(tcfg, device="cpu", B=3, S_max=20)
    moe_start = tcfg.moe_layer_start
    assert [seg["b0"]["ckv"].shape for seg in caches] == [
        (moe_start, 3, 20, tcfg.mla_kv_lora),
        (tcfg.n_layers - moe_start, 3, 20, tcfg.mla_kv_lora)]
    assert all(seg["b0"]["kr"].dtype == torch.bfloat16 for seg in caches)


@pytest.mark.parametrize("dim", [8, 16, 56, 64, 126, 128])
def test_rotary_bit_equal_to_jitted_jax(dim):
    """The rotary's sin and cos equal XLA's compiled ones bit for bit on
    the CPU (glibc's powf, sinf and cosf, which XLA calls)."""
    from repro_torch.models import nn as tnn

    pos = np.arange(0, 40000, 7, dtype=np.int32)[None, :]
    js, jc = jax.jit(lambda p: jnn.rotary_embedding(p, dim))(pos)
    ts, tc = tnn.rotary_embedding(torch.from_numpy(pos), dim)
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.array_equal(tc.numpy(), np.asarray(jc))


def test_rotary_rows_equal_the_c_library():
    """The CPU rotary's cached rows (grown by doubling, filled per
    position) equal one ``sinf``/``cosf`` call an element, for positions
    seen in any order, repeated, past the first table, and negative (no
    cache)."""
    import ctypes
    import ctypes.util

    from repro_torch.models import nn as tnn

    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    fns = []
    for name in ("sinf", "cosf"):
        f = getattr(libm, name)
        f.restype, f.argtypes = ctypes.c_float, [ctypes.c_float]
        fns.append(f)
    inv = tnn._libm_inv_freq(24, 10000.0).numpy()
    for pos in ([[5, 3, 5, 0]], [[1000, 4, 300]], [[-7, 2]], [[9000]]):
        p = np.array(pos, np.int32)
        ang = p.astype(np.float32)[..., None] * inv
        got = tnn.rotary_embedding(torch.from_numpy(p), 24)
        for g, f in zip(got, fns):
            want = np.vectorize(lambda v: f(float(v)))(ang).astype(np.float32)
            assert np.array_equal(g.numpy(), want)
