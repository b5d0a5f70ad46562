"""The paged families of ``tests/test_serve_oracle.py`` and the serve
layouts, built on both packages from one JAX init (shared by
``test_torch_families.py``, ``test_torch_layouts.py`` and
``test_torch_dense_loop.py``).

``model(family, layout, kv)`` returns ``(jcfg, tcfg, jparams, tparams)``:
JAX params from ``lm.init_lm(PRNGKey(0), cfg, purpose='serve')`` and the
port's ``convert.params_from_jax`` of them.  Layouts: ``tlmac``, ``int8``
and ``dense`` (``serve_impl``), and ``mixed``, a tlmac tree whose FFN
linears are the int8 tree's (the paper's §6.1 mixed precision: lookup
attention, int8 FFN).

The int8 layout's steps are calibrated before conversion (the same
values on both sides): the reference's init holds placeholder steps of 1,
under which every linear multiplies the activations' scale by about 127 x
sqrt(K), attention scores reach 1e6 and the softmax then turns on f32
summation order alone.  With ``a_step`` 1/32 and ``w_step`` 3 / (127
sqrt(K)) (absmax calibration of unit activations and N(0, 1/K) weights)
the int8 forwards stay at the scale of the others.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp
import torch

from repro.configs import smoke_config as jsmoke
from repro.models import lm as jlm

from repro_torch import convert
from repro_torch.configs import smoke_config as tsmoke

# family -> (arch, overrides): tests/test_serve_oracle.py's FAMILY_CFGS
# less MoE.  The forward tests run the window family at local_window 8
# (its prompts reach position 24: keys inside and outside the window);
# the loop tests keep the reference's 24 (pre-wrap, see that file).
FAMILIES = {
    "codeqwen-gqa": ("codeqwen1.5-7b", {}),
    "minicpm-gqa": ("minicpm-2b", {}),
    "mistral-gqa-r4": ("mistral-large-123b", {}),
    "command-r-gqa-r4": ("command-r-35b", {}),
    "internvl2-vlm": ("internvl2-76b", {}),
    "window-local": ("codeqwen1.5-7b", dict(
        family="hybrid", block_pattern=("attn_local",), local_window=24,
        name="cq-window-local")),
}
# the oracle matrix's MoE family (deepseek's MLA swapped for GQA, which
# pages); kept apart from FAMILIES: its paged outputs differ from the
# dense oracle's through capacity drops, the reference's behaviour
MOE_FAMILIES = {
    "moe-gqa": ("deepseek-v3-671b", dict(attn_kind="gqa",
                                         name="ds-moe-gqa")),
}
# the MLA families: deepseek-v3 and kimi-k2 with their own attention,
# served on dense latent caches (MLA is not paged, as in the reference)
MLA_FAMILIES = {
    "deepseek-mla": ("deepseek-v3-671b", {}),
    "kimi-mla": ("kimi-k2-1t-a32b", {}),
}
# the recurrent families, served through the dense ServeLoop (their
# states do not page, as in the reference); XLA's f32 transcendentals
# (exp, tanh, log_sigmoid, sigmoid) differ from torch's in the last ulp,
# so these are held within tolerances, not bit for bit
RECURRENT_FAMILIES = {
    "xlstm": ("xlstm-350m", {}),
    "recurrentgemma": ("recurrentgemma-2b", {}),
}
# the enc-dec family (lm.prefill(tokens, frames=...) and decode_step)
ENCDEC_FAMILIES = {
    "seamless": ("seamless-m4t-medium", {}),
}
NEW_FAMILIES = ["minicpm-gqa", "command-r-gqa-r4", "internvl2-vlm",
                "window-local"]
LAYOUTS = ["tlmac", "int8", "dense", "mixed"]
INT8_A_STEP = 1.0 / 32

_cache: dict = {}

# Smoke-sized torch ops gain nothing from intra-op threads, and under the
# parallel test run (several workers on the same cores) those threads
# only contend: one per worker process that imports these helpers.
torch.set_num_threads(1)


def cfgs(family, impl="tlmac", kv="fp", **kw):
    arch, over = (FAMILIES.get(family) or MOE_FAMILIES.get(family)
                  or MLA_FAMILIES.get(family)
                  or RECURRENT_FAMILIES.get(family)
                  or ENCDEC_FAMILIES[family])
    over = dict(over, serve_impl=impl, serve_kv_dtype=kv, **kw)
    return (dataclasses.replace(jsmoke(arch), **over),
            dataclasses.replace(tsmoke(arch), **over))


def _calibrate_int8(tree):
    """Give every int8 linear of a JAX param tree calibrated steps."""
    if isinstance(tree, dict):
        if "w8" in tree:
            K = tree["w8"].shape[-2]
            tree["a_step"] = jnp.full_like(tree["a_step"], INT8_A_STEP)
            tree["w_step"] = jnp.full_like(
                tree["w_step"], 3.0 / (127.0 * np.sqrt(K)))
            return tree
        return {k: _calibrate_int8(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_calibrate_int8(v) for v in tree]
    return tree


TLMAC_A_STEP, TLMAC_W_STEP = 0.37, 0.05   # calibrated lookup-linear steps


def calibrate_tlmac(tree):
    """Give every lookup linear of a JAX param tree an ``a_step`` of
    ``TLMAC_A_STEP`` and a ``w_step`` of ``TLMAC_W_STEP`` (the init's
    steps of 1 keep every linear's output on integers, where a bf16
    rounding of a product seldom moves the next quantiser's codes)."""
    if isinstance(tree, dict):
        if "table" in tree:
            return dict(tree,
                        a_step=jnp.full_like(tree["a_step"], TLMAC_A_STEP),
                        w_step=jnp.full_like(tree["w_step"], TLMAC_W_STEP))
        return {k: calibrate_tlmac(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [calibrate_tlmac(v) for v in tree]
    return tree


def jax_params(jcfg, layout):
    """JAX serve params of ``layout`` (``mixed``: a tlmac tree with the
    int8 tree's FFN linears)."""
    if layout == "mixed":
        p, _ = jlm.init_lm(jax.random.PRNGKey(0),
                           dataclasses.replace(jcfg, serve_impl="tlmac"),
                           purpose="serve")
        q, _ = jlm.init_lm(jax.random.PRNGKey(0),
                           dataclasses.replace(jcfg, serve_impl="int8"),
                           purpose="serve")
        for seg, qseg in zip(p["segments"], q["segments"]):
            for b in seg:
                seg[b]["ffn"] = qseg[b]["ffn"]
    else:
        p, _ = jlm.init_lm(jax.random.PRNGKey(0), jcfg, purpose="serve")
    return _calibrate_int8(p)


def model(family, layout="tlmac", kv="fp", steps="init", **kw):
    """(jcfg, tcfg, JAX params, port params), built once per key;
    ``steps='calibrated'`` gives the lookup linears ``calibrate_tlmac``'s
    steps."""
    key = (family, layout, kv, steps, tuple(sorted(kw.items())))
    if key not in _cache:
        impl = "tlmac" if layout == "mixed" else layout
        jcfg, tcfg = cfgs(family, impl, kv, **kw)
        pkey = (family, layout, steps, tuple(sorted(kw.items())))
        if pkey not in _cache:
            p = jax_params(jcfg, layout)
            if steps == "calibrated":
                p = calibrate_tlmac(p)
            _cache[pkey] = (p, convert.params_from_jax(
                jax.tree.map(np.asarray, p), device="cpu"))
        _cache[key] = (jcfg, tcfg, *_cache[pkey])
    return _cache[key]


def to_np(x):
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# the three paged forwards on both packages
# ---------------------------------------------------------------------------

S_MAX, B, P, C = 48, 2, 8, 8
LENS = (19, 5)          # slot 0: three chunks, past a window of 8
K1 = 4                  # verify window
# The one rounding left between the packages' forwards: the vocab head
# is a GEMM whose f32 sums run in another order (XLA's dot against
# torch's), so a logit can round to the neighbouring bf16 value, seen
# only on logits near zero.  A row passes when it is bit-equal or off by
# one bf16 ulp in at most HEAD_ULP_SHARE of its logits (at least one).
HEAD_ULP_SHARE = 1e-3
# the port's flash reader against JAX's gathered one: the split-K
# softmax sums in another order (f32), and a bf16 ulp can then move a
# 3-bit activation code of a later linear: a few bf16 steps of the logits
FLASH_LOGIT_TOL = 2e-2


def _jit(fn, jcfg):
    return jax.jit(lambda *a: fn(*a, jcfg))


def paged_forwards(family, layout, kv="fp", **kw):
    """Both packages through the paged forwards on the same params and
    inputs: two prompts chunked into their slots' pages, one decode step
    (JAX's ``'lax'`` reader; the port's ``'lax'`` and ``'flash'``
    readers on copies of the pool) and one verify window.  Returns
    ``(pairs, flash_pairs, jax_pool, port_pool)``: ``pairs`` are
    ``(name, JAX logits, port logits)`` of every forward, to be
    bit-equal."""
    import torch

    from repro.kernels import paged as jpaged
    from repro_torch.kernels import paged as tpaged
    from repro_torch.models import lm as tlm

    jcfg, tcfg, params, tp = model(family, layout, kv, **kw)
    jcfg = dataclasses.replace(jcfg, serve_paged_attn_impl="lax")
    spec = jpaged.spec_for(S_MAX, B, page_size=P)
    jc, _ = jlm.init_caches(jcfg, B, S_MAX, paged=spec)
    tc = tlm.init_caches(tcfg, tpaged.spec_for(S_MAX, B, page_size=P),
                         device="cpu")
    chunk = _jit(lambda p, c, t, s, r, l, cfg: jlm.prefill_chunk(
        p, c, t, s, r, cfg, last=l), jcfg)
    rng = np.random.default_rng(0)
    bt = np.zeros((B, spec.max_blocks), np.int32)
    bt[0, :4] = [3, 1, 4, 2]
    bt[1, :2] = [5, 6]
    pairs = []
    for b in range(B):
        prompt = rng.integers(0, jcfg.vocab, LENS[b]).astype(np.int32)
        for ci in range(-(-LENS[b] // C)):
            buf = np.zeros(C, np.int32)
            seg = prompt[ci * C:(ci + 1) * C]
            buf[: len(seg)] = seg
            last = (LENS[b] - 1) - ci * C if (ci + 1) * C >= LENS[b] else 0
            jl, jc = chunk(params, jc, jnp.asarray(buf[None]),
                           jnp.int32(ci * C), jnp.asarray(bt[b]),
                           jnp.int32(last))
            tl, _ = tlm.prefill_chunk(tp, tc, torch.from_numpy(buf[None]),
                                      ci * C, torch.from_numpy(bt[b]), tcfg,
                                      last=last)
            pairs.append((f"chunk {b}.{ci}", to_np(jl), tl.float().numpy()))
    lens = np.array(LENS, np.int32)
    cur = rng.integers(0, jcfg.vocab, (B, 1)).astype(np.int32)
    flash_pairs = []
    tflash = [{b: {n: t.clone() for n, t in pool.items()}
               for b, pool in seg.items()} for seg in tc]
    fl, _ = tlm.decode_step_paged(
        tp, tflash, torch.from_numpy(cur), torch.from_numpy(lens),
        torch.from_numpy(bt),
        dataclasses.replace(tcfg, serve_paged_attn_impl="flash"))
    jl, jc = _jit(jlm.decode_step_paged, jcfg)(
        params, jc, jnp.asarray(cur), jnp.asarray(lens), jnp.asarray(bt))
    tl, _ = tlm.decode_step_paged(
        tp, tc, torch.from_numpy(cur), torch.from_numpy(lens),
        torch.from_numpy(bt),
        dataclasses.replace(tcfg, serve_paged_attn_impl="lax"))
    pairs.append(("decode lax", to_np(jl), tl.float().numpy()))
    flash_pairs.append(("decode flash", to_np(jl), fl.float().numpy()))
    lens = lens + 1
    toks = rng.integers(0, jcfg.vocab, (B, K1)).astype(np.int32)
    nw = np.array([K1, 2], np.int32)
    jl, jc = _jit(jlm.verify_step_paged, jcfg)(
        params, jc, jnp.asarray(toks), jnp.asarray(lens), jnp.asarray(nw),
        jnp.asarray(bt))
    tl, _ = tlm.verify_step_paged(
        tp, tc, torch.from_numpy(toks), torch.from_numpy(lens),
        torch.from_numpy(nw), torch.from_numpy(bt), tcfg)
    for b in range(B):
        for j in range(K1):
            pairs.append((f"verify {b}.{j}", to_np(jl[b, j]),
                          tl[b, j].float().numpy()))
    jpool = convert.pool_from_jax(jax.tree.map(np.asarray, jc), device="cpu")
    return pairs, flash_pairs, jpool, tc


def bf16_ulps(got, want):
    """Elementwise distance in bf16 steps of two bf16-valued arrays."""
    def ordered(x):
        b = (np.asarray(x, np.float32).view(np.int32) >> 16).astype(np.int64)
        return np.where(b < 0, -(b & 0x7FFF), b)
    return np.abs(ordered(got) - ordered(want))


def rows_match(pairs):
    """Names of the ``(name, want, got)`` rows that break the head-GEMM
    allowance (``HEAD_ULP_SHARE``), and the number of bit-equal rows."""
    bad, exact = [], 0
    for name, want, got in pairs:
        if got.shape != want.shape:
            bad.append(name)
            continue
        d = bf16_ulps(got, want)
        exact += int(not d.any())
        if d.max() > 1 or (d > 0).sum() > max(1, HEAD_ULP_SHARE * d.size):
            bad.append(name)
    return bad, exact


def assert_forwards_match(family, layout, kv="fp", **kw):
    import torch

    pairs, flash_pairs, jpool, tpool = paged_forwards(family, layout, kv,
                                                      **kw)
    bad, exact = rows_match(pairs)
    assert not bad, (family, layout, kv, bad)
    assert exact >= len(pairs) - 1, (family, layout, kv, exact, len(pairs))
    for name, want, got in flash_pairs:
        assert np.isfinite(got).all()
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= FLASH_LOGIT_TOL * scale, name
    for name, want in jpool[0]["b0"].items():
        got = tpool[0]["b0"][name]
        assert got.dtype == want.dtype and got.shape == want.shape, name
        if got.dtype == torch.bfloat16:
            got, want = got.view(torch.int16), want.view(torch.int16)
        assert torch.equal(got, want), name


def tpaged_spec():
    """The port's ``PageSpec`` of the forward tests."""
    from repro_torch.kernels import paged as tpaged

    return tpaged.spec_for(S_MAX, B, page_size=P)
