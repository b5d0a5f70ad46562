#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py                 # everything, as the check runs it
    python3 chip_smoke.py --only kernels  # build + kernel-vs-plain phases

Phases, in order; any failure raises and exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build both CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
   each, started together) and print the build time;
3. each kernel against its plain PyTorch version on the card, at the
   main path's shapes: the lookup GEMM must be bit-equal in int32,
   flash-decode within the stated f32 tolerance; times of the kernel,
   the plain version, the bound and (flash-decode) SDPA over the
   gathered K/V as a yardstick;
4. the main path: full-width codeqwen1.5-7b with seeded random TLMAC
   weights drawn on the card, ``PagedServeLoop(batch_slots=4,
   s_max=1024, page_size=16)`` over six requests, with every launch
   counter reset before and read after the run;
5. the port on the card against the port on the CPU (plain versions) on
   the two smoke configs, teacher-forced, logits within tolerance.

The line before the last is the kernel JSON; the last line is the
device JSON.  Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): device memory and the
# non-tensor-core f32 rate, against which int32 lookup-adds and f32
# attention flops are counted (one operation each).
HBM_BYTES_S = 3.35e12
NONTENSOR_OPS_S = 67e12
FLASH_TOL = 1e-4     # f32: only the order of the softmax sums differs
LOGIT_TOL = 3e-2     # bf16 logits of the whole model, card vs CPU

PROMPT_LENS = (37, 128, 211, 300, 64, 500)
MAX_NEW = 32
CHUNK = 64           # prefill chunk of the main path
SEED = 0


def log(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 2) -> float:
    """Mean ms per call over ``iters`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rotation(nbytes: int) -> int:
    """Input copies to cycle through so repeated launches find them out of
    the 50 MB L2, as the main path does (each layer has its own)."""
    return max(1, min(8, math.ceil(128e6 / max(nbytes, 1))))


# ---------------------------------------------------------------------------
# kernel 1: fused lookup GEMM
# ---------------------------------------------------------------------------

GEMM_SHAPES = {  # name: (K, N, dp) of codeqwen1.5-7b's serve linears
    "q/k/v/o 4096->4096": (4096, 4096, 128),
    "wi/wg 4096->13440": (4096, 13440, 120),
    "wo 13440->4096": (13440, 4096, 128),
}
DECODE_LAYER_MIX = {"q/k/v/o 4096->4096": 4, "wi/wg 4096->13440": 2,
                    "wo 13440->4096": 1}


def phase_gemm(chunk: int, batch: int, B_a=3, G=4, n_arr=4096, n_clus=4):
    import torch

    from repro_torch.kernels import tlmac_fused as tf

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for name, (K, N, dp) in GEMM_SHAPES.items():
        nt, kg = N // dp, K // G
        reps = rotation(nt * kg * dp * 2)
        plans = [(torch.randint(0, n_arr, (nt, kg, dp), dtype=torch.int16,
                                generator=gen, device="cuda"),
                  torch.randint(0, n_clus, (nt, kg), dtype=torch.int8,
                                generator=gen, device="cuda"),
                  torch.randint(-8, 8, (n_clus, n_arr, 2**G),
                                dtype=torch.int32, generator=gen,
                                device="cuda"))
                 for _ in range(reps)]
        for M in sorted({1, batch, chunk}):
            aq = torch.randint(0, 2**B_a, (M, K), dtype=torch.int8,
                               generator=gen, device="cuda")
            idx, cl, tab = plans[0]
            got = tf.tlmac_gemm_fused(aq, idx, cl, tab, B_a=B_a, G=G)
            want = tf.tlmac_gemm_fused_plain(aq, idx, cl, tab, B_a=B_a, G=G)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                bad = (got != want).sum().item()
                raise AssertionError(f"lookup GEMM {name} M={M}: {bad} int32 "
                                     "outputs differ from the plain version")
            it = iter(range(1 << 30))

            def run_kernel():
                i, c, t = plans[next(it) % reps]
                tf.tlmac_gemm_fused(aq, i, c, t, B_a=B_a, G=G)

            ms = cuda_ms(run_kernel, iters=20)
            plain_ms = cuda_ms(lambda: tf.tlmac_gemm_fused_plain(
                aq, idx, cl, tab, B_a=B_a, G=G), iters=3, warmup=1)
            nbytes = M * K + idx.numel() * 2 + cl.numel() + tab.numel() * 4 \
                + M * N * 4
            ops = M * B_a * kg * N
            bound = max(nbytes / HBM_BYTES_S, ops / NONTENSOR_OPS_S) * 1e3
            by = "bytes" if nbytes / HBM_BYTES_S >= ops / NONTENSOR_OPS_S \
                else "operations"
            rows[(name, M)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                   bound_by=by)
            log(f"  lookup GEMM {name:20s} M={M:3d}: equal int32; kernel "
                f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound:.4f} ms "
                f"({by}), {bound / ms:.1%} of bound")
        del plans
    # the JSON entry: one decode step's seven lookup GEMMs of one layer
    key = lambda n: rows[(n, batch)]
    tot = {f: sum(key(n)[f] * c for n, c in DECODE_LAYER_MIX.items())
           for f in ("ms", "plain_ms", "bound_ms")}
    by = key("wi/wg 4096->13440")["bound_by"]
    log(f"  decode layer (7 lookup GEMMs, M={batch}): kernel {tot['ms']:.4f} "
        f"ms, plain {tot['plain_ms']:.3f} ms, bound {tot['bound_ms']:.4f} ms")
    return dict(name="tlmac_gemm_fused", route="cuda",
                source="src/repro_torch/csrc/tlmac_fused.cu",
                replaces="src/repro/kernels/tlmac_fused.py:199",
                shape=f"one decode layer: 4x4096->4096, 2x4096->13440, "
                      f"1x13440->4096 at M={batch}",
                max_abs_err=0, bound_by=by, library_ms=None, **tot)


# ---------------------------------------------------------------------------
# kernel 2: paged flash-decode
# ---------------------------------------------------------------------------

MAIN_LENS = (53, 144, 227, 316)   # four prompts of the main path + 16 tokens


def _pool(gen, kv, n_pages, P, KV, hd):
    import torch

    if kv == "fp":
        k = torch.randn((n_pages, P, KV, hd), generator=gen, device="cuda")
        v = torch.randn((n_pages, P, KV, hd), generator=gen, device="cuda")
        return k.bfloat16(), v.bfloat16(), None, None
    w = hd // 2 if kv == "int4" else hd
    lo, hi = (-128, 128) if kv == "int4" else (-127, 128)
    k, v = (torch.randint(lo, hi, (n_pages, P, KV, w), dtype=torch.int8,
                          generator=gen, device="cuda") for _ in range(2))
    ks, vs = ((torch.rand((n_pages, P, KV), generator=gen, device="cuda")
               * 0.05 + 0.001).bfloat16() for _ in range(2))
    return k, v, ks, vs


def _flash_case(gen, kv, B, KV, rep, hd, P, MB, lens, window, n_splits,
                idle=()):
    import torch

    n_pages = B * MB + 1
    k, v, ks, vs = _pool(gen, kv, n_pages, P, KV, hd)
    bt = (torch.randperm(n_pages - 1, generator=gen, device="cuda")[:B * MB]
          + 1).reshape(B, MB).to(torch.int32)
    for b in idle:
        bt[b] = 0
    q = torch.randn((B, KV, rep, hd), generator=gen, device="cuda").bfloat16()
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return dict(q=q, k_pages=k, v_pages=v, block_table=bt, lengths=lengths,
                window=window, n_splits=n_splits, k_scales=ks, v_scales=vs,
                kv_dtype=kv)


def _flash_plain(a):
    from repro_torch.kernels import flash_decode as fd

    kw = dict(a)
    return fd.combine_splits(*fd.flash_decode_partials_plain(
        kw.pop("q"), kw.pop("k_pages"), kw.pop("v_pages"),
        kw.pop("block_table"), kw.pop("lengths"), **kw))


def _flash_kernel(a):
    from repro_torch.kernels import flash_decode as fd

    kw = dict(a)
    return fd.flash_decode(kw.pop("q"), kw.pop("k_pages"), kw.pop("v_pages"),
                           kw.pop("block_table"), kw.pop("lengths"), **kw)


def phase_flash():
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = 0.0
    cases = [
        ("rep1 hd128 KV32", dict(B=4, KV=32, rep=1, hd=128, P=16, MB=64,
                                 lens=MAIN_LENS, window=None, n_splits=4)),
        ("rep1 hd128 window 64, 1 split",
         dict(B=4, KV=32, rep=1, hd=128, P=16, MB=64, lens=MAIN_LENS,
              window=64, n_splits=1)),
        ("rep4 hd128 KV8", dict(B=4, KV=8, rep=4, hd=128, P=16, MB=64,
                                lens=MAIN_LENS, window=None, n_splits=4)),
        ("rep4 hd16 KV2 window 8, idle slot",
         dict(B=3, KV=2, rep=4, hd=16, P=8, MB=6, lens=(1, 20, 48),
              window=8, n_splits=4, idle=(0,))),
    ]
    for kv in ("fp", "int8", "int4"):
        for label, c in cases:
            a = _flash_case(gen, kv, **c)
            got = _flash_kernel(a)
            want = _flash_plain(a)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            worst = max(worst, err)
            if not err <= FLASH_TOL:
                raise AssertionError(f"flash-decode {kv} {label}: max abs err "
                                     f"{err} > {FLASH_TOL}")
            log(f"  flash-decode {kv:4s} {label:34s}: max abs err {err:.3e}")

    # timed at the main path's decode shape: B=4 slots of full-width
    # codeqwen (KV=32, rep=1, hd=128), 16-token pages, s_max=1024
    B, KV, rep, hd, P, MB = 4, 32, 1, 128, 16, 64
    a = _flash_case(gen, "fp", B, KV, rep, hd, P, MB, MAIN_LENS, None, 4)
    reps = rotation(a["k_pages"].numel() * 4)
    copies = [a] + [dict(a, k_pages=a["k_pages"].clone(),
                         v_pages=a["v_pages"].clone()) for _ in range(reps - 1)]
    it = iter(range(1 << 30))
    ms = cuda_ms(lambda: _flash_kernel(copies[next(it) % reps]), iters=50)
    plain_ms = cuda_ms(lambda: _flash_plain(a), iters=5, warmup=1)
    # library yardstick: SDPA (bf16) over K/V gathered beforehand
    from repro_torch.kernels.paged import gather_kv

    kc, vc = gather_kv(a["k_pages"], a["v_pages"], a["block_table"])
    qh = a["q"].reshape(B, KV * rep, 1, hd)
    kh, vh = kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3)
    S = kc.shape[1]
    mask = (torch.arange(S, device="cuda")[None, :]
            < a["lengths"][:, None].long())[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(lambda: sdpa(qh, kh, vh, attn_mask=mask), iters=50)
    # bytes the function needs: the live tokens' K and V (bf16), the
    # block-table entries of their pages, q, lengths and the f32 output
    pages = sum(-(-L // P) for L in MAIN_LENS)
    nbytes = (sum(MAIN_LENS) * KV * hd * 2 * 2 + pages * 4
              + a["q"].numel() * 2 + B * 4 + B * KV * rep * hd * 4)
    ops = 4 * KV * rep * hd * sum(MAIN_LENS)
    t_b, t_o = nbytes / HBM_BYTES_S, ops / NONTENSOR_OPS_S
    bound = max(t_b, t_o) * 1e3
    by = "bytes" if t_b >= t_o else "operations"
    log(f"  flash-decode fp main-path shape: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bound:.4f} ms ({by}), SDPA over gathered "
        f"K/V {library_ms:.4f} ms; tolerance {FLASH_TOL} (f32)")
    return dict(name="flash_decode", route="cuda",
                source="src/repro_torch/csrc/flash_decode.cu",
                replaces="src/repro/kernels/flash_decode.py:206",
                shape=f"B=4 KV=32 rep=1 hd=128 P=16 MB=64 fp, lengths "
                      f"{list(MAIN_LENS)}, 4 splits",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=library_ms)


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------


def _requests(vocab, lens, max_new, seed):
    import numpy as np

    from repro_torch.serve.loop import Request

    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, vocab, n).astype(np.int32),
                    max_new_tokens=max_new) for i, n in enumerate(lens)]


PROFILED_STEP = 10   # decode step traced with torch.profiler


def _profiled(fn, a, kw):
    """Run one forward under torch.profiler and print where its device
    time goes: the two hand kernels, every other kernel, and the busy
    share of the step's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        logits = fn(*a, **kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    by_name = {}
    for e in prof.key_averages():
        # kernel events only: CPU ops carry their kernels' time as well
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
    busy = sum(by_name.values())
    if not busy:
        log("  profiled decode step: device time not measured (the profiler "
            "recorded none)")
        return logits
    gemm = sum(v for k, v in by_name.items() if "tlmac_fused_kernel" in k)
    flash = sum(v for k, v in by_name.items() if "flash_decode_kernel" in k)
    others = sorted(((v, k) for k, v in by_name.items()
                     if "tlmac_fused_kernel" not in k
                     and "flash_decode_kernel" not in k), reverse=True)
    log(f"  profiled decode step {PROFILED_STEP}: wall {wall:.2f} ms (under "
        f"the profiler), device busy {busy:.2f} ms ({busy / wall:.1%}), idle "
        f"{1 - busy / wall:.1%}; lookup GEMM {gemm:.2f} ms, flash-decode "
        f"{flash:.2f} ms, {len(others)} other kernels "
        f"{busy - gemm - flash:.2f} ms")
    for v, k in others[:5]:
        log(f"    {v:8.3f} ms  {k[:90]}")
    return logits


def phase_main():
    """The main path: full-width codeqwen1.5-7b served on the card."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import tlmac_fused as tf
    from repro_torch.models import lm
    from repro_torch.serve.paged import PagedServeLoop

    sync = torch.cuda.synchronize
    cfg = get_config("codeqwen1.5-7b")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = lm.init_lm(cfg, gen, device="cuda")
    sync()
    log(f"  init {cfg.name} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab}) on the card: "
        f"{time.perf_counter() - t0:.1f} s")
    loop = PagedServeLoop(params, cfg, batch_slots=4, s_max=1024,
                          page_size=16, chunk=CHUNK, device="cuda")
    by_kind = {}
    for name, t in params.named_buffers():
        kind = name.rsplit(".", 1)[-1]
        by_kind[kind] = by_kind.get(kind, 0) + t.numel() * t.element_size()
    for name, t in params.named_parameters():
        kind = "embed/head" if name.split(".")[0] in ("embed", "head") \
            else "float weights"
        by_kind[kind] = by_kind.get(kind, 0) + t.numel() * t.element_size()
    pool = loop.kv_pool_bytes()
    log("  reckoned memory: " + ", ".join(
        f"{k} {v / 2**30:.3f} GiB" for k, v in sorted(by_kind.items()))
        + f", KV pool {pool / 2**30:.3f} GiB; total "
        f"{(sum(by_kind.values()) + pool) / 2**30:.3f} GiB")

    times = {"prefill": [], "decode": []}
    calls = {"prefill": 0, "decode": 0}

    def timed(kind, fn):
        def wrapper(*a, **kw):
            if kind == "decode" and calls[kind] == PROFILED_STEP:
                logits = _profiled(fn, a, kw)    # kept out of the timings
            else:
                sync()
                t = time.perf_counter()
                logits = fn(*a, **kw)
                sync()
                times[kind].append(time.perf_counter() - t)
            calls[kind] += 1
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"non-finite logits in a {kind} forward")
            return logits
        return wrapper

    loop._prefill_chunk = timed("prefill", loop._prefill_chunk)
    loop._decode = timed("decode", loop._decode)
    reqs = _requests(cfg.vocab, PROMPT_LENS, MAX_NEW, SEED)
    for r in reqs:
        loop.submit(r)
    torch.cuda.reset_peak_memory_stats()
    tf.launches = 0
    fd.launches = 0
    t_run = time.perf_counter()
    done = loop.run()
    sync()
    wall = time.perf_counter() - t_run
    counts = {"tlmac_gemm_fused": tf.launches, "flash_decode": fd.launches}
    assert len(done) == len(reqs), (len(done), len(reqs))
    for r in done:
        assert len(r.output) == MAX_NEW, (r.rid, len(r.output))
        assert 0 <= int(r.output.min()) and int(r.output.max()) < cfg.vocab
    assert loop.refills >= 2, f"only {loop.refills} mid-decode admissions"
    want_gemm = 7 * cfg.n_layers * (calls["prefill"] + calls["decode"])
    want_flash = cfg.n_layers * calls["decode"]
    assert counts["tlmac_gemm_fused"] == want_gemm, (counts, want_gemm)
    assert counts["flash_decode"] == want_flash, (counts, want_flash)
    loop.pages.check()
    dec = sorted(times["decode"])
    prompt_tokens = sum(PROMPT_LENS)
    log(f"  served {len(done)} requests x {MAX_NEW} tokens in {wall:.2f} s: "
        f"{calls['prefill']} prefill chunks (chunk {CHUNK}), "
        f"{calls['decode']} decode steps, {loop.refills} mid-decode "
        "admissions; all logits finite")
    log(f"  decode step: median {dec[len(dec) // 2] * 1e3:.2f} ms, min "
        f"{dec[0] * 1e3:.2f} ms, max {dec[-1] * 1e3:.2f} ms "
        f"(batch_slots 4, host clock around a synchronised step)")
    log(f"  prefill: {prompt_tokens} prompt tokens in "
        f"{sum(times['prefill']):.2f} s = "
        f"{prompt_tokens / sum(times['prefill']):.1f} tok/s "
        f"({calls['prefill'] * CHUNK} padded chunk tokens)")
    log(f"  max_memory_allocated during the run: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(f"  launches: lookup GEMM {counts['tlmac_gemm_fused']} (= 7 x "
        f"{cfg.n_layers} layers x {calls['prefill'] + calls['decode']} "
        f"forwards), flash-decode {counts['flash_decode']} (= {cfg.n_layers}"
        f" x {calls['decode']} decode steps)")
    del loop, params
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# card vs CPU on the smoke configs
# ---------------------------------------------------------------------------


def phase_reference(seed: int = SEED):
    import torch

    from repro_torch.configs import smoke_config
    from repro_torch.models import lm
    from repro_torch.serve.paged import PagedServeLoop

    for name in ("codeqwen1.5-7b", "mistral-large-123b"):
        cfg = smoke_config(name)
        params = lm.init_lm(cfg, torch.Generator().manual_seed(seed),
                            device="cpu")
        reqs = lambda: _requests(cfg.vocab, (6, 11, 3, 9, 5), 6, seed)
        kw = dict(batch_slots=2, s_max=48, page_size=8, chunk=8)
        ref = PagedServeLoop(params, cfg, device="cpu", **kw)
        rec = []
        for kind in ("_prefill_chunk", "_decode"):
            fn = getattr(ref, kind)
            setattr(ref, kind, (lambda f: lambda *a: rec.append(f(*a))
                                or rec[-1])(fn))
        for r in reqs():
            ref.submit(r)
        ref.run()
        gpu = PagedServeLoop(params.to("cuda"), cfg, device="cuda", **kw)
        it = iter(rec)
        worst = 0.0

        def forced(f):
            def wrapper(*a):
                nonlocal worst
                got = f(*a).float().cpu()
                want = next(it)
                worst = max(worst, (got - want.float()).abs().max().item())
                return want.to("cuda")          # teacher forcing
            return wrapper

        gpu._prefill_chunk = forced(gpu._prefill_chunk)
        gpu._decode = forced(gpu._decode)
        for r in reqs():
            gpu.submit(r)
        gpu.run()
        scale = max(w.float().abs().max().item() for w in rec)
        if not worst <= LOGIT_TOL * scale:
            raise AssertionError(f"{name} smoke: card vs CPU logits differ by "
                                 f"{worst} > {LOGIT_TOL} x {scale}")
        log(f"  {name} smoke: {len(rec)} teacher-forced forwards, card vs "
            f"CPU max |dlogit| {worst:.3e} (scale {scale:.3f}, tolerance "
            f"{LOGIT_TOL} x scale)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("all", "kernels"), default="all")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 matmuls stay f32
    torch.backends.cudnn.allow_tf32 = False
    log(gpu_line())
    t0 = time.perf_counter()
    logs = _build.build(["tlmac_fused", "flash_decode"])
    log(f"build: tlmac_fused.cu + flash_decode.cu with nvcc -arch sm_90a in "
        f"{time.perf_counter() - t0:.1f} s (parallel)")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    log("phase: lookup GEMM vs plain (int32, must be equal)")
    gemm = phase_gemm(chunk=CHUNK, batch=4)
    log("phase: flash-decode vs plain")
    flash = phase_flash()
    # launches are counted on the main path only: null when it did not run
    counts = {"tlmac_gemm_fused": None, "flash_decode": None}
    if args.only == "all":
        log("phase: main path")
        counts = phase_main()
        log("phase: card vs CPU on smoke configs")
        phase_reference()
    gemm["launches"] = counts["tlmac_gemm_fused"]
    flash["launches"] = counts["flash_decode"]
    log(json.dumps({"kernels": [gemm, flash]}))
    if args.only != "all":
        return 0
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
