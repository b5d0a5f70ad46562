#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py                 # everything, as the check runs it
    python3 chip_smoke.py --only kernels  # build + kernel phases only

Phases, in order; any failure raises and exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build the five CUDA sources of ``src/repro_torch/csrc`` (one ``nvcc``
   each, started together) and print the build time;
3. kernels 1-2 (fused lookup GEMM, flash-decode) against their plain
   PyTorch versions at the serve path's shapes (kernel 1 at M 1, 4, 16,
   17 and 64, on tables narrowed once as the serve params hold them),
   and kernel 1 at the edges of its dp4a and mma.sync paths (G 3/4,
   ragged kg, odd dp, uint8/int16 indices, int16 rows): the lookup GEMM
   must be bit-equal in int32, flash-decode within the stated f32
   tolerance over fp/int8/int4 pools, windows, idle slots, 1 to 16
   splits and two rep chunks; times of the kernel, the plain version,
   the bound and a library yardstick: one ``torch._int_mm`` of the
   one-hot coefficients against the gathered table rows (held equal),
   beside a dense int8 ``_int_mm`` of the same shape as context, and
   SDPA over the gathered K/V;
4. kernels 3-6 (bit-plane pack, lookup GEMM on packed codes, the
   cluster-scheduled GEMM for one tile and for every tile) against their
   plain versions and the dense integer GEMM on small compiled plans, at
   the reference's own test shapes;
5. full-width ResNet-18 (``configs/resnet18.CONFIG``) drawn on the card
   and its 16 basic-block convs compiled on the host
   (``compile_resnet``): compile seconds and the Fig. 8 cost report per
   conv, ``verify_plan`` on each;
6. kernels 1 and 3-6 at those 16 convs' shapes (batch 32, 56x56 input):
   int32-equal to their plain versions, kernels 5/6 to kernel 3's row
   GEMMs and to ``torch._int_mm`` of the plan's weights; kernel, plain,
   bound (bytes over HBM or the one-hot product over the int8
   tensor-core peak, both printed) and ``torch._int_mm`` times per
   stage (kernels 3-6 and their ``_int_mm`` by CUDA-graph replay, the
   eager time beside; kernels 1 and 3 on the narrow tables that
   ``conv_row_plan`` holds), and the whole conv against ``conv2d`` of
   the codes;
7. the serve main path: full-width codeqwen1.5-7b with seeded random
   TLMAC weights drawn on the card, ``PagedServeLoop(batch_slots=4,
   s_max=1024, page_size=16)`` over six requests, with the launch
   counters of kernels 1-2 reset before and read after the run;
8. the port on the card against the port on the CPU (plain versions) on
   the two smoke configs, teacher-forced, logits within tolerance;
9. the paper path: ResNet-18's forward on 32 seeded 56x56 images, then
   every conv as a lookup conv (kernels 4 + 3) and as one
   cluster-scheduled launch (kernels 4 + 6, and 5 on the single-tile
   convs), each equal to the integer conv, with the launch counters of
   kernels 3-6 reset before and asserted after; and ``TLMACLinear`` at
   the quickstart's shape equal to the dense integer GEMM.

The line before the last is the kernel JSON (all six kernels); the last
line is the device JSON.  Needs one CUDA card; exits non-zero without
one.
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

# H100 SXM peaks (NVIDIA data sheet, dense): device memory, the
# non-tensor-core f32 rate, against which int32 lookup-adds and f32
# attention flops are counted (one operation each), and the int8
# tensor-core rate, against which kernel 1's one-hot product is counted.
HBM_BYTES_S = 3.35e12
NONTENSOR_OPS_S = 67e12
INT8_TC_OPS_S = 1979e12
FLASH_TOL = 1e-4     # f32: only the order of the softmax sums differs
LOGIT_TOL = 3e-2     # bf16 logits of the whole model, card vs CPU

PROMPT_LENS = (37, 128, 211, 300, 64, 500)
MAX_NEW = 32
CHUNK = 64           # prefill chunk of the main path
SEED = 0
DEV = "cuda"         # every phase runs on the card
SOURCES = ("tlmac_fused", "flash_decode", "bitplanes", "tlmac_gemm",
           "tlmac_clustered")


T_START = time.perf_counter()


def log(*a):
    print(*a, flush=True)


def phase(name: str):
    log(f"phase: {name} (at {time.perf_counter() - T_START:.1f} s)")


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


_SIDE_STREAM = []   # one warm-up stream for every graph_ms call


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device ms per call: ``iters`` calls captured in one CUDA graph and
    replayed, so the host's cost between calls is not timed.  A decode
    kernel runs for tens of microseconds, less than its Python wrapper
    takes to launch it, and back-to-back eager calls (``cuda_ms``) then
    time the host."""
    import torch

    fn()
    # the warm-up runs on one side stream for the whole script: cuBLAS
    # keeps a workspace for every stream it has run on, so a new stream
    # per call would leave memory allocated into the serve run's peak
    if not _SIDE_STREAM:
        _SIDE_STREAM.append(torch.cuda.Stream())
    side = _SIDE_STREAM[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


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
GEMM_MS = (1, 4, 16, 17, 64)   # both inner products and their boundary
INT_MM_MIN_M = 32              # torch._int_mm refuses M <= 16: pad to 32


def _gemm_bound(M, kg, N, G, nbytes):
    """The least time (ms) of one lookup GEMM: its bytes over HBM, or the
    one-hot product's 2*M*2^G*kg*N operations over the int8 tensor-core
    peak, whichever is larger; with the two times it is the larger of."""
    t_b = nbytes / HBM_BYTES_S * 1e3
    t_o = 2 * M * 2**G * kg * N / INT8_TC_OPS_S * 1e3
    return dict(bound_ms=max(t_b, t_o), bytes_ms=t_b, ops_ms=t_o)


def _bound_by(d):
    return "bytes" if d["bytes_ms"] >= d["ops_ms"] else "operations"


def _onehot_int_mm(tf, aq, idx, cl, tab, B_a, G):
    """The library yardstick of a lookup GEMM: one ``torch._int_mm`` of the
    one-hot coefficients ``A' [M, 2^G*kg]`` (zero rows pad M to 32) against
    the narrow table rows gathered beforehand, ``W' [2^G*kg, N]``: the same
    function for any table.  Returns the padded A', W' and the call."""
    import torch

    M = aq.shape[0]
    coef = tf.onehot_coefficients(aq, B_a, G).reshape(M, -1).to(torch.int8)
    a_pad = torch.zeros((max(M, INT_MM_MIN_M), coef.shape[1]),
                        dtype=torch.int8, device=aq.device)
    a_pad[:M] = coef
    w = tf.gathered_rows(idx, cl, tab).contiguous()
    return lambda: torch._int_mm(a_pad, w)[:M]


def phase_gemm(chunk: int, batch: int, B_a=3, G=4, n_arr=4096, n_clus=4):
    import torch

    from repro_torch.kernels import tlmac_fused as tf

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for name, (K, N, dp) in GEMM_SHAPES.items():
        nt, kg = N // dp, K // G
        reps = rotation(nt * kg * dp * 2)
        # the serve path's params: int32 tables narrowed once at init
        plans = [(torch.randint(0, n_arr, (nt, kg, dp), dtype=torch.int16,
                                generator=gen, device="cuda"),
                  torch.randint(0, n_clus, (nt, kg), dtype=torch.int8,
                                generator=gen, device="cuda"),
                  tf.narrow_table(torch.randint(
                      -8, 8, (n_clus, n_arr, 2**G), dtype=torch.int32,
                      generator=gen, device="cuda")))
                 for _ in range(reps)]
        idx, cl, tab = plans[0]
        assert tab.dtype == torch.int8, tab.dtype
        for M in GEMM_MS:
            aq = torch.randint(0, 2**B_a, (M, K), dtype=torch.int8,
                               generator=gen, device="cuda")
            got = tf.tlmac_gemm_fused(aq, idx, cl, tab, B_a=B_a, G=G)
            want = tf.tlmac_gemm_fused_plain(aq, idx, cl, tab, B_a=B_a, G=G)
            _equal(f"lookup GEMM {name} M={M}", got, want)
            if M not in (batch, chunk):
                log(f"  lookup GEMM {name:20s} M={M:3d}: equal int32")
                continue
            it = iter(range(1 << 30))

            def run_kernel():
                i, c, t = plans[next(it) % reps]
                tf.tlmac_gemm_fused(aq, i, c, t, B_a=B_a, G=G)

            ms = graph_ms(run_kernel)
            eager_ms = cuda_ms(run_kernel, iters=20)
            plain_ms = cuda_ms(lambda: tf.tlmac_gemm_fused_plain(
                aq, idx, cl, tab, B_a=B_a, G=G), iters=3, warmup=1)
            nbytes = M * K + idx.numel() * 2 + cl.numel() + tab.numel() \
                + M * N * 4
            b = _gemm_bound(M, kg, N, G, nbytes)
            bound, by = b["bound_ms"], _bound_by(b)
            lib = _onehot_int_mm(tf, aq, idx, cl, tab, B_a, G)
            _equal(f"lookup GEMM {name} M={M} one-hot _int_mm", lib(), got)
            lib_ms = graph_ms(lib)
            del lib
            a8 = torch.randint(-128, 128, (max(M, INT_MM_MIN_M), K),
                               dtype=torch.int8, generator=gen, device="cuda")
            w8 = torch.randint(-128, 128, (K, N), dtype=torch.int8,
                               generator=gen, device="cuda")
            dense_ms = graph_ms(lambda: torch._int_mm(a8, w8))
            del a8, w8
            rows[(name, M)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                   bound_by=by, library_ms=lib_ms,
                                   eager_ms=eager_ms)
            log(f"  lookup GEMM {name:20s} M={M:3d}: equal int32; kernel "
                f"{ms:.4f} ms (eager calls {eager_ms:.4f} ms), plain "
                f"{plain_ms:.3f} ms, bound {bound:.4f} ms "
                f"({by}), {bound / ms:.1%} of bound; one-hot _int_mm "
                f"(M padded to {max(M, INT_MM_MIN_M)}) {lib_ms:.4f} ms, "
                f"equal int32; context: dense int8 _int_mm "
                f"[{max(M, INT_MM_MIN_M)},{K}]x[{K},{N}] {dense_ms:.4f} ms")
        del plans
    fields = ("ms", "eager_ms", "plain_ms", "bound_ms", "library_ms")
    for M in sorted({batch, chunk}):
        tot = {f: sum(rows[(n, M)][f] * c for n, c in DECODE_LAYER_MIX.items())
               for f in fields}
        log(f"  one layer's 7 lookup GEMMs at M={M}: kernel {tot['ms']:.4f} "
            f"ms (eager calls {tot['eager_ms']:.4f} ms), plain "
            f"{tot['plain_ms']:.3f} ms, bound {tot['bound_ms']:.4f} ms, "
            f"one-hot _int_mm {tot['library_ms']:.4f} ms")
    # the JSON entry: one decode step's seven lookup GEMMs of one layer
    tot = {f: sum(rows[(n, batch)][f] * c for n, c in DECODE_LAYER_MIX.items())
           for f in ("ms", "plain_ms", "bound_ms", "library_ms")}
    by = rows[("wi/wg 4096->13440", batch)]["bound_by"]
    return dict(name="tlmac_gemm_fused", route="cuda",
                source="src/repro_torch/csrc/tlmac_fused.cu",
                replaces="src/repro/kernels/tlmac_fused.py:199",
                shape=f"one decode layer: 4x4096->4096, 2x4096->13440, "
                      f"1x13440->4096 at M={batch}",
                max_abs_err=0, bound_by=by, **tot)


def phase_gemm_edges(B_a=3):
    """Kernel 1 at the edges of both inner products, int32-equal to its
    plain version: M across the dp4a/mma boundary, ragged kg, dp 120 and
    odd, uint8 and int16 indices, G 3 and 4, and an int16-row table."""
    import torch

    from repro_torch.kernels import tlmac_fused as tf

    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = [  # (G, n_tiles, kg, dp, n_arr, idx dtype, table range)
        (4, 3, 37, 120, 600, torch.int16, (-8, 8)),
        (4, 2, 21, 128, 200, torch.uint8, (-128, 128)),
        (3, 3, 45, 64, 300, torch.int16, (-12, 10)),
        (3, 2, 19, 5, 100, torch.uint8, (-8, 8)),
        (4, 2, 37, 120, 600, torch.int16, (-300, 300)),   # int16 rows
        (3, 3, 22, 64, 200, torch.uint8, (-200, 200)),    # int16 rows
    ]
    n = 0
    for G, nt, kg, dp, n_arr, idt, (lo, hi) in cases:
        idx = torch.randint(0, n_arr, (nt, kg, dp), generator=gen,
                            device="cuda").to(idt)
        cl = torch.randint(0, 3, (nt, kg), dtype=torch.int8, generator=gen,
                           device="cuda")
        t32 = torch.randint(lo, hi, (3, n_arr, 2**G), dtype=torch.int32,
                            generator=gen, device="cuda")
        tab = tf.narrow_table(t32)
        want_dt = torch.int8 if -128 <= lo and hi <= 128 else torch.int16
        assert tab.dtype == want_dt, (tab.dtype, lo, hi)
        for M in GEMM_MS:
            aq = torch.randint(0, 2**B_a, (M, kg * G), dtype=torch.int8,
                               generator=gen, device="cuda")
            got = tf.tlmac_gemm_fused(aq, idx, cl, tab, B_a=B_a, G=G)
            _equal(f"lookup GEMM edge G={G} kg={kg} dp={dp} {idt} {tab.dtype} "
                   f"M={M}", got, tf.tlmac_gemm_fused_plain(
                       aq, idx, cl, t32, B_a=B_a, G=G))
            n += 1
    try:
        tf.tlmac_gemm_fused(aq, idx, cl, t32, B_a=B_a, G=G)
    except ValueError:
        pass
    else:
        raise AssertionError("the kernel took an int32 table")
    log(f"  lookup GEMM edges: {n} cases (M {list(GEMM_MS)}, G 3/4, ragged "
        "kg, dp 120/128/64/5, uint8/int16 indices, int8/int16 rows) equal "
        "int32 to the plain version; an int32 table is refused")


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
        ("rep1 hd128 KV32, 16 splits",
         dict(B=4, KV=32, rep=1, hd=128, P=16, MB=64, lens=MAIN_LENS,
              window=None, n_splits=16)),
        ("rep12 hd128 KV8 (2 rep chunks), idle slot",
         dict(B=3, KV=8, rep=12, hd=128, P=16, MB=32, lens=(1, 300, 77),
              window=None, n_splits=3, idle=(0,))),
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
    run_kernel = lambda: _flash_kernel(copies[next(it) % reps])
    ms = graph_ms(run_kernel, iters=50)
    eager_ms = cuda_ms(run_kernel, iters=50)
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
    library_ms = graph_ms(lambda: sdpa(qh, kh, vh, attn_mask=mask), iters=50)
    library_eager_ms = cuda_ms(lambda: sdpa(qh, kh, vh, attn_mask=mask),
                               iters=50)
    # bytes the function needs: the live tokens' K and V (bf16), the
    # block-table entries of their pages, q, lengths and the f32 output
    pages = sum(-(-L // P) for L in MAIN_LENS)
    nbytes = (sum(MAIN_LENS) * KV * hd * 2 * 2 + pages * 4
              + a["q"].numel() * 2 + B * 4 + B * KV * rep * hd * 4)
    ops = 4 * KV * rep * hd * sum(MAIN_LENS)
    t_b, t_o = nbytes / HBM_BYTES_S, ops / NONTENSOR_OPS_S
    bound = max(t_b, t_o) * 1e3
    by = "bytes" if t_b >= t_o else "operations"
    log(f"  flash-decode fp main-path shape: kernel {ms:.4f} ms (eager calls "
        f"{eager_ms:.4f} ms), plain {plain_ms:.3f} ms, bound {bound:.4f} ms "
        f"({by}), SDPA over gathered K/V {library_ms:.4f} ms (eager calls "
        f"{library_eager_ms:.4f} ms); tolerance {FLASH_TOL} (f32)")
    return dict(name="flash_decode", route="cuda",
                source="src/repro_torch/csrc/flash_decode.cu",
                replaces="src/repro/kernels/flash_decode.py:206",
                shape=f"B=4 KV=32 rep=1 hd=128 P=16 MB=64 fp, lengths "
                      f"{list(MAIN_LENS)}, 4 splits",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=library_ms)


# ---------------------------------------------------------------------------
# kernels 3-6: lookup GEMM on packed codes, bit-plane packing, and the
# cluster-scheduled lookup GEMM (one tile, every tile)
# ---------------------------------------------------------------------------

# the reference's own kernel test shapes (tests/test_kernels.py and
# tests/test_fused_autotune.py): (K, N, M, B_w, B_a, G[, d_p])
SWEEP = [(16, 64, 4, 2, 2, 2), (24, 64, 8, 3, 3, 3), (32, 128, 16, 3, 4, 4),
         (48, 64, 5, 4, 4, 6), (64, 192, 33, 2, 3, 4), (40, 128, 37, 3, 3, 4)]
CLUSTERED = [(64, 64, 21, 3, 3, 4), (24, 32, 7, 2, 2, 3), (48, 128, 9, 4, 4, 4)]
CLUSTERED_MULTI = [(64, 128, 21, 3, 3, 4, 64), (24, 96, 7, 2, 2, 3, 32),
                   (48, 128, 9, 4, 4, 4, 128)]
RESNET_BATCH = 32
RESNET_HW = 56      # the map sizes ImageNet ResNet-18's basic blocks see


def _equal(name, got, want):
    import torch

    torch.cuda.synchronize()
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)}, want "
                             f"{want.dtype} {tuple(want.shape)}")
    if not torch.equal(got, want):
        bad = (got != want).sum().item()
        raise AssertionError(f"{name}: {bad} outputs differ")


def _bound(nbytes, ops):
    """The least time (ms) for ``nbytes`` of traffic and ``ops`` bit
    operations (the pack's) at the non-tensor rate, as fields of one
    launch: the bound and the two times it is the larger of."""
    t_b, t_o = nbytes / HBM_BYTES_S * 1e3, ops / NONTENSOR_OPS_S * 1e3
    return dict(bound_ms=max(t_b, t_o), bytes_ms=t_b, ops_ms=t_o)


def _live_steps(idx_sorted, n_arr1):
    """Steps of a cluster schedule up to each (tile, cluster) run's last
    step that selects a real row (not the zero row ``n_arr1 - 1``), summed
    over the runs: the steps whose codes a launch needs."""
    import torch

    ms, dp = idx_sorted.shape[-2:]
    real = (idx_sorted.reshape(-1, ms, dp) != n_arr1 - 1).any(-1)
    steps = torch.arange(1, ms + 1, device=real.device)
    return int(torch.where(real, steps, 0).amax(-1).sum())


def phase_lookup_small():
    """Kernels 3-6 against their plain versions (and the dense integer
    GEMM) on small compiled plans, at the reference's test shapes."""
    import numpy as np
    import torch

    from repro_torch.core.tlmac.compile import compile_layer
    from repro_torch.kernels import bitplanes as bp
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import tlmac_clustered as tc
    from repro_torch.kernels import tlmac_fused as tf
    from repro_torch.kernels import tlmac_gemm as tg

    rng = np.random.default_rng(5)

    def setup(K, N, M, B_w, B_a, G, d_p):
        w = rng.integers(-(2 ** (B_w - 1)), 2 ** (B_w - 1), size=(K, N))
        plan = compile_layer(w, B_w=B_w, B_a=B_a, G=G, d_p=d_p,
                             anneal_iters=100, seed=0)
        a = torch.from_numpy(rng.integers(0, 2**B_a, (M, K)).astype(np.int8))
        dense = ops.dense_int_matmul(a, torch.from_numpy(w))
        return plan, a.to(DEV), dense.to(DEV)

    for K, N, M, B_w, B_a, G in SWEEP:
        plan, a, dense = setup(K, N, M, B_w, B_a, G, 64)
        codes = bp.pack_bitplanes(a, B_a=B_a, G=G)
        _equal(f"pack_bitplanes K={K} G={G}", codes,
               bp.pack_bitplanes_plain(a, B_a=B_a, G=G))
        # the kernel reads the plan's table as narrow rows, made once
        table = tf.narrow_table(torch.from_numpy(plan.table)).to(DEV)
        rb = kref.rowbase_from_plan(
            table, torch.from_numpy(plan.exec_idx).to(DEV),
            torch.from_numpy(plan.step_cluster).to(DEV), N // 64, K // G)
        t2d = table.reshape(-1, 2**G)
        got = tg.tlmac_gemm(codes, rb, t2d, B_a=B_a, G=G, N=N)
        _equal(f"tlmac_gemm K={K} N={N} M={M} G={G}", got,
               tg.tlmac_gemm_plain(codes, rb, t2d, B_a=B_a, G=G, N=N))
        _equal(f"tlmac_gemm K={K} G={G} vs dense", got, dense)
    log(f"  kernels 3-4 on the reference's sweep ({len(SWEEP)} compiled "
        "plans, G 2/3/4/6): equal int32 to plain and to the dense GEMM")
    for K, N, M, B_w, B_a, G in CLUSTERED:
        plan, a, dense = setup(K, N, M, B_w, B_a, G, N)
        for bk in (8, 2):
            s = tc.device_schedule(plan, 1, bk, DEV, tiled=False)
            codes = bp.pack_bitplanes(a, B_a=B_a, G=G).index_select(2, s["cols"])
            got = tc.tlmac_gemm_clustered(codes, s["idx_sorted"],
                                          s["table_pad"], B_a=B_a, G=G)
            _equal(f"clustered K={K} N={N} bk={bk}", got,
                   tc.tlmac_gemm_clustered_plain(
                       codes, s["idx_sorted"], s["table_pad"], B_a=B_a, G=G))
            _equal(f"clustered K={K} N={N} vs dense", got, dense)
    for K, N, M, B_w, B_a, G, d_p in CLUSTERED_MULTI:
        plan, a, dense = setup(K, N, M, B_w, B_a, G, d_p)
        s = tc.device_schedule(plan, N // d_p, 8, DEV, tiled=True)
        codes = bp.pack_bitplanes(a, B_a=B_a, G=G).index_select(2, s["cols"])
        got = tc.tlmac_gemm_clustered_multi(codes, s["idx_sorted"],
                                            s["table_pad"], B_a=B_a, G=G)
        _equal(f"clustered multi K={K} N={N}", got,
               tc.tlmac_gemm_clustered_multi_plain(
                   codes, s["idx_sorted"], s["table_pad"], B_a=B_a, G=G))
        _equal(f"clustered multi K={K} N={N} vs dense", got, dense)
    log(f"  kernels 5-6 on the reference's clustered shapes "
        f"({len(CLUSTERED)} + {len(CLUSTERED_MULTI)} plans): equal int32 "
        "to plain and to the dense GEMM")


def resnet_convs(cfg, plans):
    """(name, plan, input shape [B, H, W, C_in], stride, stage) of every
    basic-block conv at input resolution ``RESNET_HW``."""
    from repro_torch.models.resnet import block_strides

    out, it = [], iter(plans)
    hw, cin = RESNET_HW, cfg.width
    strides = block_strides(cfg)
    bi = 0
    for si, (ch, n, _) in enumerate(cfg.stages):
        for _ in range(n):
            s = strides[bi]
            for ci, (c_in, st) in enumerate(((cin, s), (ch, 1))):
                name, plan = next(it)
                out.append((name, plan, (RESNET_BATCH, hw, hw, c_in), st,
                            si + 1))
                if ci == 0:
                    hw = -(-hw // s)
            cin = ch
            bi += 1
    return out


def compile_full_resnet(cfg):
    """ResNet ``cfg`` (full-width ResNet-18 in the run) drawn on the card
    and its basic-block convs compiled on the host; prints the Fig. 8
    report."""
    import torch

    from repro_torch.core.tlmac.compile import verify_plan
    from repro_torch.models import resnet as R

    params = R.init_resnet(cfg, torch.Generator(device=DEV).manual_seed(
        SEED), device=DEV)
    # time each conv's compile_layer inside the compile_resnet call
    secs, compile_layer = [], R.tlc.compile_layer

    def timed(*a, **kw):
        t = time.perf_counter()
        plan = compile_layer(*a, **kw)
        secs.append(time.perf_counter() - t)
        return plan

    R.tlc.compile_layer = timed
    t0 = time.perf_counter()
    try:
        plans = R.compile_resnet(params, cfg)
    finally:
        R.tlc.compile_layer = compile_layer
    total = time.perf_counter() - t0
    log(f"  compile_resnet: {len(plans)} convs in {total:.1f} s on the host (default "
        "anneal_iters=2000); verify_plan holds on each")
    log("  Fig. 8 report (FPGA cost model, not a card measurement):")
    log(f"    {'conv':14s} {'shape':>16s} {'N_uwg':>6s} {'N_clus':>6s} "
        f"{'N_arr':>6s} {'D_s':>5s} {'D_p':>4s} {'LUTs':>8s} "
        f"{'routes before->after':>22s} {'compile s':>9s}")
    for (name, plan), sec in zip(plans, secs):
        if not verify_plan(plan):
            raise AssertionError(f"verify_plan fails on {name}")
        log(f"    {name:14s} {str(tuple(plan.orig_shape)):>16s} "
            f"{plan.N_uwg:6d} {plan.N_clus:6d} {plan.N_arr:6d} {plan.D_s:5d} "
            f"{plan.D_p:4d} {plan.resources.luts:8d} "
            f"{plan.routes_before:10d} -> {plan.routes_after:8d} {sec:9.2f}")
    return params, plans


def _conv_inputs(shape, seed, B_a):
    import torch

    gen = torch.Generator(device=DEV).manual_seed(seed)
    return torch.randint(0, 2**B_a, shape, dtype=torch.int8, generator=gen,
                         device=DEV)


def _dense_weights(w_codes, n_rows):
    """The conv's integer weights as ``[C*3, O*len(rows)]`` int8 for
    ``torch._int_mm`` against the windows: row ``c*3 + j``, column ``o*R +
    ri`` holds ``w[o, c, rows[ri], j]`` (the column order of a conv plan's
    outputs, ``oc*3 + r``, when all three rows are taken)."""
    import torch

    O, C = w_codes.shape[:2]
    w = torch.as_tensor(w_codes, dtype=torch.int8, device=DEV)
    rows = w[:, :, list(n_rows), :]                   # [O, C, R, 3]
    return rows.permute(1, 3, 0, 2).reshape(C * 3, O * len(n_rows)).contiguous()


def phase_resnet_kernels(cfg, params, plans):
    """Kernels 1 and 3-6 at the 16 full-width conv shapes: each against
    its plain version (int32-equal), kernels 5/6 against kernel 3's row
    GEMMs; kernel, plain, bound and library times summed per stage."""
    import torch

    from repro_torch.kernels import bitplanes as bp
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import tlmac_clustered as tc
    from repro_torch.kernels import tlmac_fused as tf
    from repro_torch.kernels import tlmac_gemm as tg
    from repro_torch.models import resnet as R

    B_a = cfg.a_bits
    keys = ("pack_bitplanes", "tlmac_gemm", "tlmac_gemm_clustered",
            "tlmac_gemm_clustered_multi", "tlmac_gemm_fused", "conv")
    acc = {k: {} for k in keys}

    def add(kind, stage, **vals):
        for f, v in vals.items():
            if v is None:
                continue
            d = acc[kind].setdefault(stage, {})
            d[f] = d.get(f, 0.0) + v

    for ci, (name, plan, shape, stride, stage) in enumerate(
            resnet_convs(cfg, plans)):
        a = _conv_inputs(shape, 100 + ci, B_a)
        win = R.conv_windows(a)
        M, K = win.shape
        C = shape[3]
        n_ot = plan.D_s // C
        dpc = plan.D_p // 3           # output channels per tile
        N = n_ot * dpc
        w_codes = R.quantize_conv_weights(params["blocks"][ci // 2][
            "conv1" if ci % 2 == 0 else "conv2"], cfg)
        # kernel 4
        codes = bp.pack_bitplanes(win, B_a=B_a, G=3)
        _equal(f"{name} pack", codes,
               bp.pack_bitplanes_plain(win, B_a=B_a, G=3))
        pack = lambda: bp.pack_bitplanes(win, B_a=B_a, G=3)
        add("pack_bitplanes", stage, ms=graph_ms(pack, iters=5, replays=3),
            eager_ms=cuda_ms(pack, 10),
            plain_ms=cuda_ms(lambda: bp.pack_bitplanes_plain(
                win, B_a=B_a, G=3), 2, 1), n=1,
            **_bound(M * K + codes.numel(), M * K * B_a))
        # kernel 3 (three row GEMMs) and kernel 1 on the same row plans;
        # both read the plan's table (one for all rows) as the narrow rows
        # conv_row_plan made once
        rows = []
        tn = R.conv_row_plan(plan, 0, DEV)[0]
        for r in range(3):
            table, ex, cl = R.conv_row_plan(plan, r, DEV)
            rb = kref.rowbase_from_plan(table, ex, cl, n_ot, C)
            t2d = table.reshape(-1, 8)
            got = tg.tlmac_gemm(codes, rb, t2d, B_a=B_a, G=3, N=N)
            _equal(f"{name} row {r} tlmac_gemm", got, tg.tlmac_gemm_plain(
                codes, rb, t2d, B_a=B_a, G=3, N=N))
            rows.append(got)
            wr = _dense_weights(w_codes, (r,))
            lib = torch._int_mm(win, wr)
            _equal(f"{name} row {r} _int_mm", lib, got)
            lib_ms = cuda_ms(lambda: torch._int_mm(win, wr), 10)
            gemm = lambda: tg.tlmac_gemm(codes, rb, t2d, B_a=B_a, G=3, N=N)
            add("tlmac_gemm", stage, ms=graph_ms(gemm, iters=5, replays=3),
                eager_ms=cuda_ms(gemm, 10),
                plain_ms=cuda_ms(lambda: tg.tlmac_gemm_plain(
                    codes, rb, t2d, B_a=B_a, G=3, N=N), 2, 1),
                library_ms=graph_ms(lambda: torch._int_mm(win, wr), iters=5,
                                    replays=3),
                library_eager_ms=lib_ms, n=1,
                **_gemm_bound(M, C, N, 3, codes.numel() + rb.numel() * 4
                              + t2d.numel() * t2d.element_size()
                              + M * N * 4))
            idx_t = (torch.uint8 if plan.N_arr <= 256 else torch.int16)
            ex3 = ex.reshape(n_ot, C, dpc).to(idx_t)
            cl2 = cl.reshape(n_ot, C).to(torch.int8)
            fz = tf.tlmac_gemm_fused(win, ex3, cl2, tn, B_a=B_a, G=3)
            _equal(f"{name} row {r} tlmac_gemm_fused", fz, got)
            bound = _gemm_bound(M, C, N, 3, M * K
                                + ex3.numel() * ex3.element_size()
                                + cl2.numel() + tn.numel()
                                * tn.element_size() + M * N * 4)["bound_ms"]
            add("tlmac_gemm_fused", stage,
                ms=cuda_ms(lambda: tf.tlmac_gemm_fused(win, ex3, cl2, tn,
                                                       B_a=B_a, G=3), 10),
                plain_ms=cuda_ms(lambda: tf.tlmac_gemm_fused_plain(
                    win, ex3, cl2, tn, B_a=B_a, G=3), 2, 1),
                library_ms=lib_ms, n=1, bound_ms=bound)
        # kernels 6 and (single-tile convs) 5 on the same windows
        w3 = _dense_weights(w_codes, (0, 1, 2))
        for kind, tiled in (("tlmac_gemm_clustered_multi", True),
                            ("tlmac_gemm_clustered", False)):
            if not tiled and n_ot != 1:
                continue
            s = tc.device_schedule(plan, n_ot, 8, DEV, tiled=tiled)
            cs = codes.index_select(2, s["cols"])
            idx = s["idx_sorted"]
            fn, plain = ((tc.tlmac_gemm_clustered_multi,
                          tc.tlmac_gemm_clustered_multi_plain) if tiled else
                         (tc.tlmac_gemm_clustered,
                          tc.tlmac_gemm_clustered_plain))
            got = fn(cs, idx, s["table_pad"], B_a=B_a, G=3)
            _equal(f"{name} {kind}", got, plain(cs, idx, s["table_pad"],
                                                B_a=B_a, G=3))
            per_row = got.reshape(M, n_ot, dpc, 3)
            for r in range(3):
                _equal(f"{name} {kind} row {r} vs tlmac_gemm",
                       per_row[..., r].reshape(M, N), rows[r])
            lib = torch._int_mm(win, w3)
            _equal(f"{name} _int_mm of the plan's weights", lib, got)
            tab = s["table_pad"]
            run = lambda: fn(cs, idx, tab, B_a=B_a, G=3)
            # the codes of the live steps only (the padding after a run's
            # last real step is never read); the one-hot product the same
            live = _live_steps(idx, tab.shape[1])
            add(kind, stage, ms=graph_ms(run, iters=5, replays=3),
                eager_ms=cuda_ms(run, 10),
                plain_ms=cuda_ms(lambda: plain(cs, idx, tab, B_a=B_a, G=3),
                                 2, 1),
                library_ms=graph_ms(lambda: torch._int_mm(win, w3), iters=5,
                                    replays=3),
                library_eager_ms=cuda_ms(lambda: torch._int_mm(win, w3), 10),
                n=1,
                **_gemm_bound(M, live, plan.D_p, 3, B_a * M * live
                              + idx.numel() * 4
                              + tab.numel() * tab.element_size()
                              + M * N * 3 * 4))
        # the whole conv: integer codes through conv2d in f32 (TF32 off)
        (ht, hb), (wl, wr_) = (R.same_pads(shape[1], 3, stride),
                               R.same_pads(shape[2], 3, stride))
        xf = torch.nn.functional.pad(a.permute(0, 3, 1, 2).float(),
                                     (wl, wr_, ht, hb))
        wf = torch.as_tensor(w_codes, dtype=torch.float32, device=DEV)
        add("conv", stage, library_ms=cuda_ms(
            lambda: torch.nn.functional.conv2d(xf, wf, stride=stride), 10), n=1)
        del rows, codes, win
    torch.cuda.empty_cache()

    def total(kind):
        t = {}
        for d in acc[kind].values():
            for f, v in d.items():
                t[f] = t.get(f, 0.0) + v
        return t

    def line(kind, what, d):
        lib = d.get("library_ms")
        eager = (f" (eager calls {d['eager_ms']:.4f} ms)" if "eager_ms" in d
                 else "")
        lib_eager = (f" (eager {d['library_eager_ms']:.4f} ms)"
                     if "library_eager_ms" in d else "")
        bound = (f", bound {d['bound_ms']:.4f} ms (bytes {d['bytes_ms']:.4f}"
                 f", ops {d['ops_ms']:.4f})" if "bytes_ms" in d else
                 f", bound {d['bound_ms']:.4f} ms")
        log(f"  {kind:27s} {what} ({int(d['n'])} launches): kernel "
            f"{d['ms']:.4f} ms{eager}, plain {d['plain_ms']:.3f} ms{bound}, "
            "library " + (f"{lib:.4f} ms{lib_eager}" if lib is not None
                          else "none"))

    for kind in keys[:-1]:
        for stage, d in sorted(acc[kind].items()):
            line(kind, f"stage {stage}", d)
        line(kind, "all stages", total(kind))
    for stage, d in sorted(acc["conv"].items()):
        look = sum(acc[k][stage]["ms"] for k in ("pack_bitplanes", "tlmac_gemm"))
        log(f"  stage {stage} lookup convs (pack + 3 row GEMMs) {look:.4f} ms "
            f"vs integer conv2d (f32, TF32 off) {d['library_ms']:.4f} ms")
    meta = {
        "pack_bitplanes": ("csrc/bitplanes.cu", "src/repro/kernels/bitplanes.py:41",
                           "16 packs of the 1x3 windows, M = 32*56^2..32*7^2 "
                           "(device time by CUDA-graph replay)"),
        "tlmac_gemm": ("csrc/tlmac_gemm.cu", "src/repro/kernels/tlmac_gemm.py:136",
                       "48 kernel-row lookup GEMMs of the 16 convs, narrow "
                       "tables (device time by CUDA-graph replay)"),
        "tlmac_gemm_clustered": (
            "csrc/tlmac_clustered.cu", "src/repro/kernels/tlmac_clustered.py:128",
            "the 4 single-tile stage-1 convs, all three kernel rows "
            "(device time by CUDA-graph replay)"),
        "tlmac_gemm_clustered_multi": (
            "csrc/tlmac_clustered.cu", "src/repro/kernels/tlmac_clustered.py:290",
            "all 16 convs, all three kernel rows, one launch each (device "
            "time by CUDA-graph replay)"),
    }
    entries = {}
    for kind, (src, rep, shape) in meta.items():
        t = total(kind)
        entries[kind] = dict(
            name=kind, route="cuda", source="src/repro_torch/" + src,
            replaces=rep, shape=f"ResNet-18 batch {RESNET_BATCH} at "
            f"{RESNET_HW}x{RESNET_HW}: {shape}", max_abs_err=0, ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=_bound_by(t),
            library_ms=t.get("library_ms"))
    fz = total("tlmac_gemm_fused")
    log(f"  tlmac_gemm_fused on the 48 compiled row plans: kernel "
        f"{fz['ms']:.4f} ms, plain {fz['plain_ms']:.3f} ms, bound "
        f"{fz['bound_ms']:.4f} ms, torch._int_mm {fz['library_ms']:.4f} ms")
    return entries


def phase_paper_path(cfg, params, plans):
    """The paper's compile-and-execute flow at full width: forward on 32
    images, then every conv as a lookup conv (kernels 4 + 3) and as one
    cluster-scheduled launch (kernels 4 + 6; kernel 5 too on the
    single-tile convs), with every launch counter read around the run."""
    import numpy as np
    import torch

    from repro_torch.core.quant import quantizers as Q
    from repro_torch.core.tlmac.api import TLMACLinear
    from repro_torch.kernels import bitplanes as bp
    from repro_torch.kernels import ops
    from repro_torch.kernels import tlmac_clustered as tc
    from repro_torch.kernels import tlmac_gemm as tg
    from repro_torch.models import resnet as R

    B_a = cfg.a_bits
    convs = resnet_convs(cfg, plans)
    inputs = [_conv_inputs(shape, 100 + ci, B_a)
              for ci, (_, _, shape, _, _) in enumerate(convs)]
    x = torch.randn((RESNET_BATCH, RESNET_HW, RESNET_HW, 3),
                    generator=torch.Generator(device=DEV).manual_seed(7),
                    device=DEV)
    torch.cuda.synchronize()
    bp.launches = tg.launches = tc.launches = tc.launches_multi = 0
    t0 = time.perf_counter()
    logits = R.forward(params, x, cfg)
    outs = []
    for (name, plan, shape, stride, _), a in zip(convs, inputs):
        n_ot = plan.D_s // shape[3]
        out = R.tlmac_conv_forward(plan, a, cfg.quant, stride)
        win = R.conv_windows(a)
        multi = tc.run_clustered_multi(plan, win, B_a, N=n_ot * plan.D_p)
        single = tc.run_clustered(plan, win, B_a) if n_ot == 1 else None
        outs.append((out, multi, single))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"pack_bitplanes": bp.launches, "tlmac_gemm": tg.launches,
              "tlmac_gemm_clustered": tc.launches,
              "tlmac_gemm_clustered_multi": tc.launches_multi}
    n_single = sum(1 for _, p, s, _, _ in convs if p.D_s // s[3] == 1)
    want = {"pack_bitplanes": 2 * len(convs) + n_single,
            "tlmac_gemm": 3 * len(convs), "tlmac_gemm_clustered": n_single,
            "tlmac_gemm_clustered_multi": len(convs)}
    if counts != want:
        raise AssertionError(f"launches {counts}, want {want}")
    if logits.shape != (RESNET_BATCH, cfg.num_classes) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"logits {tuple(logits.shape)} not finite")
    n = len(convs)
    log(f"  forward: logits {tuple(logits.shape)} finite; the path (forward "
        f"+ {n} lookup convs + {n} clustered + {n_single} single-tile) ran in "
        f"{wall:.2f} s (host clock, first calls)")
    log(f"  launches: pack_bitplanes {counts['pack_bitplanes']} (= {n} lookup "
        f"convs + {n} clustered + {n_single} single-tile), tlmac_gemm "
        f"{counts['tlmac_gemm']} (= 3 rows x {n}), tlmac_gemm_clustered "
        f"{counts['tlmac_gemm_clustered']}, tlmac_gemm_clustered_multi "
        f"{counts['tlmac_gemm_clustered_multi']}")
    for ci, ((name, plan, shape, stride, _), a, (out, multi, single)) in \
            enumerate(zip(convs, inputs, outs)):
        blk = params["blocks"][ci // 2]["conv1" if ci % 2 == 0 else "conv2"]
        w = torch.as_tensor(R.quantize_conv_weights(blk, cfg), device=DEV)
        ref = int_conv(a, w, stride)
        _equal(f"{name} lookup conv vs integer conv", out, ref)
        n_ot = plan.D_s // shape[3]
        B, H, W, _ = shape
        dpc = plan.D_p // 3
        rows = multi.reshape(B, H, W, n_ot, dpc, 3)
        _equal(f"{name} clustered conv vs integer conv", R.combine_row_sums(
            [rows[..., r].reshape(B, H, W, n_ot * dpc) for r in range(3)],
            stride), ref)
        if single is not None:
            _equal(f"{name} single-tile clustered", single, multi)
        log(f"  {name:14s} {str(shape):20s} stride {stride}: lookup conv "
            f"{tuple(out.shape)} == integer conv; clustered == integer conv")
    # the quickstart's layer through TLMACLinear, outside the counted run
    rng = np.random.default_rng(0)
    K, N, M = 128, 256, 32
    wq = rng.normal(size=(K, N)) * 0.05
    lin = TLMACLinear.from_weights(wq, w_bits=3, a_bits=3, G=4, d_p=64,
                                   anneal_iters=5000, device=DEV)
    xs = torch.as_tensor(np.abs(rng.normal(size=(M, K))), dtype=torch.float32,
                         device=DEV)
    lin.calibrate(xs)
    aq = torch.clamp(torch.round(xs / lin.a_step), 0, 7).to(torch.int8)
    w_codes = Q.quantize_weights_int(
        torch.as_tensor(wq, dtype=torch.float32, device=DEV),
        Q.QuantConfig(w_bits=3, a_bits=3, per_channel=False),
        step=lin.w_step)[0]
    yi = ops.tlmac_matmul(aq, *lin._plan_arrays(DEV), B_a=3, G=4, N=N,
                          impl="pallas")
    _equal("TLMACLinear lookup GEMM vs dense", yi,
           ops.dense_int_matmul(aq, w_codes))
    y = lin(xs)
    if y.shape != (M, N) or not bool(torch.isfinite(y.float()).all()):
        raise AssertionError("TLMACLinear output not finite")
    log(f"  TLMACLinear K={K} N={N} M={M}: lookup GEMM == dense_int_matmul; "
        f"plan N_uwg {lin.plan.N_uwg}, N_arr {lin.plan.N_arr}")
    return counts


def int_conv(a, w, stride):
    """The integer 3x3 conv of codes ``a [B, H, W, C]`` with weights ``w
    [O, C, 3, 3]`` (SAME padding as XLA): im2col + the port's exact
    dense integer GEMM."""
    from repro_torch.kernels.ops import dense_int_matmul
    from repro_torch.models.resnet import same_pads

    import torch.nn.functional as F

    B, H, W, C = a.shape
    (ht, hb), (wl, wr) = same_pads(H, 3, stride), same_pads(W, 3, stride)
    x = F.pad(a.permute(0, 3, 1, 2).double(), (wl, wr, ht, hb))
    cols = F.unfold(x, 3, stride=stride)                 # [B, C*9, L]
    Ho, Wo = (H + ht + hb - 3) // stride + 1, (W + wl + wr - 3) // stride + 1
    y = dense_int_matmul(cols.transpose(1, 2).reshape(-1, C * 9),
                         w.reshape(w.shape[0], -1).T)
    return y.reshape(B, Ho, Wo, w.shape[0])


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
    gemm = sum(v for k, v in by_name.items() if "tlmac_fused_" in k)
    flash = sum(v for k, v in by_name.items() if "flash_decode_kernel" in k)
    others = sorted(((v, k) for k, v in by_name.items()
                     if "tlmac_fused_" not in k
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
    logs = _build.build(SOURCES)
    log(f"build: {' + '.join(n + '.cu' for n in SOURCES)} with nvcc -arch "
        f"sm_90a in {time.perf_counter() - t0:.1f} s (parallel)")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    phase("lookup GEMM vs plain (int32, must be equal)")
    gemm = phase_gemm(chunk=CHUNK, batch=4)
    phase_gemm_edges()
    phase("flash-decode vs plain")
    flash = phase_flash()
    phase("kernels 3-6 vs plain on small compiled plans")
    phase_lookup_small()
    phase("full-width ResNet-18, 16 convs compiled on the host")
    from repro_torch.configs.resnet18 import CONFIG as rcfg

    rparams, plans = compile_full_resnet(rcfg)
    phase("kernels 1 and 3-6 at the ResNet-18 conv shapes")
    lookup = phase_resnet_kernels(rcfg, rparams, plans)
    # launches are counted on the main paths only: null when they did not run
    counts = dict.fromkeys(["tlmac_gemm_fused", "flash_decode", *lookup])
    if args.only == "all":
        phase("main path (serve)")
        counts.update(phase_main())
        phase("card vs CPU on smoke configs")
        phase_reference()
        phase("paper path (ResNet-18 compile-and-execute)")
        counts.update(phase_paper_path(rcfg, rparams, plans))
    kernels = [gemm, flash, *lookup.values()]
    for k in kernels:
        k["launches"] = counts[k["name"]]
    log(json.dumps({"kernels": kernels}))
    if args.only != "all":
        return 0
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
