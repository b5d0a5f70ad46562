#!/usr/bin/env python3
"""Where the lookup GEMM on packed codes (kernel 3,
``src/repro_torch/csrc/tlmac_gemm.cu``) spends its time, by cutting one
phase out at a time.

Builds the kernel's own source unchanged and once per cut, each with one
phase of the chunk loop removed (the results are then wrong on purpose):
the tensor-core products, the coef build, the code-plane staging, the
streamed table rows.  Times every build by CUDA-graph replay at ResNet-18's four
stage row-GEMM shapes (batch 32 at 56x56, G = 3, B_a = 3, int8 rows of a
seeded random 4096-row table) and prints microseconds per row GEMM
beside the card's name and power limit.  A phase whose cut saves little
is hidden behind the others.

    python3 tools/lookup_gemm_cuts.py     # needs one CUDA card and nvcc
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

SOURCE = os.path.join(ROOT, "src", "repro_torch", "csrc", "tlmac_gemm.cu")
CUTS = {
    "none": [],
    "products": [("      wgmma_u8s8(acc, a[kk], desc);\n",
                  "      acc[kk] += a[kk][0] ^ (uint32_t)desc;\n")],
    "coef build": [("    build_a<G, NK, 0, NK / 2>(a, sc + row0 * KC, BM * KC, B_a, tig, kc_n);\n",
                    "    for (int q = 0; q < NK * 4; ++q) a[q / 4][q % 4] = q + kc_n;\n"),
                   ("    build_a<G, NK, NK / 2, NK>(a, sc + row0 * KC, BM * KC, B_a, tig, kc_n);\n",
                    "")],
    "code staging": [("    stage_codes<PS, KC>(s_c + (it % stages) * c_buf, codes, M, KG, B_a, m0, k0, "
                      "kc_n, tid);\n", "")],
    "streamed rows": [("      gather_chunk<G, T>(s_b + (it % stages) * TB * BCH, table, rb_cols, "
                       "dp, np, k0, kc_n, tid);\n", "      ;\n")],
}
# (M, KG, n_tiles, dp) of one kernel row of each stage's convs
STAGES = [(100352, 64, 1, 64), (25088, 128, 2, 64), (6272, 256, 4, 64),
          (1568, 512, 8, 64)]
G, B_A, ROWS = 3, 3, 4096


def start_build(tmp: str, name: str, patches):
    """Write the source with the cut applied and start its nvcc."""
    from repro_torch.kernels import _build

    src = open(SOURCE).read()
    for old, new in patches:
        if old not in src:
            raise RuntimeError(f"cut {name!r}: the kernel source changed")
        src = src.replace(old, new)
    path = os.path.join(tmp, "k_" + name.replace(" ", "_") + ".cu")
    with open(path, "w") as f:
        f.write(src)
    lib = path[:-3] + ".so"
    proc = subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, "-I",
                             os.path.dirname(SOURCE), "-o", lib, path],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, lib


def load(proc, lib):
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{log}")
    fn = ctypes.CDLL(lib).tlmac_gemm_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def graph_us(call, iters: int = 10, replays: int = 5) -> float:
    import torch

    if call() != 0:
        raise RuntimeError("launch failed")
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            call()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays) * 1e3


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("lookup_gemm_cuts: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    table = torch.randint(-20, 20, (ROWS, 2**G), generator=gen,
                          device="cuda").to(torch.int8)
    cases = []
    for M, KG, nt, dp in STAGES:
        rb = torch.randint(0, ROWS, (nt, KG, dp), generator=gen,
                           device="cuda").int()
        codes = torch.randint(0, 2**G, (B_A, M, KG), generator=gen,
                              device="cuda").to(torch.int8)
        out = torch.empty((M, nt * dp), dtype=torch.int32, device="cuda")
        cases.append((codes, rb, out, M, KG, nt, dp))
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        jobs = {name: start_build(tmp, name, p) for name, p in CUTS.items()}
        fns = {name: load(*job) for name, job in jobs.items()}
    print("us per row GEMM (CUDA-graph replay), stages 1-4, by the phase cut out:")
    for name, fn in fns.items():
        us = []
        for codes, rb, out, M, KG, nt, dp in cases:
            us.append(graph_us(lambda: fn(
                codes.data_ptr(), rb.data_ptr(), table.data_ptr(), 1,
                out.data_ptr(), M, KG, nt, dp, G, B_A,
                torch.cuda.current_stream().cuda_stream)))
        print(f"  {name:14s} " + "  ".join(f"{u:7.1f}" for u in us))
    return 0


if __name__ == "__main__":
    sys.exit(main())
