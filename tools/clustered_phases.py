#!/usr/bin/env python3
"""Where the cluster-scheduled lookup GEMM (kernels 5-6,
``src/repro_torch/csrc/tlmac_clustered.cu``) spends its cycles.

Builds the kernel's own source with ``-DTLMAC_CLUSTERED_PHASES``, which
compiles in the ``PHASE_MARK`` timers placed in its chunk loop (thread 0
of every block sums the ``clock64`` cycles of each phase), launches it at
two conv-like shapes with seeded random operands, and prints the mean
cycles per block and each phase's share, beside the card's name and power
limit.  The timers cost a few percent; the uninstrumented kernel is timed
by ``chip_smoke.py``.

    python3 tools/clustered_phases.py     # needs one CUDA card and nvcc
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

SOURCE = os.path.join(ROOT, "src", "repro_torch", "csrc", "tlmac_clustered.cu")
PHASES = ["previous product + wait + barrier", "prefetch issue", "coef build",
          "barrier", "last product", "epilogue"]
# conv-like shapes of ResNet-18 at batch 32 (G = 3, B_a = 3, D_p = 192):
# (M, n_tiles, n_clus, ms, live steps per run, dp, N_arr + 1)
SHAPES = {"stage 1 (56x56, 1 tile)": (100352, 1, 8, 16, 8, 192, 187),
          "stage 4 (7x7, 8 tiles)": (1568, 8, 8, 88, 64, 192, 391)}


def main() -> int:
    import torch

    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("clustered_phases: no CUDA device", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        lib_path = os.path.join(tmp, "libk.so")
        subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS,
                        "-DTLMAC_CLUSTERED_PHASES", "-o", lib_path, SOURCE],
                       check=True, capture_output=True, text=True)
        lib = ctypes.CDLL(lib_path)
    fn = lib.tlmac_clustered_multi_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.tlmac_clustered_max_slice_bytes.argtypes = [ctypes.c_int] * 2
    lib.tlmac_clustered_scratch_ints.argtypes = [ctypes.c_int] * 3
    lib.tlmac_clustered_read_phases.argtypes = [ctypes.c_void_p]
    lib.tlmac_clustered_max_slice_bytes(3, 3)   # raises the shared-memory limit
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for name, (M, nt, nc, ms, live, dp, n_arr1) in SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(0)
        idx = torch.randint(0, n_arr1 - 1, (nt, nc, ms, dp), generator=gen,
                            device="cuda").int()
        idx[:, :, live:] = n_arr1 - 1                 # the schedule's padding
        tab = torch.randint(-20, 20, (nc, n_arr1, 8), generator=gen,
                            device="cuda").to(torch.int8)
        codes = torch.randint(0, 8, (3, M, nt * nc * ms), generator=gen,
                              device="cuda").to(torch.int8)
        out = torch.empty((M, nt * dp), dtype=torch.int32, device="cuda")
        scratch = torch.empty(lib.tlmac_clustered_scratch_ints(nt, nc, dp),
                              dtype=torch.int32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        args = (codes.data_ptr(), idx.data_ptr(), tab.data_ptr(), 1,
                scratch.data_ptr(), out.data_ptr(), M, nt, nc, ms, dp, n_arr1, 3,
                3, stream)
        h = (ctypes.c_ulonglong * 8)()
        for _ in range(3):                             # warm up
            assert fn(*args) == 0
        lib.tlmac_clustered_read_phases(h)
        assert fn(*args) == 0
        lib.tlmac_clustered_read_phases(h)
        blocks, total = h[7], sum(h[:6])
        print(f"{name}: {blocks} blocks, {total / blocks:.0f} cycles per block: "
              + ", ".join(f"{p} {h[k] / blocks:.0f} ({h[k] / total:.0%})"
                          for k, p in enumerate(PHASES)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
