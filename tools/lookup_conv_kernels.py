#!/usr/bin/env python3
"""Device times of the lookup conv's two kernels, for comparing two trees
of the port in one call on one card.

Times kernel 4 (``pack_bitplanes``, the bit-plane pack of the 1x3
windows) and kernel 3 (``tlmac_gemm``, the three kernel-row lookup GEMMs
on the packed codes) at full-width ResNet-18's 16 basic-block convs
(batch 32 at 56x56, the plans and inputs of ``chip_smoke.py``: the same
seeded weights, compiled plans and seeded activation codes), by
CUDA-graph replay with the eager time beside, for the port whose
``src/`` directory is given.  Each tree passes its own
``conv_row_plan`` table to its own kernel (narrow or int32, as that
tree's kernel reads it), and every result is held equal to that tree's
plain version.  Prints the sums per stage and over the 16 convs beside
the card's name and power limit.

    python3 tools/lookup_conv_kernels.py                 # this tree
    python3 tools/lookup_conv_kernels.py --src DIR/src   # another tree
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, HW = 32, 56


def graph_ms(fn, iters: int = 5, replays: int = 3) -> float:
    """Device ms per call: ``iters`` calls captured in one CUDA graph,
    replayed ``replays`` times."""
    import torch

    fn()
    side = torch.cuda.Stream()
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
    return start.elapsed_time(end) / (iters * replays)


def eager_ms(fn, iters: int = 10) -> float:
    """Mean ms per call of back-to-back eager calls (host included)."""
    import torch

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the src/ directory of the port tree to time")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch

    if not torch.cuda.is_available():
        print("lookup_conv_kernels: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs.resnet18 import CONFIG as cfg
    from repro_torch.kernels import bitplanes as bp
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import tlmac_gemm as tg
    from repro_torch.models import resnet as R

    print(f"port: {os.path.dirname(os.path.dirname(R.__file__))}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev, B_a = "cuda", cfg.a_bits
    params = R.init_resnet(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    plans = iter(R.compile_resnet(params, cfg))
    strides = R.block_strides(cfg)
    sums = {}                      # (kernel, stage) -> [graph ms, eager ms]
    hw, cin, bi, ci = HW, cfg.width, 0, 0
    for si, (ch, n, _) in enumerate(cfg.stages):
        for _ in range(n):
            for k, c_in in enumerate((cin, ch)):
                _, plan = next(plans)
                gen = torch.Generator(device=dev).manual_seed(100 + ci)
                a = torch.randint(0, 2**B_a, (BATCH, hw, hw, c_in),
                                  dtype=torch.int8, generator=gen, device=dev)
                win = R.conv_windows(a)
                codes = bp.pack_bitplanes(win, B_a=B_a, G=3)
                if not torch.equal(codes, bp.pack_bitplanes_plain(
                        win, B_a=B_a, G=3)):
                    raise AssertionError(f"conv {ci}: pack differs from plain")
                pack = lambda: bp.pack_bitplanes(win, B_a=B_a, G=3)
                t = sums.setdefault(("pack_bitplanes", si + 1), [0.0, 0.0])
                t[0] += graph_ms(pack)
                t[1] += eager_ms(pack)
                n_ot = plan.D_s // c_in
                N = n_ot * (plan.D_p // 3)
                for r in range(3):
                    table, ex, cl = R.conv_row_plan(plan, r, dev)
                    rb = kref.rowbase_from_plan(table, ex, cl, n_ot, c_in)
                    t2d = table.reshape(-1, 8)
                    got = tg.tlmac_gemm(codes, rb, t2d, B_a=B_a, G=3, N=N)
                    if not torch.equal(got, tg.tlmac_gemm_plain(
                            codes, rb, t2d, B_a=B_a, G=3, N=N)):
                        raise AssertionError(f"conv {ci} row {r}: differs")
                    gemm = lambda: tg.tlmac_gemm(codes, rb, t2d, B_a=B_a,
                                                 G=3, N=N)
                    t = sums.setdefault(("tlmac_gemm", si + 1), [0.0, 0.0])
                    t[0] += graph_ms(gemm)
                    t[1] += eager_ms(gemm)
                if k == 0:
                    hw = -(-hw // strides[bi])
                ci += 1
            cin = ch
            bi += 1
    torch.cuda.synchronize()
    for kernel in ("pack_bitplanes", "tlmac_gemm"):
        total = [0.0, 0.0]
        for (kname, stage), (g, e) in sorted(sums.items()):
            if kname != kernel:
                continue
            total[0] += g
            total[1] += e
            print(f"  {kernel:15s} stage {stage}: graph {g:.4f} ms, eager "
                  f"{e:.4f} ms")
        print(f"  {kernel:15s} all 16 convs: graph {total[0]:.4f} ms, eager "
              f"{total[1]:.4f} ms (equal to the plain version)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
