#!/usr/bin/env python3
"""The traced dry run's cells as one markdown table.

Reads the cell JSONs that ``python -m repro_torch.launch.dryrun --out DIR``
wrote and prints, per traced cell: the trace's host seconds, rank 0's
argument, temp and total (``total_nonalias_bytes``) bytes in GB and the
total's share of one card's 80 GB, the traced flops of all ranks (rank
0's times the mesh's devices) over the analytic count
(``launch/analytic.py``), and the step's collective bytes.  Cells skipped
by design or with ``--skip-hlo`` are counted, not listed; a cell not
traced is listed with its reason, a failed one with its error.

    python3 tools/dryrun_table.py experiments/dryrun
"""

from __future__ import annotations

import json
import os
import sys

CARD_BYTES = 80e9       # one H100's device memory (data sheet)


def rows(out_dir: str):
    skipped = 0
    for name in sorted(os.listdir(out_dir)):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(out_dir, name)) as f:
            res = json.load(f)
        cell = f"{res['arch']} {res['shape']} {res['mesh']}"
        if not res["ok"]:
            yield f"| {cell} | failed: {res['error']} |"
            continue
        if "skipped" in res or res["reasons"].get("trace_s", "").startswith(
                "skipped"):
            skipped += 1
            continue
        if res["trace_s"] is None:
            yield f"| {cell} | {res['reasons']['trace_s']} |"
            continue
        mem, n = res["memory_analysis"], res["analytic"]["n_chips"]
        ratio = res["cost_analysis"]["flops"] * n / res["analytic"]["flops"]
        yield (f"| {cell} | {res['trace_s']:.1f} | "
               f"{mem['argument_size_in_bytes'] / 1e9:.3f} | "
               f"{mem['temp_size_in_bytes'] / 1e9:.3f} | "
               f"{mem['total_nonalias_bytes'] / 1e9:.3f} | "
               f"{100 * mem['total_nonalias_bytes'] / CARD_BYTES:.1f}% | "
               f"{ratio:.3f} | "
               f"{res['hlo_collectives']['total_bytes'] / 1e9:.3f} |")
    yield f"({skipped} cells skipped by design or with --skip-hlo)"


def main(argv) -> int:
    print("| cell | trace s | args GB | temp GB | total GB | of 80 GB | "
          "flops traced / analytic | collectives GB |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- |")
    for line in rows(argv[1]):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
