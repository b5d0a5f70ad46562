"""Training launcher of the port (the counterpart of
``repro.launch.train``, with its flags and ``--device``).

    python -m repro_torch.launch.train --arch minicpm-2b --steps 6 \\
        --seq-len 1024 --batch 4
    python -m repro_torch.launch.train --arch minicpm-2b --smoke \\
        --device cpu --steps 20 --ckpt-dir /tmp/ckpt --preempt-at 7

QAT of every architecture the reference lists (dense, VLM with its
``front`` embeddings, MoE with MLA or GQA, xLSTM, RG-LRU hybrid, enc-dec
with ``frames`` of ``seq_len // 2``) from params drawn from a seeded
``torch.Generator`` on the device, on the synthetic Zipf-ish stream of
``data.pipeline``.  minicpm-2b trains on its own WSD schedule.  ``--preempt-at`` with ``--ckpt-dir`` simulates preemptions;
the runner restarts from the latest checkpoint (``train/ft.py``).
"""

from __future__ import annotations

import argparse
import json

from repro_torch.configs import get_config, smoke_config
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.ft import FaultTolerantRunner, PreemptionSchedule
from repro_torch.train.trainer import TrainConfig, TrainLoop


def main(argv=None):
    """Returns ``(loop, params)``: the loop's ``metrics_log`` holds every
    step's loss, lr, gradient norm and host time."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="cosine", choices=["cosine", "wsd"])
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-interval", type=int, default=50)
    ap.add_argument("--preempt-at", type=int, nargs="*", default=[])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default: cuda)")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.name == "minicpm-2b" and args.schedule == "cosine":
        args.schedule = "wsd"  # the arch's own schedule

    data = SyntheticLMData(
        vocab=cfg.vocab, seq_len=args.seq_len, global_batch=args.batch,
        seed=args.seed,
        enc_len=args.seq_len // 2 if cfg.family == "audio" else 0,
        frontend=cfg.frontend, frontend_len=cfg.frontend_len,
    )
    tc = TrainConfig(
        lr=args.lr, total_steps=args.steps, schedule=args.schedule,
        accum_steps=args.accum, compress=args.compress_grads,
        adamw=AdamWConfig(state_dtype=cfg.opt_state_dtype),
    )
    loop = TrainLoop(cfg, tc, data, ckpt_dir=args.ckpt_dir,
                     ckpt_interval=args.ckpt_interval, device=args.device)

    if args.preempt_at and args.ckpt_dir:
        runner = FaultTolerantRunner(loop, args.ckpt_dir)
        hook = PreemptionSchedule(args.preempt_at)
        params, _ = runner.run(args.steps, seed=args.seed, step_hook=hook)
        print(f"finished with {runner.restarts} restarts")
    else:
        params, opt = loop.init(args.seed)
        params, _ = loop.run(params, opt, num_steps=args.steps)

    for m in loop.metrics_log[:: max(len(loop.metrics_log) // 20, 1)]:
        print(f"step {m['step']:5d} loss {m['loss']:.4f} "
              f"lr {m['lr']:.2e} |g| {m['gnorm']:.3f} "
              f"{m['wall_s'] * 1e3:.0f}ms")
    if loop.metrics_log:
        first, last = loop.metrics_log[0], loop.metrics_log[-1]
        print(f"loss: {first['loss']:.4f} -> {last['loss']:.4f} "
              f"(device={args.device})")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(loop.metrics_log, f)
    return loop, params


if __name__ == "__main__":
    main()
