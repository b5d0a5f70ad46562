"""Serving launcher of the port: batched greedy decode through the dense
``ServeLoop`` on the TLMAC serve path (the counterpart of
``repro.launch.serve``, with its flags and ``--device``).

    python -m repro_torch.launch.serve --arch xlstm-350m
    python -m repro_torch.launch.serve --arch xlstm-350m --smoke \\
        --device cpu --requests 8 --max-new 16

The model's serve params are drawn from a seeded ``torch.Generator`` on
the device (random weights: this serves the architecture, not a
checkpoint).  An encoder-decoder config is refused by ``ServeLoop``, as
the reference's loop cannot serve it either (no frames reach its
prefill); serve one through ``lm.prefill(tokens, frames=...)`` and
``lm.decode_step``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.models import lm
from repro_torch.serve.loop import Request, ServeLoop


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--s-max", type=int, default=128)
    ap.add_argument("--serve-impl", default=None,
                    choices=[None, "dense", "int8", "tlmac"])
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (default: cuda)")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.serve_impl:
        cfg = dataclasses.replace(cfg, serve_impl=args.serve_impl)

    gen = torch.Generator(device=args.device).manual_seed(0)
    params = lm.init_lm(cfg, gen, purpose="serve", device=args.device)
    loop = ServeLoop(params, cfg, batch_slots=args.slots, s_max=args.s_max,
                     device=args.device)

    rng = np.random.default_rng(0)
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, size=rng.integers(4, 17)).astype(
            np.int32)
        loop.submit(Request(rid=i, prompt=prompt, max_new_tokens=args.max_new))

    t0 = time.perf_counter()
    done = loop.run()
    if torch.device(args.device).type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total_new = sum(len(r.output) for r in done)
    print(f"served {len(done)} requests, {total_new} tokens, "
          f"{dt:.2f}s ({total_new / max(dt, 1e-9):.1f} tok/s, "
          f"impl={cfg.serve_impl}, device={args.device})")
    for r in done[:4]:
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.output[:8]}...")
    return done


if __name__ == "__main__":
    main()
