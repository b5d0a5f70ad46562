"""LR schedules (port of ``repro.optim.schedules``).  WSD
(warmup-stable-decay) is MiniCPM's schedule (arXiv:2404.06395 §4):
linear warmup, a long plateau, a short exponential decay tail.

Each returns a 0-d f32 tensor on the CPU, computed from the step as an
int32 tensor in the reference's f32 operations (the trainer's step is a
traced int32 there)."""

from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.int32)


def _warm(s, warmup_steps) -> torch.Tensor:
    return torch.clamp((s + 1) / max(warmup_steps, 1), max=1.0)


def linear_warmup(step, base_lr, warmup_steps) -> torch.Tensor:
    return base_lr * _warm(_step(step), warmup_steps)


def cosine_schedule(step, base_lr, total_steps, warmup_steps=0,
                    min_ratio=0.1) -> torch.Tensor:
    s = _step(step)
    t = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1),
                    0, 1)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return base_lr * _warm(s, warmup_steps) * cos


def wsd_schedule(step, base_lr, total_steps, warmup_steps=0,
                 decay_frac=0.1, min_ratio=0.01) -> torch.Tensor:
    """Warmup-Stable-Decay: plateau at base_lr, decay in the last
    ``decay_frac`` of training (exponential to ``min_ratio``)."""
    s = _step(step)
    decay_start = total_steps * (1.0 - decay_frac)
    t = torch.clamp((s - decay_start) / max(total_steps - decay_start, 1),
                    0, 1)
    decay = torch.pow(torch.tensor(min_ratio, dtype=torch.float32), t)
    return base_lr * _warm(s, warmup_steps) * decay
