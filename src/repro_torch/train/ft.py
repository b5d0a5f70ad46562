"""Fault tolerance (port of ``repro.train.ft``): preemption-safe training
and straggler detection.

- ``FaultTolerantRunner`` wraps ``TrainLoop``: a ``SimulatedPreemption``
  restores the latest checkpoint and resumes; the data pipeline is
  random access (batch = f(seed, step)), so the resumed run replays the
  exact stream.  On the CPU the resumed losses equal the uninterrupted
  run's bit for bit; on the card the embedding's backward accumulates
  with atomics, so they agree within the reference's 1e-5.
- ``StragglerMonitor`` flags shards whose step-time EMA exceeds k x the
  median.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.checkpoint import restore_checkpoint, save_checkpoint


class SimulatedPreemption(RuntimeError):
    pass


class PreemptionSchedule:
    """Raises SimulatedPreemption when training hits the given steps."""

    def __init__(self, at_steps: List[int]):
        self.at_steps = set(at_steps)
        self.fired = set()

    def __call__(self, step: int, *_):
        if step in self.at_steps and step not in self.fired:
            self.fired.add(step)
            raise SimulatedPreemption(f"preempted at step {step}")


class FaultTolerantRunner:
    """Restart-from-checkpoint driver around TrainLoop."""

    def __init__(self, loop, ckpt_dir: str, max_restarts: int = 10):
        self.loop = loop
        self.ckpt_dir = ckpt_dir
        self.max_restarts = max_restarts
        self.restarts = 0
        loop.ckpt_dir = ckpt_dir

    def run(self, total_steps: int, seed: int = 0, step_hook=None):
        params, opt_state = self.loop.init(seed)
        save_checkpoint(self.ckpt_dir, 0, {"params": params, "opt": opt_state})
        step = 0
        while step < total_steps:
            try:
                params, opt_state = self.loop.run(
                    params, opt_state, start_step=step,
                    num_steps=total_steps - step, step_hook=step_hook)
                step = total_steps
            except SimulatedPreemption:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                # fresh-process semantics: restore the latest checkpoint
                like = {"params": params, "opt": opt_state}
                restored, manifest = restore_checkpoint(
                    self.ckpt_dir, like, device=self.loop.device)
                params, opt_state = restored["params"], restored["opt"]
                step = manifest["step"]
        return params, opt_state


@dataclasses.dataclass
class StragglerMonitor:
    """Per-shard step-time EMA; flags shards slower than k x median."""

    n_shards: int
    alpha: float = 0.2
    threshold: float = 2.0
    ema: Optional[np.ndarray] = None

    def update(self, times: Dict[int, float]) -> List[int]:
        if self.ema is None:
            self.ema = np.zeros(self.n_shards)
            self.ema[:] = np.median(list(times.values()))
        for s, t in times.items():
            self.ema[s] = (1 - self.alpha) * self.ema[s] + self.alpha * t
        med = np.median(self.ema)
        return [s for s in range(self.n_shards)
                if self.ema[s] > self.threshold * med]
