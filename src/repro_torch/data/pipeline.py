"""Synthetic deterministic data pipeline (the port's copy of
``repro.data.pipeline``, which is numpy and framework-free; its batches
are bit-equal to the reference's).

- Deterministic random access: ``batch(step)`` is a pure function of
  (seed, step, shard), so resuming after a preemption replays the exact
  stream.
- Sharded generation: each data-parallel shard makes only its slice.
- Token streams are Zipf-ish (more realistic logits and loss than
  uniform).
- ``batch_specs``: the abstract global batch of the dry run (meta
  tensors with the reference's shapes and dtypes).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class SyntheticLMData:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend: str = "none"       # none | patch | frames
    frontend_len: int = 0
    frontend_dim: int = 1152
    enc_len: int = 0             # enc-dec: frames length

    def batch(self, step: int, shard: int = 0, n_shards: int = 1) -> dict:
        """Deterministic batch for (step, shard): a dict of numpy arrays."""
        if self.global_batch % n_shards:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split into {n_shards} shards")
        b = self.global_batch // n_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))
        # Zipf-like marginal over the vocab, stable across steps
        ranks = rng.integers(1, self.vocab, size=(b, self.seq_len))
        tokens = (self.vocab / ranks ** 0.7).astype(np.int64) % self.vocab
        out = {"tokens": tokens.astype(np.int32)}
        if self.enc_len:
            out["frames"] = rng.standard_normal(
                (b, self.enc_len, 1024), dtype=np.float32)
        elif self.frontend != "none":
            out["front"] = rng.standard_normal(
                (b, self.frontend_len, self.frontend_dim), dtype=np.float32)
        return out

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def batch_specs(cfg, shape) -> dict:
    """Meta-tensor stand-ins for a global batch (the dry run's; the
    reference's ``jax.ShapeDtypeStruct``s): an audio model splits the
    sequence in half between target tokens and frames ``[B, S/2, 1024]``,
    a model with a frontend prepends ``frontend_len`` patch embeddings
    ``[B, F, 1152]``."""
    B, S = shape.global_batch, shape.seq_len
    meta = lambda *s, dtype: torch.empty(s, dtype=dtype, device="meta")
    out = {}
    if cfg.family == "audio":
        S_tok = S // 2
        out["tokens"] = meta(B, S_tok, dtype=torch.int32)
        out["frames"] = meta(B, S - S_tok, 1024, dtype=torch.float32)
    elif cfg.frontend != "none":
        out["tokens"] = meta(B, S - cfg.frontend_len, dtype=torch.int32)
        out["front"] = meta(B, cfg.frontend_len, 1152, dtype=torch.float32)
    else:
        out["tokens"] = meta(B, S, dtype=torch.int32)
    return out
