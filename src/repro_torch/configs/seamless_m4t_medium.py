"""seamless-m4t-medium [audio] — enc-dec, multimodal (arXiv:2308.11596).

12L decoder + 12L encoder, d_model=1024 16H (kv=16) d_ff=4096
vocab=256206, non-gated GELU FFN.  The speech frontend is a stub:
precomputed frame embeddings ``[B, Se, 1024]`` enter the encoder through
the ``front`` projection; the decoder cross-attends to the encoder's
output.  Served by ``lm.prefill(tokens, frames=...)`` and
``lm.decode_step``.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    n_enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv=16,
    d_ff=4096,
    vocab=256206,
    act="gelu",
    frontend="frames",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv=4,
    d_ff=128, vocab=256,
)
