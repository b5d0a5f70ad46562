"""minicpm-2b [dense] — llama-like (arXiv:2404.06395).

40L d_model=2304 36H (kv=36) d_ff=5760 vocab=122753 (the odd vocab is
kept: embeddings are not lookup linears).  Tied embeddings.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv=36,
    d_ff=5760,
    vocab=122753,
    tie_embeddings=True,
    fsdp=True,
    pure_fsdp=True,
)

SMOKE = dataclasses.replace(
    CONFIG, fsdp=False, pure_fsdp=False,
    n_layers=2, d_model=72, n_heads=4, n_kv=4, d_ff=160, vocab=257,
)
