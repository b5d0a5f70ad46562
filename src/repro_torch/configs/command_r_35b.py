"""command-r-35b [dense] (hf:CohereForAI/c4ai-command-r-v01).

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000, no bias.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    head_dim=128,
    d_ff=22528,
    vocab=256000,
    train_accum=4,
    fsdp=True,
)

SMOKE = dataclasses.replace(
    CONFIG, fsdp=False, train_accum=1,
    n_layers=2, d_model=128, n_heads=8, n_kv=2, head_dim=16,
    d_ff=256, vocab=512,
)
