"""mistral-large-123b [dense] (hf:mistralai/Mistral-Large-Instruct-2407).

88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768.  The smoke
config is the port's rep=4 GQA case (8 query heads over 2 kv heads).
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv=8,
    head_dim=128,
    d_ff=28672,
    vocab=32768,
    train_accum=8,
    fsdp=True,
)

SMOKE = dataclasses.replace(
    CONFIG, fsdp=False, train_accum=1,
    n_layers=2, d_model=128, n_heads=8, n_kv=2, head_dim=16,
    d_ff=256, vocab=256,
)
