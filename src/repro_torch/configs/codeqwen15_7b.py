"""codeqwen1.5-7b [dense] — qwen1.5 arch (hf:Qwen/CodeQwen1.5-7B).

32L d_model=4096 32H (kv=32, MHA) d_ff=13440 vocab=92416, QKV bias.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=32,
    d_ff=13440,
    vocab=92416,
    qkv_bias=True,
    fsdp=True,
)

SMOKE = dataclasses.replace(
    CONFIG, fsdp=False,
    n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128, vocab=256,
)
