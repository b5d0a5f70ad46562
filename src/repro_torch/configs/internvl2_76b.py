"""internvl2-76b [vlm] — InternViT + Llama3-70B-class backbone
(arXiv:2404.16821).

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.  The ViT
frontend is a stub: serve params carry its projection (``front``), which
the paged forwards never read.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    head_dim=128,
    d_ff=28672,
    vocab=128256,
    frontend="patch",
    frontend_len=256,
    train_accum=4,
    fsdp=True,
)

SMOKE = dataclasses.replace(
    CONFIG, fsdp=False, train_accum=1,
    n_layers=2, d_model=128, n_heads=8, n_kv=2, head_dim=16,
    d_ff=256, vocab=512, frontend_len=8,
)
