"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 2:1
(arXiv:2402.19427, Griffin).

26L d_model=2560 10H (GQA kv=1, head dim 256) d_ff=7680 vocab=256000;
pattern (rglru, rglru, attn_local) with window 2048, so 8 repeats and a
trailing (rglru, rglru) segment.  Recurrent state and the local ring
buffer do not page: it serves through the dense ``ServeLoop``.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv=1,
    head_dim=256,
    d_ff=7680,
    vocab=256000,
    block_pattern=("rglru", "rglru", "attn_local"),
    local_window=2048,
    lru_dim=2560,
    train_accum=4,
    supports_long=True,
)

SMOKE = dataclasses.replace(
    CONFIG, train_accum=1,
    n_layers=5, d_model=64, n_heads=2, n_kv=1, head_dim=32,
    d_ff=128, vocab=256, lru_dim=64, local_window=32,
)
