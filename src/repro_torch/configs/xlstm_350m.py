"""xlstm-350m [ssm] — sLSTM + mLSTM blocks (arXiv:2405.04517).

24L d_model=1024 4H d_ff=0 (FFN folded into the xLSTM blocks, projection
factor 2) vocab=50304; 7:1 mLSTM:sLSTM.  No attention: the decode cache
is the mLSTM matrix memories and the sLSTM states, served through the
dense ``ServeLoop``.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv=4,
    d_ff=0,
    vocab=50304,
    attn_kind="none",
    train_accum=8,
    supports_long=True,
)

SMOKE = dataclasses.replace(
    CONFIG, train_accum=1,
    n_layers=8, d_model=64, n_heads=2, vocab=256,
)
