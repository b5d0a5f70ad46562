"""kimi-k2-1t-a32b [moe] — trillion-param MoE (Kimi K2 paper table).

61L d_model=7168 64H d_ff(expert)=2048 vocab=163840, MoE 384 routed
experts top-8 + 1 shared, MLA attention (DeepSeek-V3 lineage; 64 heads).
First layer dense FFN (d_ff 18432).
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv=8,
    d_ff=18432,            # dense layers (layer 0)
    vocab=163840,
    attn_kind="mla",
    mla_q_lora=1536,
    mla_kv_lora=512,
    mla_rope_dim=64,
    mla_nope_dim=128,
    mla_v_dim=128,
    n_experts=384,
    top_k=8,
    n_shared=1,
    d_expert=2048,
    moe_layer_start=1,
    tlmac_narr_cap=512,
    opt_state_dtype="int8",
    train_accum=8,
    fsdp=True,
)

SMOKE = dataclasses.replace(
    CONFIG, fsdp=False, train_accum=1, opt_state_dtype="f32",
    n_layers=3, d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=256,
    mla_q_lora=32, mla_kv_lora=16, mla_rope_dim=8, mla_nope_dim=16,
    mla_v_dim=16, n_experts=8, top_k=2, d_expert=32, moe_layer_start=1,
)
