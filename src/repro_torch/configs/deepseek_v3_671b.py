"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8
(arXiv:2412.19437).

61L d_model=7168 128H vocab=129280; expert dim 2048; first 3 layers
dense FFN (18432).  MLA blocks serve through the dense-cache ``ServeLoop``
(MLA caches are not paged, as in the reference); the paged MoE path
serves ``dataclasses.replace(CONFIG, attn_kind="gqa")`` (128 heads over
128 KV heads of dim 56), the reference's own pageable variant.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv=128,
    d_ff=18432,            # dense layers (0..2)
    vocab=129280,
    attn_kind="mla",
    mla_q_lora=1536,
    mla_kv_lora=512,
    mla_rope_dim=64,
    mla_nope_dim=128,
    mla_v_dim=128,
    n_experts=256,
    top_k=8,
    n_shared=1,
    d_expert=2048,
    moe_layer_start=3,
    tlmac_narr_cap=512,
    opt_state_dtype="int8",
    train_accum=8,
    fsdp=True,
)

SMOKE = dataclasses.replace(
    CONFIG, fsdp=False, train_accum=1, opt_state_dtype="f32",
    n_layers=4, d_model=64, n_heads=4, n_kv=4, d_ff=128, vocab=256,
    mla_q_lora=32, mla_kv_lora=16, mla_rope_dim=8, mla_nope_dim=16,
    mla_v_dim=16, n_experts=8, top_k=2, d_expert=32, moe_layer_start=2,
)
