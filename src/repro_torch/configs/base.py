"""Architecture and shape configuration (port of ``repro.configs.base``):
the fields the serve, train and parallel paths read, the four assigned
LM shapes (``SHAPES``) of the dry run, and the analytic parameter counts
of ``launch/analytic.py``.  ``QuantConfig`` lives in
``repro_torch.core.quant.quantizers``, as in the reference."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

from repro_torch.core.quant.quantizers import QuantConfig


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode' | 'long-decode'


# The four assigned LM shapes (the reference's, for the dry run).
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "long-decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | vlm | moe | ssm | hybrid | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    # --- attention ---
    attn_kind: str = "gqa"       # gqa | mla (deepseek-style latent
                                 # attention: dense-cache ServeLoop only)
                                 # | none (ssm: no attention block)
    local_window: int = 2048     # attn_local blocks' sliding window
    # mla dims (models/attention.py::init_mla)
    mla_q_lora: int = 1536
    mla_kv_lora: int = 512
    mla_rope_dim: int = 64
    mla_nope_dim: int = 128
    mla_v_dim: int = 128
    # --- moe (models/moe.py) ---
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    d_expert: int = 0
    moe_layer_start: int = 0     # dense layers before MoE starts (DSv3: 3)
    capacity_factor: float = 1.25
    # --- hybrid / ssm ---
    block_pattern: Tuple[str, ...] = ()   # e.g. ('rglru','rglru','attn_local')
    conv_width: int = 4          # causal depthwise conv of rglru / mLSTM
    lru_dim: Optional[int] = None  # RG-LRU width (d_model when None)
    # --- enc-dec: encoder layers before the dec_cross decoder ---
    n_enc_layers: int = 0
    # --- frontend stubs: a vlm's 'front' leaf is carried, never read;
    # an enc-dec model's projects the frames into its encoder ---
    frontend: str = "none"       # none | patch | frames
    frontend_len: int = 0        # prepended embedding positions
    act: str = "swiglu"
    tie_embeddings: bool = False
    qkv_bias: bool = False
    # --- quantisation (the paper's technique) ---
    quant: QuantConfig = QuantConfig(w_bits=3, a_bits=3)
    tlmac_G: int = 4
    tlmac_dp: int = 128
    tlmac_narr_cap: int = 4096   # LUT-pool capacity budget for plan shapes
    linear_impl: str = "qdq"     # train linears: dense (bf16) | qdq (N2UQ
                                 # activations + LSQ weights, fake-quant)
    serve_impl: str = "tlmac"    # serve linears: dense | int8 | tlmac
                                 # (apply dispatches on the params, so
                                 # mixed layouts serve too)
    serve_tlmac_impl: str = "auto"  # tlmac serve linears' lookup GEMM:
                                 # 'auto' = the autotune cache's winner
                                 # (kernels/autotune.py; kernel 1 on a
                                 # miss), 'fused' = kernel 1, 'pallas' =
                                 # kernels 4 + 3, 'ref' = the plain oracle
    serve_kv_dtype: str = "fp"   # paged KV pool dtype: fp | int8 | int4
    serve_paged_attn_impl: str = "auto"  # paged decode attention reader:
                                 # 'auto' = the autotune cache's winner
                                 # (flash-decode at 4 splits on a miss),
                                 # 'flash' = the flash-decode kernel at 4
                                 # splits, 'lax' = gather + masked softmax
    serve_shared_act_quant: bool = True  # swiglu wi/wg share wi's a_step
    # --- paged serve loop: admission, paging, preemption (the
    # reference's names and defaults) ---
    serve_prefix_cache: bool = True   # radix-tree prefix cache over the pool
    serve_prefix_cache_pages: int = 0  # pages the tree may keep (0 = pool-bound)
    serve_on_demand_pages: bool = True  # admission covers the padded prefill;
                                  # decode pages grow at page boundaries
    serve_preempt_policy: str = "priority"  # victim on exhaustion, or 'never'
    serve_sched_aging: int = 64   # ticks waited per priority level gained
    serve_priority_default: int = 0   # priority of a request without one
    serve_queue_limit: int = 0    # submit backpressure bound (0 = none)
    serve_check_invariants: bool = False  # structural checks every step
    # --- swap tier, deadlines and tenants (serve/swap.py, serve/faults.py)
    serve_swap: bool = False      # copy preemption victims' pages to host
                                  # memory and restore them at resume
    serve_swap_bytes: int = 0     # host budget of the swap store (0 = none)
    serve_swap_policy: str = "auto"  # per victim: 'auto' (measured rates),
                                  # 'always' or 'never'
    serve_swap_ring_pages: int = 8  # pages per staging-ring transaction
    serve_deadline_s: float = 0.0  # default TTL from submit (0 = none)
    serve_tenant_page_quota: int = 0  # soft cap on a tenant's live pages
    serve_tenant_swap_bytes: int = 0  # per-tenant swap-store budget
    serve_tenant_queue_limit: int = 0  # per-tenant queued-request bound
    # --- speculation and telemetry (serve/spec.py, serve/telemetry.py) ---
    serve_spec_k: int = 0         # draft up to k tokens per live slot and
                                  # score all k+1 in one verify forward
                                  # (0 = off: plain one-token decode)
    serve_spec_drafter: str = "ngram"  # 'ngram' (prompt lookup) or 'none'
    serve_telemetry: bool = False  # lifecycle tracer + phase histograms
    serve_trace_path: str = ""    # run() exports the Chrome trace here
                                  # (and a JSONL twin at path + 'l')
    # --- training (train/trainer.py, launch/train.py) ---
    remat: str = "layer"         # none | layer (recompute each layer in
                                 # the backward: torch.utils.checkpoint)
    opt_state_dtype: str = "f32"  # AdamW moments: f32 | bf16 | int8
    train_accum: int = 1         # gradient-accumulation microbatches
    # --- parallelism (parallel/sharding.py, launch/dryrun.py) ---
    fsdp: bool = False           # shard params over ('pod', 'data') too
    pure_fsdp: bool = False      # no TP: params over ('data', 'model'),
                                 # the batch data-parallel over the same
    # --- capability flags ---
    supports_long: bool = False  # sub-quadratic path for long_500k

    @property
    def kv_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Analytic parameter count (the 6ND model FLOPs), the
        reference's formula."""
        d, L, V = self.d_model, self.n_layers, self.vocab
        hd = self.kv_head_dim
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":  # xlstm
            return emb + L * _xlstm_layer_params(self)
        att = _attn_params(self)
        if self.n_experts:
            moe_ff = 3 * d * self.d_expert * (self.n_experts + self.n_shared)
            router = d * self.n_experts
            dense_ff = 3 * d * (self.d_ff or self.d_expert)
            n_moe = L - self.moe_layer_start
            ff = self.moe_layer_start * dense_ff + n_moe * (moe_ff + router)
            return emb + L * att + ff
        if self.family == "hybrid":
            n_attn = sum(1 for b in self.block_pattern if b == "attn")
            pat_len = max(len(self.block_pattern), 1)
            n_attn_layers = L * n_attn // pat_len
            n_rec = L - n_attn_layers
            rec = _rglru_layer_params(self)
            return (emb + n_attn_layers * att + n_rec * rec
                    + L * 3 * d * self.d_ff)
        ff = 3 * d * self.d_ff if self.act == "swiglu" else 2 * d * self.d_ff
        enc = self.n_enc_layers * (att + ff + 2 * d * hd * self.n_heads)
        return emb + L * (att + ff) + enc

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if not self.n_experts:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        att = _attn_params(self)
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        act_ff = 3 * d * self.d_expert * (self.top_k + self.n_shared)
        dense_ff = 3 * d * (self.d_ff or self.d_expert)
        n_moe = L - self.moe_layer_start
        ff = (self.moe_layer_start * dense_ff
              + n_moe * (act_ff + d * self.n_experts))
        return emb + L * att + ff


def _attn_params(cfg: ArchConfig) -> int:
    d, hd = cfg.d_model, cfg.kv_head_dim
    if cfg.attn_kind == "mla":
        q = d * cfg.mla_q_lora + cfg.mla_q_lora * cfg.n_heads * (
            cfg.mla_nope_dim + cfg.mla_rope_dim)
        kv = d * (cfg.mla_kv_lora + cfg.mla_rope_dim) + cfg.mla_kv_lora * (
            cfg.n_heads * (cfg.mla_nope_dim + cfg.mla_v_dim))
        o = cfg.n_heads * cfg.mla_v_dim * d
        return q + kv + o
    return d * hd * (cfg.n_heads + 2 * cfg.n_kv) + cfg.n_heads * hd * d


def _xlstm_layer_params(cfg: ArchConfig) -> int:
    # mLSTM block: up-proj 2x, q/k/v over the 2d inner width, gates,
    # down-proj (the reference's count)
    d = cfg.d_model
    inner = 2 * d
    return 2 * d * inner + 3 * inner * inner + 2 * inner + inner * d


def _rglru_layer_params(cfg: ArchConfig) -> int:
    d = cfg.d_model
    lru = cfg.lru_dim or d
    return 2 * d * lru + lru * cfg.conv_width + 2 * lru + lru * d


# The reference's registry order (``repro.configs.base._REGISTRY``)
_REGISTRY = [
    "xlstm_350m", "codeqwen15_7b", "minicpm_2b", "mistral_large_123b",
    "command_r_35b", "recurrentgemma_2b", "kimi_k2_1t", "deepseek_v3_671b",
    "seamless_m4t_medium", "internvl2_76b", "resnet18",
]


_ALIASES = {
    "codeqwen1.5-7b": "codeqwen15_7b",
    "minicpm-2b": "minicpm_2b",
    "mistral-large-123b": "mistral_large_123b",
    "command-r-35b": "command_r_35b",
    "internvl2-76b": "internvl2_76b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "kimi-k2-1t-a32b": "kimi_k2_1t",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "xlstm-350m": "xlstm_350m",
    "seamless-m4t-medium": "seamless_m4t_medium",
}


def list_archs():
    return list(_REGISTRY)


def _module(name: str):
    mod_name = _ALIASES.get(name, name).replace("-", "_")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def smoke_config(name: str) -> ArchConfig:
    """Reduced same-family config for CPU tests."""
    return _module(name).SMOKE
