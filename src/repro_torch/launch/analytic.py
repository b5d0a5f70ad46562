"""Analytic roofline model (port of ``repro.launch.analytic``, which is
framework-free): exact FLOP, byte and collective counts for the model
structure (MaxText-style napkin math, mechanised), read from the port's
configs and ``models.lm.segments_for``.

It is the dry run's only cost source: the port compiles no graph, so
there is no compiler cost analysis to cross-check it against.

All counts are GLOBAL (whole step, all chips); the roofline divides by
chip count.  Train = fwd + bwd = 3x forward matmul FLOPs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.lm import segments_for


def _attn_flops_per_tok(cfg: ArchConfig, ctx: int, decode: bool) -> float:
    """Self-attention flops per token at context length ctx (fwd)."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.kv_head_dim
    if cfg.attn_kind == "mla":
        ql, kvl = cfg.mla_q_lora, cfg.mla_kv_lora
        nod, rod, vd = cfg.mla_nope_dim, cfg.mla_rope_dim, cfg.mla_v_dim
        proj = 2 * (d * ql + ql * H * (nod + rod) + d * (kvl + rod))
        if decode:
            # absorbed: q_eff = q_nope @ W_uk (H*nod*kvl), scores over ckv,
            # out_c @ W_uv
            proj += 2 * H * (nod * kvl + kvl * vd) + 2 * H * vd * d
            att = 2 * ctx * H * (kvl + rod) + 2 * ctx * H * kvl
        else:
            proj += 2 * (kvl * H * (nod + vd)) + 2 * H * vd * d
            att = 4 * ctx * H * (nod + rod)
        return proj + att
    proj = 2 * d * hd * (2 * H + 2 * KV)
    att = 4 * ctx * H * hd
    return proj + att


def _ffn_flops_per_tok(cfg: ArchConfig) -> float:
    mults = 3 if cfg.act == "swiglu" else 2
    return 2 * mults * cfg.d_model * cfg.d_ff


def _moe_flops_per_tok(cfg: ArchConfig) -> float:
    d, de = cfg.d_model, cfg.d_expert
    active = 2 * 3 * d * de * (cfg.top_k + cfg.n_shared)
    router = 2 * d * cfg.n_experts
    # dispatch/combine one-hot einsums: 2 * E * cap * d each, cap/t = cf*k/E
    dispatch = 2 * 2 * cfg.capacity_factor * cfg.top_k * d
    return active + router + dispatch


def _block_flops_per_tok(kind: str, cfg: ArchConfig, ctx: int, decode: bool) -> float:
    d = cfg.d_model
    if kind in ("attn", "enc_attn"):
        return _attn_flops_per_tok(cfg, ctx, decode) + _ffn_flops_per_tok(cfg)
    if kind == "attn_moe":
        return _attn_flops_per_tok(cfg, ctx, decode) + _moe_flops_per_tok(cfg)
    if kind == "attn_local":
        w = min(cfg.local_window, ctx)
        return _attn_flops_per_tok(cfg, w, decode) + _ffn_flops_per_tok(cfg)
    if kind == "dec_cross":
        # self + cross attention + ffn; cross ctx = enc len (~ctx)
        return (
            _attn_flops_per_tok(cfg, ctx, decode) * 2 + _ffn_flops_per_tok(cfg)
        )
    if kind == "mlstm":
        inner = 2 * d
        up = 2 * d * 2 * inner
        qkv = 3 * 2 * inner * inner
        cell = 4 * inner * (inner // cfg.n_heads)  # C update + Cq per head
        down = 2 * inner * d
        return up + qkv + cell + down
    if kind == "slstm":
        hd = d // cfg.n_heads
        return 2 * d * 4 * d + 8 * d * hd + 4 * d * d
    if kind == "rglru":
        lru = cfg.lru_dim or d
        cell = 2 * 3 * d * lru + 2 * 2 * lru * lru + 14 * lru
        return cell + _ffn_flops_per_tok(cfg)
    raise ValueError(kind)


def _block_weight_bytes(kind: str, cfg: ArchConfig, serve_impl: str) -> float:
    """Weight bytes read per block application (decode: full weights)."""
    d = cfg.d_model

    def lin(k, n, quantisable=True):
        if not quantisable or serve_impl == "dense":
            return 2.0 * k * n
        if serve_impl == "int8":
            return 1.0 * k * n
        if serve_impl == "tlmac":
            G = cfg.tlmac_G
            # exec_idx per G-group (uint8 when the pool cap <= 256,
            # else int16) + int8 cluster map + tables
            bpe = 1.0 if cfg.tlmac_narr_cap <= 256 else 2.0
            idx = bpe * k * n / G
            cl = 1.0 * (k / G) * (n / min(cfg.tlmac_dp, n))
            n_arr = min(2 ** (cfg.quant.w_bits * G), cfg.tlmac_narr_cap)
            table = 4.0 * 4 * n_arr * 2**G
            return idx + cl + table + 4.0 * n  # + w_step
        raise ValueError(serve_impl)

    H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.kv_head_dim
    if kind in ("attn", "attn_moe", "attn_local", "enc_attn", "dec_cross"):
        if cfg.attn_kind == "mla":
            ql, kvl = cfg.mla_q_lora, cfg.mla_kv_lora
            nod, rod, vd = cfg.mla_nope_dim, cfg.mla_rope_dim, cfg.mla_v_dim
            att = (
                lin(d, ql) + lin(ql, H * (nod + rod)) + lin(d, kvl + rod)
                + lin(kvl, H * (nod + vd), quantisable=False)
                + lin(H * vd, d)
            )
        else:
            att = lin(d, H * hd) + 2 * lin(d, KV * hd) + lin(H * hd, d)
        if kind == "dec_cross":
            att += lin(d, H * hd) + 2 * lin(d, KV * hd) + lin(H * hd, d)
        if kind == "attn_moe":
            de = cfg.d_expert
            # decode touches only routed experts' weights:
            # min(tokens*topk, E) experts actually read per step — handled
            # by caller via moe_active_fraction; here full bytes:
            ff = 3 * lin(d, de) * (cfg.n_experts + cfg.n_shared) + 2 * d * cfg.n_experts
        else:
            mults = 3 if cfg.act == "swiglu" else 2
            ff = mults * lin(d, cfg.d_ff)
        return att + ff
    if kind == "mlstm":
        inner = 2 * d
        return lin(d, 2 * inner) + 3 * lin(inner, inner) + lin(inner, d)
    if kind == "slstm":
        return lin(d, 4 * d) + 2 * lin(d, d) + 2 * 4 * d * (d // cfg.n_heads)
    if kind == "rglru":
        lru = cfg.lru_dim or d
        mults = 3 if cfg.act == "swiglu" else 2
        return 3 * lin(d, lru) + 2 * lin(lru, lru) + mults * lin(d, cfg.d_ff)
    raise ValueError(kind)


def _kv_bytes_per_layer(kind: str, cfg: ArchConfig, S: int, B: int) -> float:
    """Decode-step cache bytes read+written per layer (bf16)."""
    KV, hd = cfg.n_kv, cfg.kv_head_dim
    if kind == "enc_attn":
        return 0.0  # encoder blocks keep no decode cache
    if kind in ("attn", "attn_moe"):
        if cfg.attn_kind == "mla":
            return 2.0 * B * S * (cfg.mla_kv_lora + cfg.mla_rope_dim)
        return 2.0 * B * S * 2 * KV * hd
    if kind == "attn_local":
        return 2.0 * B * min(cfg.local_window, S) * 2 * KV * hd
    if kind == "dec_cross":
        return 2.0 * B * S * 2 * KV * hd * 2
    if kind == "mlstm":
        inner = 2 * cfg.d_model
        return 4.0 * B * cfg.n_heads * (inner // cfg.n_heads) ** 2 * 2
    if kind == "slstm":
        return 4.0 * B * cfg.d_model * 4 * 2
    if kind == "rglru":
        return 4.0 * B * (cfg.lru_dim or cfg.d_model) * 2
    raise ValueError(kind)


def _blocks(cfg: ArchConfig):
    out = []
    for seg in segments_for(cfg):
        out += list(seg.pattern) * seg.n
    if cfg.n_enc_layers:
        out += ["enc_attn"] * cfg.n_enc_layers
    return out


@dataclasses.dataclass
class AnalyticRoofline:
    flops: float
    hbm_bytes: float
    collective_bytes: float
    detail: Dict[str, float]


def analyze(cfg: ArchConfig, shape: ShapeConfig, mesh_shape=(16, 16),
            serve_impl: str = None) -> AnalyticRoofline:
    """Global FLOPs / HBM bytes / collective bytes for one step."""
    serve_impl = serve_impl or cfg.serve_impl
    multi = len(mesh_shape) == 3
    n_pod = mesh_shape[0] if multi else 1
    n_data = mesh_shape[-2]
    n_model = mesh_shape[-1]
    n_chips = n_pod * n_data * n_model

    B, S = shape.global_batch, shape.seq_len
    d, V = cfg.d_model, cfg.vocab
    blocks = _blocks(cfg)

    if shape.kind == "train":
        toks = B * S
        ctx = S / 2  # causal average
        fwd = sum(_block_flops_per_tok(k, cfg, ctx, False) for k in blocks) * toks
        fwd += 2 * d * V * toks  # logits
        flops = 3.0 * fwd  # fwd + bwd(2x); remat adds +1 fwd => see detail
        remat_extra = fwd if cfg.remat == "layer" else 0.0
        flops += remat_extra

        # params+grads+opt traffic + activations w/ remat
        n_params = cfg.param_count()
        opt_bytes = {"f32": 12, "bf16": 8, "int8": 6.06}[cfg.opt_state_dtype]
        param_traffic = n_params * (4 + 4 + opt_bytes)  # read w, write g, opt rw
        act = 2.0 * toks * d * len(blocks) * 4  # boundaries, bf16, fwd+bwd rw
        kv_like = 0.0
        hbm = param_traffic + act + kv_like

        # collectives: grad all-reduce over (pod x data); TP per layer
        grad_ar = 2.0 * n_params * 4 * (1 if (n_data * n_pod) > 1 else 0)
        if cfg.fsdp or getattr(cfg, "pure_fsdp", False):
            # ZeRO-3: all-gather params fwd+bwd + reduce-scatter grads
            grad_ar = 3.0 * n_params * 2 + n_params * 4
        tp_ar = 0.0
        if n_model > 1 and not getattr(cfg, "pure_fsdp", False):
            per_layer = 2 * 2 * toks * d * 2  # 2 AR x (fwd+bwd) x bf16
            tp_ar = per_layer * len(blocks) * 2 * (n_model - 1) / n_model
        moe_a2a = 0.0
        if cfg.n_experts:
            n_moe = sum(1 for k in blocks if k == "attn_moe")
            moe_a2a = 4 * toks * cfg.top_k * cfg.capacity_factor * d * 2 * n_moe / cfg.top_k
        coll = grad_ar + tp_ar + moe_a2a
        detail = dict(fwd_flops=fwd, remat_extra=remat_extra,
                      param_traffic=param_traffic, act_bytes=act,
                      grad_ar=grad_ar, tp_ar=tp_ar, moe_a2a=moe_a2a)

    elif shape.kind == "prefill":
        toks = B * S
        ctx = S / 2
        flops = sum(_block_flops_per_tok(k, cfg, ctx, False) for k in blocks) * toks
        flops += 2 * d * V * B  # last-position logits
        wb = sum(_block_weight_bytes(k, cfg, serve_impl) for k in blocks)
        act = 2.0 * toks * d * len(blocks) * 2
        kv_write = sum(_kv_bytes_per_layer(k, cfg, S, B) for k in blocks) / 2
        hbm = wb + act + kv_write + 2 * V * d
        tp_ar = (
            2 * toks * d * 2 * len(blocks) * 2 * (n_model - 1) / n_model
            if n_model > 1 else 0.0
        )
        moe_a2a = 0.0
        if cfg.n_experts:
            n_moe = sum(1 for k in blocks if k == "attn_moe")
            moe_a2a = 4 * toks * cfg.capacity_factor * d * 2 * n_moe
        coll = tp_ar + moe_a2a
        detail = dict(weight_bytes=wb, act_bytes=act, kv_write=kv_write,
                      tp_ar=tp_ar, moe_a2a=moe_a2a)

    else:  # decode / long-decode: one token per sequence
        toks = B
        ctx = S
        flops = sum(_block_flops_per_tok(k, cfg, ctx, True) for k in blocks) * toks
        flops += 2 * d * V * toks
        wb = sum(_block_weight_bytes(k, cfg, serve_impl) for k in blocks)
        if cfg.n_experts:
            # decode reads only the experts hit by B*topk tokens
            n_moe = sum(1 for k in blocks if k == "attn_moe")
            de = cfg.d_expert
            full_moe = 3 * _lin_bytes(cfg, d, de, serve_impl) * cfg.n_experts
            hit = min(B * cfg.top_k, cfg.n_experts)
            wb -= n_moe * (cfg.n_experts - hit) / cfg.n_experts * full_moe
        kv = sum(_kv_bytes_per_layer(k, cfg, S, B) for k in blocks)
        act = 2.0 * toks * d * len(blocks) * 2
        hbm = wb + kv + act + 2 * V * d
        tp_ar = (
            2 * toks * d * 2 * len(blocks) * 2 * (n_model - 1) / n_model
            if n_model > 1 else 0.0
        )
        moe_a2a = 0.0
        if cfg.n_experts:
            moe_a2a = 4 * toks * cfg.top_k * cfg.capacity_factor * d * 2 * (
                sum(1 for k in blocks if k == "attn_moe")
            ) / cfg.top_k
        coll = tp_ar + moe_a2a
        detail = dict(weight_bytes=wb, kv_bytes=kv, act_bytes=act,
                      tp_ar=tp_ar, moe_a2a=moe_a2a)

    return AnalyticRoofline(
        flops=flops, hbm_bytes=hbm, collective_bytes=coll, detail=detail
    )


def _lin_bytes(cfg, k, n, serve_impl):
    if serve_impl == "dense":
        return 2.0 * k * n
    if serve_impl == "int8":
        return 1.0 * k * n
    G = cfg.tlmac_G
    return 2.0 * k * n / G + 4.0 * n


def model_flops_6nd(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE) for the step's token count."""
    n = cfg.active_param_count() if cfg.n_experts else cfg.param_count()
    if shape.kind == "train":
        toks = shape.global_batch * shape.seq_len
        return 6.0 * n * toks
    if shape.kind == "prefill":
        toks = shape.global_batch * shape.seq_len
        return 2.0 * n * toks
    return 2.0 * n * shape.global_batch
