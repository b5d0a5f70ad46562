"""LM backbone (port of ``repro.models.lm``): the serve forwards of every
family, and their training forward.  Block kinds, as in the reference:

    attn        self-attention (GQA or MLA per ``cfg.attn_kind``) + FFN
    attn_moe    self-attention + MoE FFN
    attn_local  sliding-window attention + FFN
    mlstm/slstm xLSTM blocks (the FFN folded inside, d_ff = 0)
    rglru       RG-LRU temporal block + FFN
    enc_attn    bidirectional encoder block
    dec_cross   decoder block with cross-attention (enc-dec)

The paged forwards of ``serve.paged.PagedServeLoop`` (``prefill_chunk``,
``decode_step_paged``, ``verify_step_paged``) serve models whose every
block is ``attn``/``attn_moe``/``attn_local`` with GQA
(``supports_paged``); the dense-cache forwards (``prefill``,
``decode_step``) of ``serve.loop.ServeLoop`` serve every family: MLA on
latent caches, the recurrent kinds on their states, and an enc-dec model
(``prefill(tokens, frames=...)`` runs ``encode`` first and caches the
cross-attention K/V).

The training forward (``forward``: next-token loss and logits, under
autograd) covers every family the reference trains: each block kind,
GQA and MLA attention, the MoE FFN with its load-balance aux loss
(``0.01 x`` the sum over layers joins the loss), an enc-dec model's
encoder (``batch['frames']``) and a VLM's frontend embeddings
(``batch['front']``, prepended to the tokens).  Its linears are the
train path's (``nn.linear_apply``, fake-quant QAT); ``cfg.remat ==
'layer'`` recomputes each layer in the backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``).

Params stay stacked ``[n_layers, ...]`` per segment as in JAX; a Python
loop over layers replaces the scans.  Differences from JAX, on purpose:

- the caches are updated IN PLACE (``prefill_chunk``,
  ``decode_step_paged``, ``verify_step_paged``, ``prefill``'s fresh
  caches, ``decode_step``, ``cache_copy_page`` and ``cache_swap_in``
  write the caches they are given and return the same objects; a
  recurrent block copies its new state into its cache), where JAX
  returns new arrays: the serve loop's captured graphs hold the pools'
  addresses;
- ``prefill_chunk`` takes ``start`` and ``last`` as 0-d int32 device
  tensors (Python ints are accepted too), so one captured CUDA graph of
  the ``[1, C]`` chunk serves every chunk of every prompt, as one jit
  trace does in JAX; ``verify_step_paged`` takes ``positions`` and
  ``n_writes`` as device tensors for the same reason;
- ``prefill`` takes the token tensor and, as keywords, an enc-dec
  model's ``frames`` and a VLM's ``front`` (the reference's batch dict
  entries), not a batch dict; its ``S_max`` defaults to the front's rows
  and the tokens, where the reference's is the tokens alone (a cache its
  store of the front's rows overflows);
- the ``jax.named_scope`` labels of the forwards are
  ``torch.profiler.record_function`` ranges (host ranges: inside a
  captured graph they are recorded at capture, not at replay).

Every param leaf carries the reference's partition spec from the line
that makes it (``param_axes`` reads them; ``cache_axes_tree`` gives the
caches'), and the reference's eight ``shard_hint`` sites are kept.

Sharded serving: under ``launch.mesh.mesh_context(mesh)`` the dense-cache
forwards ``prefill`` and ``decode_step`` of every family run on this
rank's blocks, as the reference's ``jax.jit`` runs them under the
shardings of its specs: params from ``convert.params_from_jax(..., mesh=,
cfg=)`` or ``parallel.sharding.local_tree(tree, param_axes(cfg), mesh)``,
this rank's rows of the batch (``sharding.batch_entry``; with them its
rows of ``frames`` or ``front``), caches made by ``init_caches(...,
mesh=)`` (or by ``prefill``).  The linears are tensor parallel over
'model' (``nn.tp_linear_apply``); the attention runs on this rank's heads
or its cache positions (``attention.tp_gqa_prefill``, ``tp_gqa_decode``;
an ``attn_local`` ring on its slots; the encoder's bidirectional
attention and the cross-attention, ``tp_cross_prefill``,
``tp_cross_decode``, on its heads or encoder positions; MLA's
``tp_mla_prefill``, ``tp_mla_decode`` on its heads and its positions of
the latent cache); the recurrent blocks on this rank's blocks of their
states (``rglru.tp_rglru_block_apply``, ``xlstm.tp_mlstm_apply``,
``tp_slstm_apply``); a MoE FFN is expert parallel (each rank's block of
experts, one launch a stack, the combine summed over 'model';
``moe.moe_apply``); a VLM's front is the train-path linear, its FSDP
weight gathered at use; the embedding and the logits are vocab-parallel
and ``greedy`` is their argmax over 'model'; every collective goes
through ``parallel.collectives``.  The residual stream is whole on every
rank of 'model'.  The returned logits are this rank's block of the padded
vocab.

Sharded training: under the mesh the train ``forward`` of every family
runs on this rank's param blocks and batch rows (``_forward_sharded``),
as the reference's ``make_train_step`` jitted with its specs' shardings
runs it: tensor and sequence parallel over 'model' (``_tp_train_block``,
Megatron-SP; MLA on this rank's heads, ``attention.tp_mla_train``; the
recurrent blocks on this rank's channels or state blocks over the whole
sequence), a MoE FFN expert parallel over 'model' with its aux loss over
the global batch (``moe.moe_apply``), an enc-dec model's encoder
sequence-sharded and its output gathered once for every ``dec_cross``
block (``_encode_train``), a VLM's front rows before the tokens in the
sequence cut (``_sequence_block``), the embedding, logits and loss
vocab-parallel, FSDP weights gathered at use; or under ``pure_fsdp`` the
plain blocks on the rows, every weight gathered at use.  What no
reference config trains raises under a mesh (``check_sharded_train``),
and so do the paged forwards.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.kernels import paged as paged_kernels
from repro_torch.models import attention as attn
from repro_torch.models import moe, nn, rglru, xlstm
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import (_SPEC_ATTR, P, batch_entry,
                                           block_range, current_mesh,
                                           shard_hint, spec_of, spec_tree,
                                           with_spec)


@dataclasses.dataclass(frozen=True)
class Segment:
    pattern: Tuple[str, ...]
    n: int


def segments_for(cfg) -> List[Segment]:
    """The reference's segments: ``dense``/``vlm`` one segment of ``attn``
    blocks; ``moe`` a segment of ``moe_layer_start`` ``attn`` blocks, then
    one of ``attn_moe`` blocks; ``ssm`` (xLSTM) the pattern of 7 ``mlstm``
    and one ``slstm``, the remainder a trailing segment of ``mlstm``;
    ``hybrid`` its ``block_pattern`` repeated, the remainder a trailing
    partial segment; ``audio`` (enc-dec) the decoder's ``dec_cross``
    blocks (the encoder's ``enc_attn`` blocks are ``encode``'s).  A MoE
    config cut to its dense layers (``n_layers <= moe_layer_start``) has
    no ``attn_moe`` segment: a segment of no layers holds no params.
    Attention is ``cfg.attn_kind``: GQA or MLA (``none``: an xLSTM model
    builds no attention block)."""
    if cfg.attn_kind not in ("gqa", "mla", "none"):
        raise ValueError(f"attn_kind {cfg.attn_kind!r} not in gqa | mla | "
                         "none")
    L = cfg.n_layers
    if cfg.family == "moe":
        segs = []
        if cfg.moe_layer_start:
            segs.append(Segment(("attn",), min(cfg.moe_layer_start, L)))
        if L > cfg.moe_layer_start:
            segs.append(Segment(("attn_moe",), L - cfg.moe_layer_start))
        return segs
    if cfg.family == "ssm":
        segs = [Segment(("mlstm",) * 7 + ("slstm",), L // 8)]
        if L % 8:
            segs.append(Segment(("mlstm",) * (L % 8), 1))
        return segs
    if cfg.family == "hybrid":
        pat = cfg.block_pattern or ("rglru", "rglru", "attn_local")
        segs = [Segment(tuple(pat), L // len(pat))]
        rem = L % len(pat)
        if rem:
            segs.append(Segment(tuple(pat[:rem]), 1))
        return segs
    if cfg.family == "audio":
        return [Segment(("dec_cross",), L)]
    if cfg.family not in ("dense", "vlm"):
        raise ValueError(f"family {cfg.family!r} not in dense | vlm | moe | "
                         "ssm | hybrid | audio")
    return [Segment(("attn",), L)]


# Block kinds whose serve cache lives in a paged pool.
PAGED_KINDS = ("attn", "attn_moe", "attn_local")


def supports_paged(cfg) -> bool:
    """True when every block's serve cache can be paged (the paged serve
    loop's admission precondition).  False for MLA, as in the reference:
    its cache is the compressed latents (``ckv``, ``kr``), which the
    paged pools' per-head K/V layout and the flash-decode reader do not
    hold, so MLA models serve through the dense-cache ``ServeLoop``; nor
    for the recurrent kinds (an O(1) state, nothing to page) and enc-dec
    models (their cross caches stay dense)."""
    if cfg.attn_kind == "mla" or cfg.n_enc_layers:
        return False
    return all(kind in PAGED_KINDS
               for seg in segments_for(cfg) for kind in seg.pattern)


def init_ffn(gen, cfg, device="cuda", linear_init=nn.init_serve_linear):
    d, f = cfg.d_model, cfg.d_ff
    p = {"wi": linear_init(gen, d, f, cfg, device=device)}
    if cfg.act == "swiglu":
        p["wg"] = linear_init(gen, d, f, cfg, device=device)
    p["wo"] = linear_init(gen, f, d, cfg, device=device, shard=("model", None))
    return p


def ffn_apply(params, x, cfg, apply_fn):
    """The gated product, or the gelu's last product, reaches ``wo`` in
    f32: XLA fuses it into ``wo``'s activation quantiser and drops its
    rounding to bf16."""
    pair_apply = getattr(apply_fn, "pair_apply", None)
    if (pair_apply is not None and cfg.serve_shared_act_quant
            and "wg" in params):
        h, g = pair_apply(params["wi"], params["wg"], x, cfg)
        h = h.float() * nn.silu(g)
    else:
        h = apply_fn(params["wi"], x, cfg)
        if "wg" in params:
            h = h.float() * nn.silu(apply_fn(params["wg"], x, cfg))
        else:
            h = nn.gelu(h, f32_out=True)
    return apply_fn(params["wo"], h, cfg)


ATTN_KINDS = ("attn", "attn_moe", "attn_local", "enc_attn", "dec_cross")


def init_block(gen, kind: str, cfg, device="cuda",
               linear_init=nn.init_serve_linear):
    """One block's params, the reference's leaves for each kind: serve
    linears, or with ``linear_init=nn.init_linear`` the train path's
    (expert-stacked for a MoE FFN)."""
    p = {"norm1": nn.init_rmsnorm(cfg.d_model, device)}
    if kind in ATTN_KINDS:
        init_attn = attn.init_mla if cfg.attn_kind == "mla" else attn.init_gqa
        p["attn"] = init_attn(gen, cfg, device, linear_init)
        p["norm2"] = nn.init_rmsnorm(cfg.d_model, device)
        if kind == "attn_moe":
            p["moe"] = moe.init_moe(gen, cfg, device, linear_init)
        else:
            p["ffn"] = init_ffn(gen, cfg, device, linear_init)
        if kind == "dec_cross":
            p["xattn"] = attn.init_gqa(gen, cfg, device, linear_init)
            p["norm3"] = nn.init_rmsnorm(cfg.d_model, device)
    elif kind == "mlstm":
        p["cell"] = xlstm.init_mlstm(gen, cfg, device, linear_init)
    elif kind == "slstm":
        p["cell"] = xlstm.init_slstm(gen, cfg, device, linear_init)
    elif kind == "rglru":
        p["cell"] = rglru.init_rglru_block(gen, cfg, device, linear_init)
        p["norm2"] = nn.init_rmsnorm(cfg.d_model, device)
        p["ffn"] = init_ffn(gen, cfg, device, linear_init)
    else:
        raise ValueError(f"block kind {kind!r}")
    return p


def _write_state(cache, state) -> None:
    """A recurrent block's new state into its cache views, in place."""
    if cache is not None:
        for name, v in state.items():
            cache[name].copy_(v)


def _residual(x, y):
    """``x + y`` of the stream (bf16) and its f32 sum: XLA fuses the
    residual add into the norm after it, which reads the add's f32 sum
    unrounded, while the stream keeps its bf16 sum."""
    s = x.float() + y
    return s.to(x.dtype), s


def apply_block(kind: str, params, x, cfg, apply_fn, cache=None, pos=None,
                decode: bool = False, paged_ctx=None, enc_out=None,
                x32=None):
    """One block; returns ``(x, cache, aux, last)``: ``aux`` an
    ``attn_moe`` block's load-balance loss (a 0-d f32 tensor; serve drops
    it), 0.0 for every other kind; ``last`` the operands ``(x, y)`` of an
    attention or ``rglru`` block's last residual add (None for the xLSTM
    kinds).

    ``x32`` (the train forward's layer bodies): the f32 sum of the
    previous block's ``last``.  Inside one layer of a pattern of several
    blocks, XLA fuses that add into an attention block's first norm,
    which reads the sum unrounded (found by the hybrid patterns'
    bit-equality: ``rglru`` or ``attn_local`` followed by ``attn_local``);
    an ``rglru`` block's norm reads the rounded ``x``.

    ``paged_ctx`` routes attention through the layer's paged pool
    ``cache``: ``{'block_table', 'positions', 'n_writes'}`` for a verify
    window, ``{'block_table', 'positions', 'impl'}`` for decode,
    ``{'block_table', 'start'}`` for a prefill chunk.  Without it the
    dense cache ``{'k', 'v'}`` is read and written at the shared
    position ``pos`` (decode, ring buffer for ``attn_local``) or filled
    by the prompt (prefill; ``cache`` None runs no store).  An MLA block
    reads and writes its latent cache ``{'ckv', 'kr'}`` the same way; a
    ``dec_cross`` block also attends over ``enc_out`` (prefill, its K/V
    stored as ``xk``/``xv``) or the cached ``xk``/``xv`` (decode); an
    ``enc_attn`` block attends bidirectionally and caches nothing.  A
    recurrent block (``mlstm``, ``slstm``, ``rglru``) starts from the
    state in ``cache`` (zeros: a prefill) and writes its final state
    back into it."""
    if current_mesh() is not None:
        if apply_fn is nn.serve_linear_apply:
            return _tp_block(kind, params, x, cfg, apply_fn, cache, pos,
                             decode, paged_ctx, enc_out)
        check_sharded_train(cfg, kind)
        if not cfg.pure_fsdp:
            return _tp_train_block(kind, params, x, cfg, x32, enc_out)
        # pure_fsdp: the plain block on this rank's batch rows, each linear
        # gathering its FSDP blocks (nn.linear_apply)
    h = nn.rmsnorm_apply(params["norm1"], x if x32 is None else x32,
                         dtype=x.dtype)
    if kind in ("mlstm", "slstm"):
        fn = xlstm.mlstm_apply if kind == "mlstm" else xlstm.slstm_apply
        y, state = fn(params["cell"], h, cfg, state=cache, apply_fn=apply_fn)
        _write_state(cache, state)
        return x + y, cache, 0.0, None
    if kind == "rglru":
        y, state = rglru.rglru_block_apply(params["cell"], h, cfg,
                                           state=cache, apply_fn=apply_fn)
        _write_state(cache, state)
        x, s = _residual(x, y)
        hf = nn.rmsnorm_apply(params["norm2"], s, dtype=x.dtype)
        y = ffn_apply(params["ffn"], hf, cfg, apply_fn)
        return x + y, cache, 0.0, (x, y)
    if kind not in ATTN_KINDS:
        raise ValueError(f"block kind {kind!r}")
    window = cfg.local_window if kind == "attn_local" else None
    is_mla = cfg.attn_kind == "mla"
    if paged_ctx is not None and (is_mla or kind not in PAGED_KINDS):
        raise ValueError(f"block kind {kind!r} (attn_kind "
                         f"{cfg.attn_kind!r}) is not paged (supports_paged)")
    if paged_ctx is not None:
        if "n_writes" in paged_ctx:
            y, cache = attn.gqa_verify_paged(
                params["attn"], h, cfg, cache, paged_ctx["block_table"],
                paged_ctx["positions"], paged_ctx["n_writes"],
                window=window, apply_fn=apply_fn)
        elif decode:
            y, cache = attn.gqa_decode_paged(
                params["attn"], h, cfg, cache, paged_ctx["block_table"],
                paged_ctx["positions"], window=window, apply_fn=apply_fn,
                impl=paged_ctx.get("impl", "auto"))
        else:
            y, cache = attn.gqa_prefill_chunk(
                params["attn"], h, cfg, cache, paged_ctx["block_table"],
                paged_ctx["start"], window=window, apply_fn=apply_fn)
    elif decode:
        if is_mla:
            y, _ = attn.mla_decode(params["attn"], h, cfg,
                                   (cache["ckv"], cache["kr"]), pos,
                                   apply_fn=apply_fn)
        elif kind == "attn_local":
            y = _local_decode(params["attn"], h, cfg, cache, pos, apply_fn)
        else:
            y, _ = attn.gqa_decode(params["attn"], h, cfg,
                                   (cache["k"], cache["v"]), pos,
                                   apply_fn=apply_fn)
    else:
        if kind == "enc_attn":
            y, kv = _bidir_attn(params["attn"], h, cfg, apply_fn)
        else:
            fwd = attn.mla_train if is_mla else attn.gqa_train
            y, kv = fwd(params["attn"], h, cfg, window=window,
                        apply_fn=apply_fn, kv_quant_rt=cache is not None)
        if cache is not None:
            _store_prefill(kind, cache, kv)
    x, s = _residual(x, y)
    if kind == "dec_cross":
        h2 = nn.rmsnorm_apply(params["norm3"], s, dtype=x.dtype)
        if decode:
            y2, _ = attn.gqa_decode(params["xattn"], h2, cfg, None, pos,
                                    apply_fn=apply_fn,
                                    cross_kv=(cache["xk"], cache["xv"]))
        else:
            xk, xv = _cross_kv(params["xattn"], enc_out, cfg, apply_fn)
            y2, _ = attn.gqa_train(params["xattn"], h2, cfg,
                                   apply_fn=apply_fn, cross_kv=(xk, xv))
            if cache is not None:
                cache["xk"].copy_(xk)
                cache["xv"].copy_(xv)
        x, s = _residual(x, y2)
    hf = nn.rmsnorm_apply(params["norm2"], s, dtype=x.dtype)
    aux = 0.0
    if kind == "attn_moe":
        y, aux = moe.moe_apply(params["moe"], hf, cfg, apply_fn=apply_fn)
    else:
        y = ffn_apply(params["ffn"], hf, cfg, apply_fn)
    return x + y, cache, aux, (x, y)


def _tp_block(kind: str, params, x, cfg, apply_fn, cache, pos, decode,
              paged_ctx, enc_out=None):
    """``apply_block`` of a dense-cache serve forward under the active
    mesh, on this rank's blocks, the residual stream whole on every rank
    of 'model' and this rank's rows of the batch.  Its linears are tensor
    parallel over 'model' (``nn.tp_linear_apply``) and, by kind:

    - ``attn``/``attn_moe``: the attention on this rank's heads or cache
      positions (``attention.tp_gqa_prefill``/``tp_gqa_decode``,
      ``tp_mla_prefill``/``tp_mla_decode``), a MoE FFN expert-parallel
      (``moe.moe_apply``);
    - ``attn_local``: the same on the ring of the last ``W`` keys, cut on
      its slots where the KV heads do not divide 'model'
      (``lm._local_decode``'s slot ``pos % W``);
    - ``enc_attn``: the encoder's bidirectional attention on this rank's
      heads, no cache;
    - ``dec_cross``: the self-attention as ``attn``, then the
      cross-attention over the encoder's K/V (``attention.tp_cross_prefill``
      makes and stores them, ``tp_cross_decode`` reads them);
    - ``rglru``, ``mlstm``, ``slstm``: the recurrent blocks on this rank's
      blocks of their states (``rglru.tp_rglru_block_apply``,
      ``xlstm.tp_mlstm_apply``, ``tp_slstm_apply``).

    The paged forwards do not run sharded (the reference's paged loop
    runs unsharded; the train forward is ``_tp_train_block``'s)."""
    if paged_ctx is not None:
        raise NotImplementedError(
            f"block {kind!r} (attn_kind {cfg.attn_kind!r}) of a paged "
            "forward under a mesh: the paged forwards do not run sharded "
            "(the reference's PagedServeLoop runs them unsharded); the "
            "dense-cache forwards lm.prefill and lm.decode_step do")
    h = nn.rmsnorm_apply(params["norm1"], x)
    if kind in ("mlstm", "slstm"):
        fn = xlstm.tp_mlstm_apply if kind == "mlstm" else xlstm.tp_slstm_apply
        y, state = fn(params["cell"], h, cfg, cache)
        _write_state(cache, state)
        return x + y, cache, 0.0, None
    if kind == "rglru":
        y, state = rglru.tp_rglru_block_apply(params["cell"], h, cfg, cache)
        _write_state(cache, state)
        x, s = _residual(x, y)
        hf = nn.rmsnorm_apply(params["norm2"], s, dtype=x.dtype)
        y = _tp_ffn(params["ffn"], hf, cfg)
        return x + y, cache, 0.0, (x, y)
    if kind not in ATTN_KINDS:
        raise ValueError(f"block kind {kind!r}")
    mla = cfg.attn_kind == "mla"
    window = cfg.local_window if kind == "attn_local" else None
    if kind == "enc_attn":
        y, split = attn.tp_gqa_prefill(params["attn"], h, cfg, bidir=True)
    elif decode:
        fn = attn.tp_mla_decode if mla else attn.tp_gqa_decode
        kv = (cache["ckv"], cache["kr"]) if mla else (cache["k"], cache["v"])
        if kind == "attn_local":
            W = cache["k"].shape[1] * _ring_shards(cfg)
            y, split = fn(params["attn"], h, cfg, kv, pos, slot=pos % W)
        else:
            y, split = fn(params["attn"], h, cfg, kv, pos)
    elif mla:
        y, split = attn.tp_mla_prefill(params["attn"], h, cfg, cache)
    else:
        y, split = attn.tp_gqa_prefill(params["attn"], h, cfg, cache,
                                       window=window)
    x, s = _residual(x, nn.gather_cols(y, split))
    if kind == "dec_cross":
        h2 = nn.rmsnorm_apply(params["norm3"], s, dtype=x.dtype)
        if decode:
            y2, split = attn.tp_cross_decode(params["xattn"], h2, cfg,
                                             (cache["xk"], cache["xv"]))
        else:
            y2, split = attn.tp_cross_prefill(params["xattn"], h2, enc_out,
                                              cfg, cache)
        x, s = _residual(x, nn.gather_cols(y2, split))
    hf = nn.rmsnorm_apply(params["norm2"], s, dtype=x.dtype)
    if kind == "attn_moe":
        y, _ = moe.moe_apply(params["moe"], hf, cfg)
    else:
        y = _tp_ffn(params["ffn"], hf, cfg)
    return x + y, cache, 0.0, (x, y)


def _ring_shards(cfg) -> int:
    """Over how many ranks an ``attn_local`` ring's slots are cut: 'model'
    where the KV heads do not divide it (``cache_axes``), else none."""
    return 1 if attn.kv_heads_sharded(cfg) else coll.size("model")


def check_sharded_train(cfg, kind: Optional[str] = None) -> None:
    """Raise for what the sharded train step does not cover (``kind``, or
    every kind of the config), none of which a reference config trains: a
    MoE FFN under ``pure_fsdp``; a recurrent block under ``pure_fsdp``
    (its plain gate, conv and recurrence leaves are cut on 'model', which
    ``pure_fsdp`` gives the batch); an mLSTM whose heads divide the
    'model' axis (``xlstm._check_tp_heads``)."""
    kinds = ({kind} if kind is not None else
             {k for seg in segments_for(cfg) for k in seg.pattern})
    if "attn_moe" in kinds and cfg.pure_fsdp:
        raise NotImplementedError(
            f"the MoE FFN of {cfg.name!r} under pure_fsdp: experts are "
            "parallel over 'model', which pure_fsdp gives the batch (no "
            "reference config trains it; ROADMAP queue 1)")
    recurrent = sorted(kinds & {"rglru", "mlstm", "slstm"})
    if recurrent and cfg.pure_fsdp:
        raise NotImplementedError(
            f"the {recurrent} blocks of {cfg.name!r} under pure_fsdp: their "
            "plain leaves are cut on 'model', which pure_fsdp gives the "
            "batch (no reference config trains them)")
    if "mlstm" in kinds:
        xlstm._check_tp_heads(cfg)


def _tp_train_block(kind: str, params, x, cfg, x32=None, enc_out=None):
    """A block of the train forward under the mesh with tensor and
    sequence parallelism over 'model' (Megatron-SP): ``x [B, S_l, d]`` is
    this rank's sequence block of its batch rows (``x32`` the same block's
    f32 sum, where the layer body passes one).  The norms run on the
    block; the block's sequence is all-gathered (backward: reduce-scatter)
    into the column-parallel linears; the row-parallel ones' f32 partial
    sums are reduce-scattered back onto the sequence block and rounded to
    bf16 once (backward: all-gather).  By kind:

    - ``attn``, ``attn_local``, ``enc_attn``: the attention on this rank's
      heads (``attention.tp_gqa_train``: causal, windowed or
      bidirectional; MLA's ``tp_mla_train``), then the FFN;
    - ``attn_moe``: the same with a MoE FFN expert parallel
      (``moe.moe_apply`` on the block, which gathers and scatters the
      sequence itself); its aux loss is returned;
    - ``dec_cross``: the self-attention, then the cross-attention of this
      rank's heads over ``enc_out`` (the encoder's output, whole:
      ``attention.tp_cross_train``), then the FFN;
    - ``rglru``: the recurrent block on this rank's lru channels over the
      whole sequence (``rglru.tp_rglru_train``), then the FFN;
    - ``mlstm``, ``slstm``: the xLSTM cells in the serve path's layout
      (``xlstm.tp_mlstm_train``, ``tp_slstm_train``); the sLSTM's
      column-parallel ``down`` is gathered whole and its sequence block
      kept."""
    h = nn.rmsnorm_apply(params["norm1"], x if x32 is None else x32,
                         dtype=x.dtype)
    h = coll.all_gather_ad(h, "model", dim=1)
    # the reference's enc-dec decoder has no sequence-parallel hint, and its
    # partitioned graph rounds each rank's row-parallel product to bf16
    # before the f32 sum over 'model' (read in its compiled train HLO)
    rs = functools.partial(_seq_reduce_scatter, bf16=kind == "dec_cross")
    if kind == "mlstm":
        y = _seq_reduce_scatter(xlstm.tp_mlstm_train(params["cell"], h, cfg))
        return x + y, None, 0.0, None
    if kind == "slstm":
        y = coll.split(xlstm.tp_slstm_train(params["cell"], h, cfg), "model",
                       dim=1)
        return x + y, None, 0.0, None
    if kind == "rglru":
        y = rglru.tp_rglru_train(params["cell"], h, cfg)
    elif cfg.attn_kind == "mla":
        y = attn.tp_mla_train(params["attn"], h, cfg)
    else:
        y = attn.tp_gqa_train(
            params["attn"], h, cfg, bidir=kind == "enc_attn",
            window=cfg.local_window if kind == "attn_local" else None)
    x, s = _residual(x, rs(y))
    if kind == "dec_cross":
        h2 = nn.rmsnorm_apply(params["norm3"], s, dtype=x.dtype)
        h2 = coll.all_gather_ad(h2, "model", dim=1)
        y2 = attn.tp_cross_train(params["xattn"], h2, enc_out, cfg)
        x, s = _residual(x, rs(y2))
    hf = nn.rmsnorm_apply(params["norm2"], s, dtype=x.dtype)
    if kind == "attn_moe":
        y, aux = moe.moe_apply(params["moe"], hf, cfg,
                               apply_fn=nn.linear_apply)
        return x + y, None, aux, (x, y)
    hf = coll.all_gather_ad(hf, "model", dim=1)
    y = rs(ffn_apply(params["ffn"], hf, cfg, nn.linear_apply))
    return x + y, None, 0.0, (x, y)


def _seq_reduce_scatter(y, bf16: bool = False):
    """A row-parallel linear's f32 partial sums ``[B, S, d]`` onto this
    rank's sequence block: summed over 'model' in f32, rounded to bf16
    once (``bf16``: each partial rounded to bf16 first)."""
    if bf16:
        y = y.to(nn.COMPUTE_DTYPE).float()
    return coll.reduce_scatter_ad(y, "model", dim=1).to(nn.COMPUTE_DTYPE)


def _tp_ffn(params, x, cfg):
    """``ffn_apply`` under the mesh: wi/wg on this rank's columns (or
    whole), the gated product in f32 into ``wo``, its output whole."""
    if cfg.serve_shared_act_quant and "wg" in params:
        h, g, split = nn.tp_linear_pair_apply(params["wi"], params["wg"], x,
                                              cfg)
        h = h.float() * nn.silu(g)
    else:
        h, split = nn.tp_linear_apply(params["wi"], x, cfg)
        if "wg" in params:
            g, _ = nn.tp_linear_apply(params["wg"], x, cfg)
            h = h.float() * nn.silu(g)
        else:
            h = nn.gelu(h, f32_out=True)
    return nn.gather_cols(*nn.tp_linear_apply(params["wo"], h, cfg,
                                              split=split))


def _bidir_attn(params, h, cfg, apply_fn):
    """The encoder's bidirectional self-attention: rotary at positions
    ``0..S-1``, every key visible (the direct masked softmax, as the
    reference).  Returns ``(y, (k, v))``."""
    B, S, _ = h.shape
    q, k, v = attn._qkv(params, h, cfg, apply_fn)
    positions = torch.arange(S, device=h.device)[None, :]
    sin, cos = nn.rotary_embedding(positions, cfg.kv_head_dim)
    q = nn.apply_rotary(q, sin, cos)
    k = nn.apply_rotary(k, sin, cos)
    mask = torch.ones((S, S), dtype=torch.bool, device=h.device)
    out = attn._sdpa(q, k, v, mask, cfg)
    return apply_fn(params["wo"], out.reshape(B, S, -1), cfg), (k, v)


def _cross_kv(params, enc_out, cfg, apply_fn):
    """The cross-attention K/V ``[B, Se, KV, hd]`` of the encoder's
    output, through the ``xattn`` block's ``wk``/``wv``."""
    B, Se, _ = enc_out.shape
    KV, hd = cfg.n_kv, cfg.kv_head_dim
    k = apply_fn(params["wk"], enc_out, cfg, use_bias=cfg.qkv_bias)
    v = apply_fn(params["wv"], enc_out, cfg, use_bias=cfg.qkv_bias)
    return k.reshape(B, Se, KV, hd), v.reshape(B, Se, KV, hd)


def _store_prefill(kind: str, cache, kv) -> None:
    """Write a prefill's K/V ``[B, S, KV, hd]`` into the dense cache, in
    place: positions ``[0, S)`` of an ``attn`` cache; for ``attn_local``
    the last ``W`` keys at ring indices ``0..`` (zeros after them when
    ``S < W``).  Under a quantised ``serve_kv_dtype`` the K/V arrive
    round-tripped already (``gqa_train``), so the store is a plain cast
    into the f32 cache.  An MLA cache takes the latents ``(c_kv, k_rope)``
    at positions ``[0, S)``."""
    if "ckv" in cache:
        ckv, kr = kv
        S = ckv.shape[1]
        cache["ckv"][:, :S] = ckv.to(cache["ckv"].dtype)
        cache["kr"][:, :S] = kr.to(cache["kr"].dtype)
        return
    k, v = kv
    if kind == "attn_local":
        W = cache["k"].shape[1]
        k, v = k[:, -W:], v[:, -W:]
        cache["k"].zero_()
        cache["v"].zero_()
    S = k.shape[1]
    cache["k"][:, :S] = k.to(cache["k"].dtype)
    cache["v"][:, :S] = v.to(cache["v"].dtype)


def _local_decode(params, h, cfg, cache, pos: int, apply_fn):
    """Ring-buffer sliding-window decode: the step's K/V go to index
    ``pos % W`` in place, and every index ``<= pos`` is read (rotary is
    absolute, so order in the ring does not matter)."""
    B = h.shape[0]
    q, k, v = attn._qkv(params, h, cfg, apply_fn)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=h.device)
    sin, cos = nn.rotary_embedding(positions, cfg.kv_head_dim)
    q = nn.apply_rotary(q, sin, cos)
    k = nn.apply_rotary(k, sin, cos)
    qs = paged_kernels.qspec_for(cfg)
    if qs.quantised:        # the equal-quantisation oracle
        k = paged_kernels.kv_roundtrip(k, qs)
        v = paged_kernels.kv_roundtrip(v, qs)
    kc, vc = cache["k"], cache["v"]
    W = kc.shape[1]
    slot = pos % W
    kc[:, slot:slot + 1] = k.to(kc.dtype)
    vc[:, slot:slot + 1] = v.to(vc.dtype)
    j = torch.arange(W, device=h.device)[None, :]
    out = attn._sdpa(q, kc, vc, j <= pos, cfg)
    return apply_fn(params["wo"], out.reshape(B, 1, -1), cfg)


def init_front(gen, cfg, device="cuda") -> dict:
    """The frontend stub's projection, the reference's train-path linear
    (``nn.init_linear``: ``w [d_front, d_model]`` f32 and, under
    ``linear_impl='qdq'``, its LSQ step and N2UQ activation params).  A
    VLM's is carried and never read when serving (the train forward
    projects a batch's ``front`` with it); an enc-dec model's encoder
    runs it (``nn.linear_apply``) on the frames."""
    d_front = 1024 if cfg.frontend == "frames" else 1152
    return nn.init_linear(gen, d_front, cfg.d_model, cfg, device=device,
                          shard=(None, None))


def _fill(dst, src, i: int) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            _fill(dst[k], v, i)
        else:
            dst[k][i] = v


def _empty_stack(tree, n: int):
    """Leaves ``[n, *leaf.shape]``, each spec gaining a leading None (the
    stacked layer axis is never sharded)."""
    return {k: _empty_stack(v, n) if isinstance(v, dict)
            else with_spec(torch.empty((n, *v.shape), dtype=v.dtype,
                                       device=v.device),
                           P(None, *spec_tree(v)))
            for k, v in tree.items()}


def init_segment(gen, seg: Segment, cfg, device="cuda",
                 linear_init=nn.init_serve_linear) -> dict:
    """One segment's params stacked ``[seg.n, ...]``: every leaf is
    allocated once and filled layer by layer, each layer drawn from
    ``gen`` in order and freed once copied, so the peak is the stacked
    params plus one layer.  On the meta device one layer gives the
    stack's shapes and specs."""
    out = None
    meta = torch.device(device).type == "meta"
    for i in range(1 if meta else seg.n):
        layer = {f"b{bi}": init_block(gen, kind, cfg, device, linear_init)
                 for bi, kind in enumerate(seg.pattern)}
        if out is None:
            out = _empty_stack(layer, seg.n)
        _fill(out, layer, i)
        del layer
    return out


def init_lm(cfg, gen: torch.Generator, purpose: str = "serve",
            device="cuda") -> nn.ParamTree:
    """Params drawn from ``gen`` (a generator on ``device``).  ``purpose``:

    - ``'serve'``: random serve linears (``cfg.serve_impl``), bf16
      embeddings, the frontend stub's ``front`` leaf where
      ``cfg.frontend`` is set, and an enc-dec model's ``encoder`` (one
      stacked segment of ``enc_attn`` blocks) and ``enc_norm``;
    - ``'train'``: the train path's linears (``nn.init_linear``, f32
      masters; expert-stacked in a MoE FFN), f32 embeddings, and the
      same ``front``, ``encoder`` and ``enc_norm`` leaves.

    Returns a ``ParamTree`` (trainable float leaves for ``'train'``)."""
    return nn.ParamTree(init_tree(cfg, gen, purpose, device),
                        trainable=purpose == "train")


def init_tree(cfg, gen: torch.Generator, purpose: str = "serve",
              device="cuda") -> dict:
    """``init_lm``'s nested dict of tensors, each leaf tagged with its
    partition spec (on ``device="meta"``: the abstract params of the dry
    run, nothing allocated)."""
    if purpose not in ("serve", "train"):
        raise ValueError(f"purpose {purpose!r} not in serve | train")
    train = purpose == "train"
    linear_init = nn.init_linear if train else nn.init_serve_linear
    emb_dtype = torch.float32 if train else torch.bfloat16
    p = {"embed": nn.init_embedding(gen, cfg.vocab, cfg.d_model, device,
                                    emb_dtype)}
    if not cfg.tie_embeddings:
        p["head"] = nn.init_embedding(gen, cfg.vocab, cfg.d_model, device,
                                      emb_dtype)
    if cfg.frontend != "none":
        p["front"] = init_front(gen, cfg, device)
    p["final_norm"] = nn.init_rmsnorm(cfg.d_model, device)
    if cfg.n_enc_layers:
        p["encoder"] = [init_segment(gen, _encoder_segment(cfg), cfg,
                                     device, linear_init)]
        p["enc_norm"] = nn.init_rmsnorm(cfg.d_model, device)
    p["segments"] = [init_segment(gen, seg, cfg, device, linear_init)
                     for seg in segments_for(cfg)]
    return p


def param_axes(cfg, purpose: str = "serve"):
    """The partition spec of every param leaf, in ``init_lm``'s tree (the
    reference's ``init_lm(...)[1]``), read from a meta init."""
    return spec_tree(init_tree(cfg, torch.Generator(), purpose, "meta"))


def _encoder_segment(cfg) -> Segment:
    return Segment(("enc_attn",), cfg.n_enc_layers)


def zero_cache(kind: str, cfg, B: int, S_max: int, n_layers: int = 0,
               device="cuda", enc_len: int = 0) -> dict:
    """Dense decode cache of one block kind (stacked ``[n_layers, ...]``
    when ``n_layers > 0``): ``attn`` ``[B, S_max, KV, hd]``, ``attn_local``
    a ring of ``min(local_window, S_max)``.  bf16, or f32 under a
    quantised ``serve_kv_dtype``: the cache then holds round-tripped
    values, so the dense loop is the equal-quantisation oracle of the
    paged path.  An MLA ``attn``/``attn_moe`` block caches its latents,
    ``ckv [B, S_max, kv_lora]`` and ``kr [B, S_max, rope]``, in bf16
    whatever ``serve_kv_dtype`` (the reference's).  A ``dec_cross`` block
    caches bf16 ``k``/``v`` of ``S_max`` and the encoder's ``xk``/``xv``
    of ``enc_len``; a recurrent block its f32 state (``mlstm``: ``C``,
    ``n``, ``m``, ``conv``; ``slstm``: ``c``, ``n``, ``h``, ``m``;
    ``rglru``: ``h``, ``conv``)."""
    lead = (n_layers,) if n_layers else ()
    if kind == "mlstm":
        inner = 2 * cfg.d_model
        return xlstm.mlstm_zero_state(B, cfg.n_heads, inner // cfg.n_heads,
                                      cfg.conv_width, device=device,
                                      lead=lead)
    if kind == "slstm":
        return xlstm.slstm_zero_state(B, cfg.d_model, device=device,
                                      lead=lead)
    if kind == "rglru":
        return rglru.rglru_zero_state(B, cfg.lru_dim or cfg.d_model,
                                      cfg.conv_width, device=device,
                                      lead=lead)
    if kind == "dec_cross":
        mk = lambda S: torch.zeros(
            (*lead, B, S, cfg.n_kv, cfg.kv_head_dim), dtype=torch.bfloat16,
            device=device)
        return {"k": mk(S_max), "v": mk(S_max), "xk": mk(enc_len),
                "xv": mk(enc_len)}
    if kind not in PAGED_KINDS:
        raise ValueError(f"block kind {kind!r} has no cache")
    if cfg.attn_kind == "mla" and kind in ("attn", "attn_moe"):
        mk = lambda w: torch.zeros((*lead, B, S_max, w),
                                   dtype=torch.bfloat16, device=device)
        return {"ckv": mk(cfg.mla_kv_lora), "kr": mk(cfg.mla_rope_dim)}
    S = min(cfg.local_window, S_max) if kind == "attn_local" else S_max
    dt = (torch.float32 if paged_kernels.qspec_for(cfg).quantised
          else torch.bfloat16)
    shape = (*lead, B, S, cfg.n_kv, cfg.kv_head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def init_caches(cfg, paged: Optional[paged_kernels.PageSpec] = None,
                device="cuda", B: int = 0, S_max: int = 0, enc_len: int = 0,
                mesh=None):
    """Stacked caches per segment, ``[{'b0': {...}}]``.  With ``paged``
    (a ``PageSpec``), paged pools ``{'k', 'v'[, 'ks', 'vs']}`` with leaves
    ``[n_layers, n_pages, P, KV, hd]``; without, the dense caches of
    ``zero_cache`` for ``B`` slots of ``S_max`` positions (and an
    encoder output of ``enc_len``).  With ``mesh`` (dense only): this
    rank's blocks under ``cache_axes_tree``, the batch cut by
    ``batch_entry(B, mesh)`` as the reference's dry run cuts it (whole
    where no data-parallel combo divides ``B``: a data axis of 1)."""
    if mesh is not None:
        if paged is not None:
            raise NotImplementedError("paged pools under a mesh: the paged "
                                      "forwards do not run sharded (the "
                                      "reference's paged loop runs them "
                                      "unsharded)")
        rows = block_range(B, batch_entry(B, mesh), mesh)[1]
        return _local_caches(cfg, rows, S_max, device, mesh, enc_len)
    if paged is None:
        return [{f"b{bi}": zero_cache(kind, cfg, B, S_max, seg.n, device,
                                      enc_len)
                 for bi, kind in enumerate(seg.pattern)}
                for seg in segments_for(cfg)]
    if not supports_paged(cfg):
        raise ValueError(f"config {cfg.name!r} has block kinds that cannot "
                         "be paged")
    qs = paged_kernels.qspec_for(cfg)
    return [{f"b{bi}": paged_kernels.zero_kv_pool(
                paged, cfg.n_kv, cfg.kv_head_dim, qs, n_layers=seg.n,
                device=device)
             for bi, _ in enumerate(seg.pattern)}
            for seg in segments_for(cfg)]


def cache_axes(kind: str, cfg, paged=None):
    """Partition specs of one block's cache (the reference's).  KV heads
    shard on 'model' when they divide the axis (16); otherwise the cache's
    sequence dim does (the decode attention's reduction then runs over S
    shards).  Paged pools shard the same way: KV heads when they divide,
    else the page dim; scale sidecars shard with their codes."""
    b = ("pod", "data")
    if paged is not None:
        if attn.kv_heads_sharded(cfg):
            s, s3 = P(None, None, "model", None), P(None, None, "model")
        else:
            s, s3 = P("model", None, None, None), P("model", None, None)
        out = {"k": s, "v": s}
        if paged_kernels.qspec_for(cfg).quantised:
            out["ks"] = out["vs"] = s3
        return out
    if kind in ("attn", "attn_moe") and cfg.attn_kind == "mla":
        return {"ckv": P(b, "model", None), "kr": P(b, "model", None)}
    if kind in ("attn", "attn_moe", "attn_local", "dec_cross"):
        if attn.kv_heads_sharded(cfg):
            s = P(b, None, "model", None)
        else:
            s = P(b, "model", None, None)
        out = {"k": s, "v": s}
        if kind == "dec_cross":
            out["xk"] = out["xv"] = s
        return out
    if kind == "mlstm":
        h_ok = cfg.n_heads % nn.MODEL_AXIS == 0
        return {
            "C": P(b, "model", None, None) if h_ok else P(b, None, "model",
                                                          None),
            "n": P(b, "model", None) if h_ok else P(b, None, "model"),
            "m": P(b, "model") if h_ok else P(b, None),
            "conv": P(b, None, "model"),
        }
    if kind == "slstm":
        z = P(b, "model")
        return {"c": z, "n": z, "h": z, "m": z}
    if kind == "rglru":
        return {"h": P(b, "model"), "conv": P(b, None, "model")}
    raise ValueError(f"block kind {kind!r} has no cache")


def _local_caches(cfg, rows: int, S_max: int, device, mesh,
                  enc_len: int = 0):
    """Zeroed dense caches of ``rows`` batch rows (this rank's already),
    every other dim cut to this rank's block of ``cache_axes_tree`` (a
    ``dec_cross`` block's ``xk``/``xv`` of ``enc_len`` positions); a
    recurrent block's state takes its zero state's values (``n`` of an
    sLSTM and ``m`` of an mLSTM are not zeros)."""
    shapes = init_caches(cfg, device="meta", B=rows, S_max=S_max,
                         enc_len=enc_len)

    def local(meta, spec, fill):
        shape = [n if d == 1 else block_range(n, e, mesh)[1]
                 for d, (n, e) in enumerate(zip(meta.shape, (*spec, *(
                     None,) * (meta.dim() - len(spec)))))]
        return torch.full(shape, fill, dtype=meta.dtype, device=device)

    specs = cache_axes_tree(cfg)
    out = []
    for si, (seg, blocks) in enumerate(zip(segments_for(cfg), shapes)):
        out.append({})
        for bi, kind in enumerate(seg.pattern):
            b = f"b{bi}"
            # every zero state is one value a leaf
            fills = {k: v.reshape(-1)[0].item() for k, v in zero_cache(
                kind, cfg, 1, 1, device="cpu", enc_len=1).items()}
            out[si][b] = {k: local(leaf, specs[si][b][k], fills[k])
                          for k, leaf in blocks[b].items()}
    return out


def cache_axes_tree(cfg, paged=None):
    """The specs of ``init_caches``' tree (the reference's
    ``init_caches(...)[1]``): each block's ``cache_axes`` under a leading
    None for the stacked layer axis."""
    return [{f"b{bi}": {k: P(None, *s)
                        for k, s in cache_axes(kind, cfg, paged).items()}
             for bi, kind in enumerate(seg.pattern)}
            for seg in segments_for(cfg)]


def _run_layers(params, caches, x, cfg, decode: bool, paged_ctx=None,
                pos=None, enc_out=None, stack: str = "segments"):
    apply_fn = nn.serve_linear_apply
    segs = ([_encoder_segment(cfg)] if stack == "encoder"
            else segments_for(cfg))
    for si, seg in enumerate(segs):
        for i, lp in enumerate(params.layers(si, stack)):
            for bi, kind in enumerate(seg.pattern):
                cache = None
                if caches is not None:
                    cache = {name: leaf[i]
                             for name, leaf in caches[si][f"b{bi}"].items()}
                x = apply_block(kind, lp[f"b{bi}"], x, cfg, apply_fn,
                                cache=cache, pos=pos, decode=decode,
                                paged_ctx=paged_ctx, enc_out=enc_out)[0]
    return x


def _head(params):
    return params.head.tree() if hasattr(params, "head") else params.embed.tree()


def _logits(params, x, cfg):
    x = nn.rmsnorm_apply(params.final_norm.tree(), x)
    return nn.logits_apply(_head(params), x, vocab=cfg.vocab)


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------


def _tree(params) -> dict:
    return params.tree() if isinstance(params, nn.ParamTree) else params


def _unstack(stacked, n: int) -> List[dict]:
    """The ``n`` per-layer trees of a stacked segment, indexed inside the
    autograd graph (one ``unbind`` a leaf), so each stacked leaf's
    gradient collects every layer's."""
    views = [{} for _ in range(n)]
    for k, v in stacked.items():
        parts = (_unstack(v, n) if isinstance(v, dict) else v.unbind(0))
        spec = getattr(v, _SPEC_ATTR, None)
        for i in range(n):
            views[i][k] = parts[i]
            if spec is not None and not isinstance(v, dict):
                # a layer's view carries the spec less the layer axis
                setattr(parts[i], _SPEC_ATTR, spec[1:])
    return views


def _segment_scan(seg: Segment, params_stacked, x, cfg, apply_fn,
                  remat: bool, enc_out=None):
    """The layers of one segment over the whole sequence (no caches),
    each layer recomputed in the backward under ``remat``.  ``enc_out``
    (an enc-dec decoder's) reaches every ``dec_cross`` block as an input
    of the checkpointed layer, so each block's cross K/V backward reaches
    the encoder.  Returns ``(x, aux)``: the aux losses summed over the
    layers in order (0.0 when no block has one)."""

    def body(xx, layer, enc):
        aux, last = 0.0, None
        for bi, kind in enumerate(seg.pattern):
            x32 = None
            if last is not None and kind in ATTN_KINDS:
                x32 = last[0].float() + last[1]
            xx, _, al, last = apply_block(kind, layer[f"b{bi}"], xx, cfg,
                                          apply_fn, enc_out=enc, x32=x32)
            aux = aux + al
        # sequence parallelism at the layer boundary (Megatron-SP)
        if cfg.pure_fsdp:
            xx = shard_hint(xx, P(("data", "model"), None, None))
        else:
            xx = shard_hint(xx, P(("pod", "data"), "model", None))
        return xx, aux

    aux_total = 0.0
    for layer in _unstack(params_stacked, seg.n):
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(
                body, x, layer, enc_out, use_reentrant=False,
                preserve_rng_state=False)
        else:
            x, aux = body(x, layer, enc_out)
        aux_total = aux_total + aux
    return x, aux_total


def next_token_loss(logits, tokens, cfg=None, start: int = 0):
    """Mean cross-entropy of next-token prediction: f32 logsumexp with the
    max held constant, padded vocab rows (-1e30) contributing nothing.

    Under the active mesh (``cfg`` given), of the sharded train step:
    ``logits``/``tokens`` are this rank's batch rows, and under tensor
    parallelism ``logits`` is its block of the padded vocab from global
    index ``start`` (vocab-parallel): the max is reduced over 'model' and
    held constant, ``sum(exp)`` summed over it, and the target's logit
    taken from the rank that holds it (a masked gather, summed over
    'model').  The mean over the local rows is then averaged over the
    batch axes, which is the global mean since every rank holds as many
    rows.  The loss is the same on every rank."""
    lg = logits[:, :-1].to(torch.float32)
    tg = tokens[:, 1:].long()
    if cfg is None or current_mesh() is None:
        true = lg.gather(-1, tg[..., None])[..., 0]
        m = lg.amax(dim=-1, keepdim=True).detach()
        lse = torch.log(torch.exp(lg - m).sum(dim=-1)) + m[..., 0]
        return (lse - true).mean()
    vocab = () if cfg.pure_fsdp else "model"
    n = lg.shape[-1]
    t = tg - start
    own = (t >= 0) & (t < n)
    true = lg.gather(-1, t.clamp(0, n - 1)[..., None])[..., 0]
    true = coll.all_reduce_ad(torch.where(own, true, torch.zeros_like(true)),
                              vocab)
    m = coll.all_reduce_max(lg.amax(dim=-1, keepdim=True), vocab)
    se = coll.all_reduce_ad(torch.exp(lg - m).sum(dim=-1), vocab)
    lse = torch.log(se) + m[..., 0]
    batch = nn.train_batch_axes(cfg)
    return coll.all_reduce_ad((lse - true).mean(), batch) / coll.size(batch)


def _encode_train(p: dict, frames, cfg):
    """The encoder under autograd (the reference's ``encode``, purpose
    'train'): the ``front`` projection of ``frames [B, Se, d_front]``, the
    ``enc_attn`` segment (recomputed per layer under ``cfg.remat``) and
    ``enc_norm``.  Under the mesh with tensor parallelism (the sharded
    train step) each rank projects its sequence block of the frames
    (``Se`` must divide over 'model'), the segment runs sequence-sharded
    as the decoder's does, and the normed output is gathered over 'model'
    once (backward: reduce-scattered) for every ``dec_cross`` block's
    cross K/V."""
    tp = current_mesh() is not None and not cfg.pure_fsdp
    if tp:
        _divides(frames.shape[1], "frame")
        frames = coll.split(frames, "model", dim=1)
    x = nn.linear_apply(p["front"], frames, cfg)
    x, _ = _segment_scan(_encoder_segment(cfg), p["encoder"][0], x, cfg,
                         nn.linear_apply, cfg.remat == "layer")
    x = nn.rmsnorm_apply(p["enc_norm"], x)
    return coll.all_gather_ad(x, "model", dim=1) if tp else x


def _divides(n: int, what: str) -> None:
    """Raise where ``n`` rows of a sequence do not divide over 'model'
    (the layer boundary is sequence-sharded there)."""
    m = coll.size("model")
    if n % m:
        raise ValueError(
            f"{what} length {n} does not divide over 'model' ({m} ranks): "
            "the layer boundary is sequence-sharded, which the reference's "
            "GSPMD pads and the port refuses")


def _sequence_block(x, fx):
    """This rank's block on 'model' of the decoder's input sequence: the
    token embeddings ``x [B, S, d]`` (whole on every rank of 'model'; the
    backward gathers the blocks' gradients), after a VLM's projected
    front rows ``fx [B, F, d]`` where given (``F + S`` cut; each rank keeps
    its front rows of the projection, so the ``front`` leaf's gradient is
    a partial sum over 'model', summed by ``trainer.grad_axes``)."""
    F = 0 if fx is None else fx.shape[1]
    _divides(F + x.shape[1], "sequence")
    if fx is None:
        return coll.split_ad(x, "model", dim=1)
    pad = x.new_zeros((x.shape[0], F, x.shape[2]))
    tok = coll.split_ad(torch.cat([pad, x], dim=1), "model", dim=1)
    n = tok.shape[1]
    lo = coll.index("model") * n
    nf = max(0, min(F - lo, n))
    return torch.cat([fx[:, lo:lo + nf].to(x.dtype), tok[:, nf:]], dim=1)


def forward(params, batch, cfg):
    """Training forward and next-token CE loss (the reference's
    ``forward``, purpose 'train'): ``batch`` ``{'tokens' [B, S]}`` on the
    params' device, with ``'frames' [B, Se, d_front]`` for an enc-dec
    config (encoded, then cross-attended by every decoder block) and,
    optionally, a VLM's ``'front' [B, F, d_front]`` (projected and
    prepended to the token embeddings; the logits are the tokens' rows).
    Returns ``(loss, logits [B, S, vocab] bf16)``, loss plus 0.01 x the
    summed aux loss.  ``params``: a ``ParamTree`` or its nested dict of
    tensors."""
    p = _tree(params)
    tokens = batch["tokens"]
    remat = cfg.remat == "layer"
    if current_mesh() is not None:
        return _forward_sharded(p, batch, cfg, remat)
    x = nn.embed_apply(p["embed"], tokens)
    enc_out = None
    if cfg.n_enc_layers:
        enc_out = _encode_train(p, batch["frames"], cfg)
    front = (cfg.frontend != "none" and "front" in batch
             and not cfg.n_enc_layers)
    if front:
        fx = nn.linear_apply(p["front"], batch["front"], cfg)
        x = torch.cat([fx.to(x.dtype), x], dim=1)
    x = shard_hint(x, P(("pod", "data"), None, None))
    aux_total = 0.0
    for seg, sp in zip(segments_for(cfg), p["segments"]):
        x, aux = _segment_scan(seg, sp, x, cfg, nn.linear_apply, remat,
                               enc_out)
        aux_total = aux_total + aux
    x = nn.rmsnorm_apply(p["final_norm"], x)
    if front:
        x = x[:, -tokens.shape[1]:]
    logits = nn.logits_apply(p.get("head", p["embed"]), x, vocab=cfg.vocab)
    logits = shard_hint(logits, P(("pod", "data"), None, "model"))
    loss = next_token_loss(logits, tokens)
    return loss + 0.01 * aux_total, logits[..., : cfg.vocab]


def _forward_sharded(p: dict, batch, cfg, remat: bool):
    """``forward`` under the active mesh, on this rank's param blocks and
    batch rows (the reference's ``make_train_step`` jitted with its specs'
    shardings): the embedding (``nn.train_embed_apply``), an enc-dec
    model's encoder (``_encode_train``), then under tensor parallelism
    this rank's sequence block on 'model' (a VLM's front rows before the
    tokens, ``_sequence_block``) into the layers (``_tp_train_block``), the
    final norm on the block, the sequence gathered and the tokens' rows
    kept for the vocab-parallel logits (``nn.train_logits_apply``) and
    loss (``next_token_loss``).  Under ``pure_fsdp`` the plain layers on
    the rows, each linear gathering its blocks.  Returns ``(loss,
    logits)``: the global loss on every rank, this rank's rows and (TP)
    its block of the vocab's real columns."""
    check_sharded_train(cfg)
    tokens = batch["tokens"]
    x = nn.train_embed_apply(p["embed"], tokens, cfg)
    enc_out = None
    if cfg.n_enc_layers:
        enc_out = _encode_train(p, batch["frames"], cfg)
    fx = None
    if cfg.frontend != "none" and "front" in batch and not cfg.n_enc_layers:
        # an FSDP-cut front weight: the reference's partitioned graph
        # re-cuts its rows over 'model' and sums the bf16 partial products
        # there (read in its compiled train HLO of the internvl2 smoke)
        fsdp = not cfg.pure_fsdp and any(spec_of(p["front"]["w"]))
        fx = nn.linear_apply(p["front"], batch["front"], cfg, k_split=fsdp)
    if cfg.pure_fsdp:
        if fx is not None:
            x = torch.cat([fx.to(x.dtype), x], dim=1)
        x = shard_hint(x, P(("pod", "data"), None, None))
    else:
        x = _sequence_block(x, fx)
    aux_total = 0.0
    for seg, sp in zip(segments_for(cfg), p["segments"]):
        x, aux = _segment_scan(seg, sp, x, cfg, nn.linear_apply, remat,
                               enc_out)
        aux_total = aux_total + aux
    x = nn.rmsnorm_apply(p["final_norm"], x)
    if not cfg.pure_fsdp:
        x = coll.all_gather_ad(x, "model", dim=1)
    if fx is not None:
        x = x[:, -tokens.shape[1]:]
    logits, start = nn.train_logits_apply(p.get("head", p["embed"]), x, cfg)
    logits = shard_hint(logits, P(("pod", "data"), None, "model"))
    loss = next_token_loss(logits, tokens, cfg, start)
    return loss + 0.01 * aux_total, logits[..., :max(cfg.vocab - start, 0)]


@torch.no_grad()
def encode(params, frames, cfg):
    """The encoder of an enc-dec model: frames ``[B, Se, d_front]``
    through the ``front`` projection (the train-path linear, as the
    reference applies it when serving too), the ``enc_attn`` blocks (no
    caches) and ``enc_norm``.  Returns ``[B, Se, d_model]`` bf16."""
    with torch.profiler.record_function("repro_torch.lm.encode"):
        x = nn.linear_apply(params.front.tree(), frames, cfg)
        x = _run_layers(params, None, x, cfg, decode=False, stack="encoder")
        return nn.rmsnorm_apply(params.enc_norm.tree(), x)


@torch.no_grad()
def prefill(params, tokens, cfg, S_max: Optional[int] = None, frames=None,
            front=None):
    """Dense-cache prefill of the oracle loop: tokens ``[B, S]`` from
    position 0 (left-padded by the loop).  Returns ``(logits [B,
    vocab], caches)``, fresh dense caches of ``S_max`` positions holding
    the prompt's K/V (a recurrent block's final state).  An enc-dec
    config needs ``frames [B, Se, d_front]``: they are encoded first and
    each ``dec_cross`` block caches their cross-attention K/V.  A VLM's
    ``front [B, F, d_front]`` (the reference's ``batch['front']``) is
    projected by the frontend's train-path linear, as the reference
    projects it when serving too, and its ``F`` rows go before the token
    embeddings: the cache holds ``F + S`` positions (``S_max`` defaults to
    that) and decoding goes on at position ``F + S``."""
    with torch.profiler.record_function("repro_torch.lm.prefill"):
        B, S = tokens.shape
        dev = params.embed.emb.device
        enc_out = None
        if cfg.n_enc_layers:
            if frames is None:
                raise KeyError("frames: an encoder-decoder config needs "
                               "frames [B, Se, d_front] to prefill")
            enc_out = encode(params, frames, cfg)
        x = nn.embed_apply(params.embed.tree(), tokens)
        if front is not None:
            if cfg.frontend == "none" or cfg.n_enc_layers:
                raise ValueError(f"front: {cfg.name!r} has no VLM frontend "
                                 f"(frontend {cfg.frontend!r})")
            fx = nn.linear_apply(params.front.tree(), front, cfg)
            x = torch.cat([fx.to(x.dtype), x], dim=1)
        S_max = S_max or x.shape[1]
        enc_len = 0 if enc_out is None else enc_out.shape[1]
        mesh = current_mesh()
        if mesh is not None:
            caches = _local_caches(cfg, B, S_max, dev, mesh, enc_len)
        else:
            caches = init_caches(cfg, device=dev, B=B, S_max=S_max,
                                 enc_len=enc_len)
        x = _run_layers(params, caches, x, cfg, decode=False,
                        enc_out=enc_out)
        logits = _logits(params, x[:, -1:], cfg)
    return _vocab_cut(logits[:, 0], cfg), caches


@torch.no_grad()
def decode_step(params, caches, tokens, pos: int, cfg):
    """One dense decode step at the shared position ``pos`` (an int):
    tokens ``[B, 1]``; the dense caches are written in place.  Returns
    ``(logits [B, vocab], caches)``."""
    with torch.profiler.record_function("repro_torch.lm.decode_step"):
        x = nn.embed_apply(params.embed.tree(), tokens)
        x = shard_hint(x, P(("pod", "data"), None, None))
        x = _run_layers(params, caches, x, cfg, decode=True, pos=pos)
        logits = _logits(params, x, cfg)
    return _vocab_cut(logits[:, 0], cfg), caches


def _vocab_cut(logits, cfg):
    """The logits' true vocab columns; under a mesh this rank's block of
    the padded vocab, as it is (padded rows hold -1e30)."""
    return logits if current_mesh() is not None else logits[..., :cfg.vocab]


greedy = nn.greedy   # the next tokens of prefill/decode_step logits


@torch.no_grad()
def prefill_chunk(params, caches, tokens, start, block_table_row, cfg,
                  last=0):
    """One fixed-size prefill chunk: tokens ``[1, C]`` at positions
    ``[start, start + C)`` of the slot whose pages ``block_table_row
    [max_blocks]`` names; ``start`` and ``last`` are 0-d int32 tensors on
    the tokens' device (or ints).  Returns ``(logits [vocab], caches)``:
    the logits of chunk row ``last`` only, picked on the device."""
    with torch.profiler.record_function("repro_torch.lm.prefill_chunk"):
        x = nn.embed_apply(params.embed.tree(), tokens)
        x = shard_hint(x, P(("pod", "data"), None, None))
        ctx = {"block_table": block_table_row, "start": start}
        x = _run_layers(params, caches, x, cfg, decode=False, paged_ctx=ctx)
        last = torch.as_tensor(last, device=x.device)
        logits = _logits(params, x.index_select(1, last.reshape(1).long()),
                         cfg)
    return logits[0, 0, : cfg.vocab], caches


@torch.no_grad()
def cache_copy_page(caches, src: int, dst: int):
    """Copy-on-write: duplicate physical page ``src`` into ``dst`` in
    place across every layer's pool leaf (codes and scale sidecars; the
    leaves are stacked ``[n_layers, n_pages, ...]``).  Returns the
    caches."""
    for seg in caches:
        for pool in seg.values():
            for leaf in pool.values():
                leaf[:, dst] = leaf[:, src]
    return caches


@torch.no_grad()
def cache_swap_out(caches, page_ids):
    """Device side of swap-out: gather the pages ``page_ids [R]`` (a
    fixed-width long tensor on the caches' device) across every layer's
    pool into fresh leaves ``[n_layers, R, P, ...]``, the caches'
    structure (``kernels/paged.swap_out_kv`` per layer)."""
    return [{b: {name: leaf[:, page_ids] for name, leaf in pool.items()}
             for b, pool in seg.items()} for seg in caches]


@torch.no_grad()
def cache_swap_in(caches, staged, page_ids):
    """Device side of swap-in, IN PLACE (the captured forwards hold the
    pools' addresses): scatter ``staged`` leaves ``[n_layers, R, P, ...]``
    (each leaf's bytes, in its dtype or an integer view of the same width)
    into pages ``page_ids [R]`` of every layer's pool.  Padding rows
    target the scratch page.  Returns the caches."""
    for seg, sseg in zip(caches, staged):
        for b, pool in seg.items():
            for name, leaf in pool.items():
                leaf[:, page_ids] = sseg[b][name].view(leaf.dtype)
    return caches


@torch.no_grad()
def decode_step_paged(params, caches, tokens, positions, block_table, cfg):
    """One paged decode step: tokens ``[B, 1]``, ``positions [B]`` int32,
    ``block_table [B, max_blocks]`` int32.  Idle slots carry an all-zero
    block-table row (writes land in the scratch page).  The attention
    reader follows ``cfg.serve_paged_attn_impl``."""
    with torch.profiler.record_function("repro_torch.lm.decode_step_paged"):
        x = nn.embed_apply(params.embed.tree(), tokens)
        x = shard_hint(x, P(("pod", "data"), None, None))
        ctx = {"block_table": block_table, "positions": positions,
               "impl": cfg.serve_paged_attn_impl}
        x = _run_layers(params, caches, x, cfg, decode=True, paged_ctx=ctx)
        logits = _logits(params, x, cfg)
    return logits[:, 0, : cfg.vocab], caches


@torch.no_grad()
def verify_step_paged(params, caches, tokens, positions, n_writes,
                      block_table, cfg):
    """Speculative verify pass: a fixed ``K1``-token window per slot in
    one forward.  tokens ``[B, K1]`` (each slot's current token and its
    draft; row ``j`` at position ``positions[b] + j``), ``positions [B]``
    and ``n_writes [B]`` (real rows per slot; padding rows write to the
    scratch page) int32, ``block_table [B, max_blocks]`` int32, all
    tensors on the params' device.  Returns ``(logits [B, K1, vocab],
    caches)``: row ``j``'s logits are what a sequential decode step after
    accepting rows ``0..j`` gives.  Verify attention has no reader
    choice: it always runs the gather + masked softmax."""
    with torch.profiler.record_function("repro_torch.lm.verify_step_paged"):
        x = nn.embed_apply(params.embed.tree(), tokens)
        x = shard_hint(x, P(("pod", "data"), None, None))
        ctx = {"block_table": block_table, "positions": positions,
               "n_writes": n_writes}
        x = _run_layers(params, caches, x, cfg, decode=True, paged_ctx=ctx)
        logits = _logits(params, x, cfg)
    return logits[:, :, : cfg.vocab], caches
