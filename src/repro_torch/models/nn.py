"""NN primitives of the serve path (port of the serve subset of
``repro.models.nn``): TLMAC serve linears, norms, embeddings, rotary.

Parameters travel as nested dicts of tensors, like the JAX pytrees;
``ParamTree`` holds such a tree as an ``nn.Module`` (float leaves are
frozen ``Parameter``s, integer plan arrays are buffers)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.core.tlmac.compile import plan_shapes
from repro_torch.kernels import ops as kops
from repro_torch.kernels.tlmac_fused import narrow_table

COMPUTE_DTYPE = torch.bfloat16
MODEL_AXIS = 16  # the JAX package's 'model' mesh axis; fixes dp choices


class ParamTree(nn.Module):
    """A nested dict (and list) of tensors held as a module.  ``tree()``
    returns the nested dict of tensors; ``layers(si)`` returns the
    per-layer views of stacked segment ``si``, cached until the module
    moves."""

    def __init__(self, tree):
        super().__init__()
        self._kinds = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
                self._kinds[k] = "tree"
            elif isinstance(v, (list, tuple)):
                self.add_module(k, nn.ModuleList(ParamTree(x) for x in v))
                self._kinds[k] = "list"
            elif torch.is_floating_point(v):
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))
                self._kinds[k] = "leaf"
            else:
                self.register_buffer(k, v)
                self._kinds[k] = "leaf"
        self._views = {}

    def tree(self) -> dict:
        out = {}
        for k, kind in self._kinds.items():
            v = getattr(self, k)
            if kind == "tree":
                out[k] = v.tree()
            elif kind == "list":
                out[k] = [x.tree() for x in v]
            else:
                out[k] = v
        return out

    def layers(self, si: int):
        """Per-layer views of stacked segment ``si`` (``segments[si]``)."""
        views = self._views.get(si)
        if views is None:
            seg = self.segments[si].tree()
            n = _leading(seg)
            views = [tree_index(seg, i) for i in range(n)]
            self._views[si] = views
        return views

    def _apply(self, fn, *args, **kwargs):
        self._views = {}
        return super()._apply(fn, *args, **kwargs)


def _leading(tree) -> int:
    for v in tree.values():
        return _leading(v) if isinstance(v, dict) else v.shape[0]
    raise ValueError("empty tree")


def tree_index(tree, i: int):
    """``jax.tree.map(lambda c: c[i], tree)`` over nested dicts."""
    return {k: tree_index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _pick_dp(N: int, want: int) -> int:
    """Largest dp <= want dividing N with N/dp divisible by the model
    axis (the JAX package's choice, so plan shapes match it)."""
    best = None
    for dp in range(min(want, N), 0, -1):
        if N % dp == 0:
            if (N // dp) % MODEL_AXIS == 0:
                return dp
            if best is None:
                best = dp
    return best or min(want, N)


def init_serve_linear(gen: torch.Generator, K: int, N: int, cfg,
                      use_bias: bool = False, device="cuda") -> dict:
    """TLMAC serve-linear params at the plan's capacity shapes, drawn
    from ``gen`` (which must live on ``device``): int32 tables, uint8
    (N_arr <= 256) or int16 indices, int8 step clusters, and the table's
    narrow rows (``table_narrow``) that the lookup kernel reads."""
    if cfg.serve_impl != "tlmac":
        raise ValueError(f"serve_impl {cfg.serve_impl!r} is not ported")
    G, dp = cfg.tlmac_G, _pick_dp(N, cfg.tlmac_dp)
    ps = plan_shapes(K, N, G, cfg.quant.w_bits, n_arr_cap=cfg.tlmac_narr_cap,
                     d_p=dp)
    n_tiles, kg = N // dp, K // G
    idx_dtype = torch.uint8 if ps["N_arr"] <= 256 else torch.int16
    kw = dict(generator=gen, device=device)
    p = {
        "table": torch.randint(-8, 8, ps["table"][0], dtype=torch.int32, **kw),
        "exec_idx": torch.randint(0, ps["N_arr"], (n_tiles, kg, dp),
                                  dtype=idx_dtype, **kw),
        "step_cluster": torch.randint(0, ps["N_clus"], (n_tiles, kg),
                                      dtype=torch.int8, **kw),
        "w_step": torch.ones(N, dtype=torch.float32, device=device),
        "a_step": torch.ones((), dtype=torch.float32, device=device),
    }
    p["table_narrow"] = narrow_table(p["table"])
    if use_bias:
        p["b"] = torch.zeros(N, dtype=torch.bfloat16, device=device)
    return p


def _tlmac_quant_pack(a_step, x, cfg):
    """Quantise activations to B_a-bit codes ``[M, K]`` int8 (round half
    to even, as ``jnp.round``).  The kernel packs bit-planes itself."""
    B_a = cfg.quant.a_bits
    K = x.shape[-1]
    return torch.clamp(torch.round(x.to(torch.float32) / a_step),
                       0, 2**B_a - 1).to(torch.int8).reshape(-1, K)


def _tlmac_gemm(params, aq, lead, cfg):
    """One fused lookup GEMM from quantised activations, dequantised to
    bf16.  Reads ``table_narrow`` where the params carry it (made once
    with them); a bare int32 ``table`` serves the CPU's plain version and
    is refused by the kernel."""
    n_tiles, kg, dp = params["exec_idx"].shape
    N = n_tiles * dp
    table = params.get("table_narrow", params["table"])
    yi = kops.tlmac_matmul(aq, table, params["exec_idx"],
                           params["step_cluster"], B_a=cfg.quant.a_bits,
                           G=cfg.tlmac_G, N=N, impl="fused")
    y = (yi.to(torch.float32) * (params["a_step"] * params["w_step"])).to(
        COMPUTE_DTYPE)
    return y.reshape(*lead, N)


def serve_linear_apply(params, x, cfg, use_bias: bool = False):
    """Serve-path forward ``[..., K] -> [..., N]`` (TLMAC params only)."""
    if "table" not in params:
        raise ValueError("only TLMAC serve linears are ported")
    aq = _tlmac_quant_pack(params["a_step"], x, cfg)
    y = _tlmac_gemm(params, aq, x.shape[:-1], cfg)
    if use_bias:
        y = y + params["b"].to(y.dtype)
    return y


def serve_linear_pair_apply(p1, p2, x, cfg):
    """Two TLMAC linears reading the same tensor (swiglu wi/wg): one
    activation quantisation on the first branch's ``a_step`` feeds both
    lookup GEMMs."""
    aq = _tlmac_quant_pack(p1["a_step"], x, cfg)
    lead = x.shape[:-1]
    y1 = _tlmac_gemm(p1, aq, lead, cfg)
    y2 = _tlmac_gemm(dict(p2, a_step=p1["a_step"]), aq, lead, cfg)
    return y1, y2


serve_linear_apply.pair_apply = serve_linear_pair_apply


# ---------------------------------------------------------------------------
# Norms / embeddings / rotary
# ---------------------------------------------------------------------------


def rmsnorm_apply(params, x, eps: float = 1e-6):
    x32 = x.to(torch.float32)
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps) * params["scale"]
    return y.to(x.dtype)


def padded_vocab(vocab: int) -> int:
    return vocab + (-vocab) % MODEL_AXIS


def embed_apply(params, tokens):
    return params["emb"][tokens.long()].to(COMPUTE_DTYPE)


def logits_apply(params, x, vocab: Optional[int] = None):
    """Logits in bf16; padded vocab rows masked to -1e30."""
    lg = torch.matmul(x.to(COMPUTE_DTYPE), params["emb"].to(COMPUTE_DTYPE).T)
    if vocab is not None and lg.shape[-1] != vocab:
        iota = torch.arange(lg.shape[-1], device=lg.device)
        lg = torch.where(iota < vocab, lg,
                         torch.full_like(lg, -1e30))
    return lg


def rotary_embedding(positions, dim: int, base: float = 10000.0):
    """Returns (sin, cos) ``[..., dim/2]`` in f32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv = 1.0 / torch.pow(torch.tensor(base, dtype=torch.float32,
                                       device=positions.device), exps)
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.sin(ang), torch.cos(ang)


def apply_rotary(x, sin, cos):
    """x ``[..., S, H, hd]``; sin/cos ``[..., S, hd/2]`` broadcast over heads."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    s, c = sin[..., None, :], cos[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def act_fn(kind: str):
    return {"gelu": nn.functional.gelu, "silu": nn.functional.silu,
            "relu": nn.functional.relu}["silu" if kind == "swiglu" else kind]


def init_embedding(gen: torch.Generator, vocab: int, d: int, device="cuda"):
    """Embedding drawn N(0, 0.02^2) in f32 and stored in bf16: every use
    casts it to bf16 first, so storing bf16 loses nothing."""
    emb = torch.randn((padded_vocab(vocab), d), generator=gen,
                      dtype=torch.float32, device=device) * 0.02
    return {"emb": emb.to(torch.bfloat16)}


def init_rmsnorm(d: int, device="cuda"):
    return {"scale": torch.ones(d, dtype=torch.float32, device=device)}

