"""ResNet-18 with N2UQ quantisation, the paper's own model (§6.1), inference
only (port of ``repro.models.resnet``).

Basic blocks' 3x3 convolutions run quantised and compile to TLMAC;
batch-norm, quantisation functions and skip connections stay float (the
paper keeps them on DSPs); the first conv and the FC head stay
full-precision (the paper offloads them to the host).  The float convs
and the head are plain ``conv2d`` / ``matmul``, as the reference leaves
them to XLA.

Layouts are the reference's at every interface: activations NHWC, conv
weights OIHW; ``_conv`` permutes inside.  Its padding is XLA's SAME (lo =
total // 2), which differs from ``conv2d(padding=1)`` for stride 2.

The lookup path: ``compile_resnet`` compiles every basic-block conv
(G = 3 kernel rows); ``tlmac_conv_forward`` packs the 1x3 windows once
with the bit-plane kernel and runs the three kernel-row lookup GEMMs on
those codes (kernel 3), bit-exact to the integer conv.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.quant import quantizers as Q
from repro_torch.core.tlmac import compile as tlc
from repro_torch.kernels import ops as kops
from repro_torch.kernels.tlmac_fused import narrow_table

STAGES = [(64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2)]  # (ch, blocks, stride)


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    name: str = "resnet18"
    num_classes: int = 1000
    w_bits: int = 3
    a_bits: int = 3
    width: int = 64
    stages: Tuple = tuple(STAGES)
    in_hw: int = 32          # CIFAR-scale default for CPU runs

    @property
    def quant(self):
        return Q.QuantConfig(w_bits=self.w_bits, a_bits=self.a_bits)


def same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial dim: (lo, hi), lo = total // 2."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride=1):
    """NHWC x OIHW -> NHWC, SAME padding as ``lax.conv_general_dilated``."""
    _, H, W, _ = x.shape
    kh, kw = w.shape[2], w.shape[3]
    (ht, hb), (wl, wr) = same_pads(H, kh, stride), same_pads(W, kw, stride)
    xp = F.pad(x.permute(0, 3, 1, 2), (wl, wr, ht, hb))
    return F.conv2d(xp, w, stride=stride).permute(0, 2, 3, 1)


def init_resnet(cfg: ResNetConfig, gen: torch.Generator, device="cuda"):
    """Params as a nested dict (the reference's pytree), drawn from
    ``gen``, which must live on ``device``.  The structure, shapes and
    init scales are the reference's; the numbers differ (another RNG)."""
    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device)

    p = {"stem": {"w": normal(cfg.width, 3, 3, 3) * 0.1}}
    blocks = []
    cin = cfg.width
    for (ch, n, stride) in cfg.stages:
        for b in range(n):
            s = stride if b == 0 else 1
            blk = {
                "conv1": _init_qconv(normal, cin, ch, cfg, device),
                "conv2": _init_qconv(normal, ch, ch, cfg, device),
                "bn1": _init_bn(ch, device),
                "bn2": _init_bn(ch, device),
            }
            if s != 1 or cin != ch:
                blk["down"] = {"w": normal(ch, cin, 1, 1) * 0.1}
            blocks.append(blk)
            cin = ch
    p["blocks"] = blocks
    p["fc"] = {
        "w": normal(cin, cfg.num_classes) * 0.02,
        "b": torch.zeros(cfg.num_classes, dtype=torch.float32, device=device),
    }
    return p


def _init_qconv(normal, cin, cout, cfg, device):
    w = normal(cout, cin, 3, 3) * (1.0 / np.sqrt(9 * cin))
    return {
        "w": w,
        "w_step": Q.lsq_init(w.reshape(-1, 1), cfg.w_bits, per_channel=False),
        "aq": Q.n2uq_act_init(cfg.a_bits, device=device),
    }


def block_strides(cfg: ResNetConfig):
    out = []
    for (ch, n, stride) in cfg.stages:
        for b in range(n):
            out.append(stride if b == 0 else 1)
    return out


def _init_bn(ch, device):
    def f(v):
        return torch.full((ch,), v, dtype=torch.float32, device=device)
    return {"scale": f(1.0), "bias": f(0.0), "mean": f(0.0), "var": f(1.0)}


def _bn(params, x):
    inv = torch.rsqrt(params["var"] + 1e-5) * params["scale"]
    return (x - params["mean"]) * inv + params["bias"]


def _qconv_apply(params, x, cfg, stride=1):
    """Fake-quant conv: N2UQ activations + LSQ weights (forward)."""
    xq = Q.n2uq_act_quant(x, params["aq"], cfg.a_bits)
    wq = Q.lsq_quant(
        params["w"].reshape(-1), params["w_step"], cfg.w_bits
    ).reshape(params["w"].shape)
    return _conv(xq, wq, stride)


def forward(params, x, cfg: ResNetConfig):
    """x [B, H, W, 3] -> logits [B, classes]; the reference's forward
    (inference: no gradients are taken)."""
    h = F.relu(_bn_free(_conv(x, params["stem"]["w"], 1)))
    for blk, stride in zip(params["blocks"], block_strides(cfg)):
        ident = h
        y = _qconv_apply(blk["conv1"], h, cfg.quant, stride)
        y = F.relu(_bn(blk["bn1"], y))
        y = _qconv_apply(blk["conv2"], y, cfg.quant, 1)
        y = _bn(blk["bn2"], y)
        if "down" in blk:
            ident = _conv(ident, blk["down"]["w"], stride)
        h = F.relu(y + ident)
    h = h.mean(dim=(1, 2))
    return h @ params["fc"]["w"] + params["fc"]["b"]


def _bn_free(x):
    m = x.mean(dim=(0, 1, 2))
    v = x.var(dim=(0, 1, 2), correction=0)     # jnp.var: ddof 0
    return (x - m) * torch.rsqrt(v + 1e-5)


# ---------------------------------------------------------------------------
# TLMAC inference path (per-layer compiled plans)
# ---------------------------------------------------------------------------


def quantize_conv_weights(params_conv, cfg: ResNetConfig) -> np.ndarray:
    """Conv params -> integer weight codes [O, I, 3, 3] (numpy)."""
    q = Q.quantize_weights_int(
        params_conv["w"].reshape(-1), cfg.quant, step=params_conv["w_step"],
    )[0]
    return q.cpu().numpy().reshape(tuple(params_conv["w"].shape))


def compile_resnet(params, cfg: ResNetConfig, anneal_iters=2000, seed=0,
                   d_p_channels: int = 64):
    """Compile every basic-block conv to a TLMAC plan (paper Fig. 5/8)."""
    plans = []
    for bi, blk in enumerate(params["blocks"]):
        for name in ("conv1", "conv2"):
            codes = quantize_conv_weights(blk[name], cfg)
            plan = tlc.compile_layer(
                codes, B_w=cfg.w_bits, B_a=cfg.a_bits,
                d_p=min(d_p_channels, codes.shape[0]),
                anneal_iters=anneal_iters, seed=seed + bi,
            )
            plans.append((f"block{bi}.{name}", plan))
    return plans


def conv_windows(a_codes_img: torch.Tensor) -> torch.Tensor:
    """1x3 windows of an NHWC code image with SAME width padding, as
    ``[B*H*W, C*3]`` int8: row (b, y, x), column c*3 + j holds
    ``a[b, y, x + j - 1, c]`` (0 outside the image)."""
    B, H, W, C = a_codes_img.shape
    xp = F.pad(a_codes_img.to(torch.int8), (0, 0, 1, 1))
    win = torch.stack([xp[:, :, j:j + W, :] for j in range(3)], dim=-1)
    return win.reshape(B * H * W, C * 3)


def conv_row_plan(plan, r: int, device):
    """Kernel row ``r`` of a conv plan as a matmul plan on ``device``:
    ``(table, exec_idx [n_otile*C, D_p/3], step_cluster)``; column p =
    oc*3 + r of the conv plan is output channel oc of row r.  The table is
    the narrow rows the lookup kernel reads (``narrow_table``, made on the
    host).  Built once per device and cached on the plan."""
    key = ("conv_row", r, str(torch.device(device)))
    hit = plan.device_cache.get(key)
    if hit is None:
        tkey = ("conv_table", str(torch.device(device)))
        if tkey not in plan.device_cache:
            plan.device_cache[tkey] = narrow_table(
                torch.as_tensor(plan.table)).to(device)
        ex = np.ascontiguousarray(plan.exec_idx[:, r::3])
        hit = (plan.device_cache[tkey], torch.as_tensor(ex, device=device),
               torch.as_tensor(plan.step_cluster, device=device))
        plan.device_cache[key] = hit
    return hit


def tlmac_conv_forward(plan, a_codes_img: torch.Tensor, cfg_quant,
                       stride: int = 1) -> torch.Tensor:
    """Lookup-based integer 3x3 conv, bit-exact, via the conv plan.

    Faithful to the paper's PE dataflow (Fig. 2): each 1xD_k window of
    the input row feeds ALL D_k kernel rows in parallel; the D_k row
    partial sums land in D_k different *output* rows and are combined by
    the partial-sum buffer, here a shift-sum over the row axis.  The
    windows are packed into bit-plane codes once (kernel 4) and the three
    row GEMMs read those codes (kernel 3, ``ops.tlmac_matmul`` with
    ``impl='pallas'`` and ``codes=``); the reference runs the same integer
    function through its ``'xla'`` graph.

    a_codes_img: [B, H, W, C] unsigned int codes.
    Returns int32 [B, Ho, Wo, C_out].
    """
    B, H, W, C = a_codes_img.shape
    win = conv_windows(a_codes_img)
    B_a = cfg_quant.a_bits
    codes = kops.pack_bitplanes(win, B_a, 3, impl="pallas")
    n_otile = plan.D_s // C
    dp_ch = plan.D_p // 3
    rows = []
    for r in range(3):
        table, ex, cl = conv_row_plan(plan, r, win.device)
        rows.append(kops.tlmac_matmul(
            win, table, ex, cl, B_a=B_a, G=3, N=n_otile * dp_ch,
            impl="pallas", codes=codes,
        ).reshape(B, H, W, n_otile * dp_ch))
    return combine_row_sums(rows, stride)


def combine_row_sums(rows, stride: int = 1) -> torch.Tensor:
    """The partial-sum buffer: the three kernel rows' full-resolution row
    sums ``[B, H, W, C_out]`` shifted onto their output rows and added,
    then subsampled for a strided conv."""
    _, H, W, _ = rows[0].shape
    # kernel row r applies to input row y = y_out + r - 1 (SAME pad)
    acc = (F.pad(rows[0], (0, 0, 0, 0, 1, 0))[:, :H] + rows[1]
           + F.pad(rows[2], (0, 0, 0, 0, 0, 1))[:, 1:])
    if stride == 1:
        return acc
    # XLA SAME with stride pads asymmetrically (lo = total//2); the
    # full-resolution row sums assumed symmetric pad 1, so subsample at
    # the offset that aligns window centres with the strided conv's
    def off(n):
        return 1 - same_pads(n, 3, stride)[0]
    return acc[:, off(H)::stride, off(W)::stride, :]


def tlmac_conv_check(plan, a_img_codes, w_codes):
    """Bit-exactness check of the conv plan against a direct int conv:
    every probed (step, output) MAC over random bit patterns."""
    rng = np.random.default_rng(0)
    G = plan.G
    ok = True
    for _ in range(64):
        s = rng.integers(plan.D_s)
        p = rng.integers(plan.D_p)
        code = int(rng.integers(2**G))
        mac = plan.table[plan.step_cluster[s], plan.exec_idx[s, p], code]
        w = plan.codebook[plan.idx[s, p]]
        bits = [(code >> g) & 1 for g in range(G)]
        ref = int(sum(b * int(wg) for b, wg in zip(bits, w)))
        ok &= int(mac) == ref
    return ok
