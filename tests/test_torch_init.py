"""``lm.init_lm`` fills each stacked leaf ``[n_layers, ...]`` layer by layer
(``lm.init_segment``): the same tree, bit for bit, as drawing every layer
and stacking them with ``torch.stack`` from the same generator, at a peak
of the params' bytes plus at most one layer's, where stacking holds the
layers and their stack together (about twice the linears' bytes).

Peak bytes are counted exactly on the CPU by ``LiveBytes``: a dispatch
mode that adds every new storage an op returns and subtracts it when the
storage is freed."""

import dataclasses
import weakref

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import smoke_config
from repro_torch.models import lm, nn


class LiveBytes(TorchDispatchMode):
    """Running and peak bytes of the storages that ops create inside the
    mode and that are still alive."""

    def __init__(self):
        super().__init__()
        self.live, self.cur, self.peak = {}, 0, 0

    def _drop(self, key):
        self.cur -= self.live.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                key = st.data_ptr()
                if st.nbytes() and key not in self.live:
                    self.live[key] = st.nbytes()
                    self.cur += st.nbytes()
                    self.peak = max(self.peak, self.cur)
                    weakref.finalize(st, self._drop, key)
        return out


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0])


def _stacked(gen, cfg):
    """The former init: every layer drawn, then ``torch.stack``."""
    p = {"embed": nn.init_embedding(gen, cfg.vocab, cfg.d_model, "cpu")}
    if not cfg.tie_embeddings:
        p["head"] = nn.init_embedding(gen, cfg.vocab, cfg.d_model, "cpu")
    if cfg.frontend != "none":
        p["front"] = lm.init_front(gen, cfg, "cpu")
    p["final_norm"] = nn.init_rmsnorm(cfg.d_model, "cpu")

    def stack(trees):
        return {k: stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
                else torch.stack([t[k] for t in trees]) for k in trees[0]}

    p["segments"] = [
        stack([{f"b{bi}": lm.init_block(gen, kind, cfg, "cpu")
                for bi, kind in enumerate(seg.pattern)}
               for _ in range(seg.n)])
        for seg in lm.segments_for(cfg)]
    return p


CASES = {
    "command-r tlmac": dataclasses.replace(smoke_config("command-r-35b"),
                                           n_layers=6),
    "internvl2 int8": dataclasses.replace(smoke_config("internvl2-76b"),
                                          n_layers=4, serve_impl="int8"),
    "minicpm dense": dataclasses.replace(smoke_config("minicpm-2b"),
                                         n_layers=5, serve_impl="dense"),
    "deepseek moe tlmac": dataclasses.replace(
        smoke_config("deepseek-v3-671b"), attn_kind="gqa", n_layers=5),
    "window hybrid": dataclasses.replace(
        smoke_config("codeqwen1.5-7b"), family="hybrid", n_layers=5,
        block_pattern=("attn_local", "attn")),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_init_lm_equals_the_stacked_draw(name):
    cfg = CASES[name]
    got = lm.init_lm(cfg, torch.Generator().manual_seed(3),
                     device="cpu").tree()
    want = _stacked(torch.Generator().manual_seed(3), cfg)
    flat_g, spec_g = tree_flatten(got)
    flat_w, spec_w = tree_flatten(want)
    assert spec_g == spec_w
    for g, w in zip(flat_g, flat_w):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", sorted(set(CASES) - {"deepseek moe tlmac"}))
def test_init_lm_peak_is_the_params_plus_one_layer(name):
    cfg = CASES[name]
    mode = LiveBytes()
    with mode:
        params = lm.init_lm(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    tree = params.tree()
    final = _nbytes(tree)
    segs = lm.segments_for(cfg)
    layer = max(_nbytes(s) // seg.n for s, seg in zip(tree["segments"], segs))
    assert mode.cur == final            # nothing else is left alive
    assert mode.peak <= final + layer, (mode.peak, final, layer)
    # the former init held every layer and the stack at once
    old = LiveBytes()
    with old:
        _stacked(torch.Generator().manual_seed(0), cfg)
    seg_bytes = sum(_nbytes(s) for s in tree["segments"])
    assert old.peak >= final + seg_bytes - layer


def test_init_lm_peak_of_a_moe_model_is_the_params_plus_one_layer():
    """Expert-stacked leaves ``[E, ...]`` are allocated once in their
    stored dtypes and drawn expert by expert: the peak is the params plus
    one (MoE) layer."""
    cfg = CASES["deepseek moe tlmac"]
    mode = LiveBytes()
    with mode:
        params = lm.init_lm(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    tree = params.tree()
    final = _nbytes(tree)
    segs = lm.segments_for(cfg)
    layer = max(_nbytes(s) // seg.n for s, seg in zip(tree["segments"], segs))
    assert layer == _nbytes(tree["segments"][1]) // 3     # an attn_moe layer
    assert mode.cur == final
    assert mode.peak <= final + layer, (mode.peak, final, layer)
