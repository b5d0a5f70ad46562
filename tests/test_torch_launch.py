"""The port's serving CLI (``repro_torch.launch.serve``) and the serve
forwards of every LLM architecture the port lists, on the CPU at smoke
size: the counterparts of ``tests/test_models_smoke.py``'s
``test_serve_prefill_decode`` and ``test_decode_matches_prefill_continuation``
(the port's own seeded init; the parity with the JAX package is in the
family files).
"""

import numpy as np
import pytest
import torch

from repro.configs import list_archs

from repro_torch.configs import smoke_config
from repro_torch.configs.base import _ALIASES
from repro_torch.launch import serve as cli
from repro_torch.models import lm

import _torch_families  # noqa: F401  (one torch thread per worker)

ARCHS = sorted(_ALIASES)
# MoE forwards group tokens for capacity: a prefill of S+1 groups
# differently from prefill S + one decode step (capacity drops), as in the
# reference, so the continuation check covers the other families
MOE = ("deepseek-v3-671b", "kimi-k2-1t-a32b")
CONT_TOL = 2e-2      # the reference's rtol = atol of the continuation check


def test_every_reference_llm_arch_is_listed():
    """The reference lists module names; the port's aliases map onto
    them."""
    assert {_ALIASES[a] for a in ARCHS} == {
        a for a in list_archs() if a != "resnet18"}


def _prefill(arch, S, seed=3):
    cfg = smoke_config(arch)
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (2, S), generator=g)
    kw = ({"frames": torch.randn((2, 12, 1024), generator=g)}
          if cfg.n_enc_layers else {})
    return cfg, params, toks, kw


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_prefill_decode(arch):
    cfg, params, toks, kw = _prefill(arch, 16)
    logits, caches = lm.prefill(params, toks, cfg, S_max=32, **kw)
    assert logits.shape == (2, cfg.vocab)
    tok = logits.argmax(-1)[:, None]
    lg, caches = lm.decode_step(params, caches, tok, 16, cfg)
    assert lg.shape == (2, cfg.vocab)
    assert bool(torch.isfinite(lg.float()).all())


@pytest.mark.parametrize("arch", [a for a in ARCHS if a not in MOE])
def test_decode_continues_prefill(arch):
    """prefill(S) then one decode step against prefill(S + 1)."""
    cfg, params, toks, kw = _prefill(arch, 17)
    _, caches = lm.prefill(params, toks[:, :16], cfg, S_max=32, **kw)
    lg_b, _ = lm.decode_step(params, caches, toks[:, 16:17], 16, cfg)
    lg_full, _ = lm.prefill(params, toks, cfg, S_max=32, **kw)
    np.testing.assert_allclose(lg_b.float().numpy(), lg_full.float().numpy(),
                               rtol=CONT_TOL, atol=CONT_TOL)


def test_serve_cli_smoke_on_cpu(capsys):
    done = cli.main(["--arch", "xlstm-350m", "--smoke", "--device", "cpu",
                     "--requests", "5", "--max-new", "6", "--slots", "2"])
    assert sorted(r.rid for r in done) == list(range(5))
    for r in done:
        assert len(r.output) == 6
        assert 0 <= int(r.output.min()) and int(r.output.max()) < 256
    out = capsys.readouterr().out
    assert "served 5 requests, 30 tokens" in out and "device=cpu" in out


def test_serve_cli_refuses_enc_dec_like_the_reference():
    with pytest.raises(ValueError, match="encoder-decoder"):
        cli.main(["--arch", "seamless-m4t-medium", "--smoke", "--device",
                  "cpu", "--requests", "1"])
