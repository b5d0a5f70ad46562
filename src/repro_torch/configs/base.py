"""Architecture configuration: the subset of ``repro.configs.base`` that
the paged TLMAC serve path reads.

``QuantConfig`` is a copy of ``repro.core.quant.quantizers.QuantConfig``
(that module imports JAX, so the port keeps its own)."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static quantisation configuration for one layer family."""

    w_bits: int = 3
    a_bits: int = 3
    per_channel: bool = True
    method: str = "n2uq"

    @property
    def w_qmax(self) -> int:
        return 2 ** (self.w_bits - 1) - 1

    @property
    def w_qmin(self) -> int:
        return -(2 ** (self.w_bits - 1))

    @property
    def a_qmax(self) -> int:
        return 2**self.a_bits - 1


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # only 'dense' is served by this package
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    act: str = "swiglu"
    tie_embeddings: bool = False
    qkv_bias: bool = False
    # --- quantisation (the paper's technique) ---
    quant: QuantConfig = QuantConfig(w_bits=3, a_bits=3)
    tlmac_G: int = 4
    tlmac_dp: int = 128
    tlmac_narr_cap: int = 4096   # LUT-pool capacity budget for plan shapes
    serve_impl: str = "tlmac"    # only 'tlmac' is served by this package
    serve_kv_dtype: str = "fp"   # paged KV pool dtype: fp | int8 | int4
    serve_shared_act_quant: bool = True  # swiglu wi/wg share wi's a_step

    @property
    def kv_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


_ALIASES = {
    "codeqwen1.5-7b": "codeqwen15_7b",
    "mistral-large-123b": "mistral_large_123b",
}


def _module(name: str):
    mod_name = _ALIASES.get(name, name).replace("-", "_")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def smoke_config(name: str) -> ArchConfig:
    """Reduced same-family config for CPU tests."""
    return _module(name).SMOKE
