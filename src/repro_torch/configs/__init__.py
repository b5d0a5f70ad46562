from repro_torch.configs.base import (ArchConfig, QuantConfig, get_config,
                                     smoke_config)

__all__ = ["ArchConfig", "QuantConfig", "get_config", "smoke_config"]
