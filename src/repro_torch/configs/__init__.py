from repro_torch.configs.base import (SHAPES, ArchConfig, QuantConfig,
                                     ShapeConfig, get_config, list_archs,
                                     smoke_config)

__all__ = ["ArchConfig", "QuantConfig", "SHAPES", "ShapeConfig",
           "get_config", "list_archs", "smoke_config"]
