"""Architecture configs.  ``get_config(name)`` resolves a ported arch."""
from repro_torch.configs.base import (ARCH_NAMES, PORTED_ARCHS, SHAPES,
                                      ArchConfig, ShapeSpec, get_config,
                                      input_specs)

__all__ = ["ARCH_NAMES", "PORTED_ARCHS", "SHAPES", "ArchConfig", "ShapeSpec",
           "get_config", "input_specs"]
