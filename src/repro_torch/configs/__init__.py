from repro_torch.configs.base import (SHAPE_CELLS, EncoderConfig, MLAConfig,
                                      ModelConfig, MoEConfig, RGLRUConfig,
                                      ShapeCell, SSMConfig, VisionConfig,
                                      cells_for)
from repro_torch.configs.registry import (ARCH_IDS, PORTED, get_config,
                                          get_smoke_config)

__all__ = ["ARCH_IDS", "EncoderConfig", "MLAConfig", "ModelConfig",
           "MoEConfig", "PORTED", "RGLRUConfig", "SHAPE_CELLS", "SSMConfig",
           "ShapeCell", "VisionConfig", "cells_for", "get_config",
           "get_smoke_config"]
