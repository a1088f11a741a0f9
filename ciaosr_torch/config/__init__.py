"""Config files and registries (counterpart of ciaosr_tpu/config)."""

from ciaosr_torch.config.config import Config, ConfigDict
from ciaosr_torch.config.registry import (COMPONENTS, DATASETS, LOSSES,
                                          MODELS, PIPELINES, Registry,
                                          build_from_cfg)

__all__ = ["Config", "ConfigDict", "COMPONENTS", "DATASETS", "LOSSES",
           "MODELS", "PIPELINES", "Registry", "build_from_cfg"]
