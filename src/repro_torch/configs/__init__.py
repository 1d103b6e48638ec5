"""Model configurations of the LM scaffold: the reference's ten archs."""

from repro_torch.configs.base import (ModelConfig, get_config, list_archs,
                                      smoke_variant)

__all__ = ["ModelConfig", "get_config", "list_archs", "smoke_variant"]
