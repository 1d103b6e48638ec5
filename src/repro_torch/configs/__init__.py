"""Model configurations of the LM scaffold: the dense archs ported so far."""

from repro_torch.configs.base import (ModelConfig, get_config, list_archs,
                                      smoke_variant)

__all__ = ["ModelConfig", "get_config", "list_archs", "smoke_variant"]
