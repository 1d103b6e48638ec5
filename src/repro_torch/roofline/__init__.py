"""Roofline analysis of one step from its dispatch counts (H100 model)."""

from repro_torch.roofline.counters import (COLLECTIVE_KINDS, StepCounter,
                                           attention_bytes,
                                           attention_flops,
                                           collective_kind)
from repro_torch.roofline.model import (H100, HW, RooflineReport, analyze,
                                        model_flops)

__all__ = ["COLLECTIVE_KINDS", "StepCounter", "attention_bytes",
           "attention_flops",
           "collective_kind", "H100", "HW", "RooflineReport", "analyze",
           "model_flops"]
