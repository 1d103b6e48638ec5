"""Learning-rate schedules: plain functions of the step.

The port's copy of ``repro.optim.schedules``. Each schedule maps a step
(a Python int or an integer tensor) to a float32 0-d CPU tensor,
computed in float32 with the reference's operations in its order, so a
step's rate equals the reference's. The reference's re-export of the
G-OEM rho_t schedule lives in ``repro_torch.core.oem``.
"""

from __future__ import annotations

import math

import torch

__all__ = ["constant_lr", "cosine_warmup", "rsqrt_warmup",
           "make_lr_schedule"]


def _step_f32(step) -> torch.Tensor:
    return torch.as_tensor(step).detach().cpu().to(torch.float32)


def constant_lr(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32)


def cosine_warmup(peak: float, warmup: int, total: int,
                  floor_frac: float = 0.1):
    def fn(step):
        s = _step_f32(step)
        # warmup from peak/warmup (not 0): step 0 must actually update
        warm = peak * torch.clamp((s + 1.0) / max(warmup, 1), max=1.0)
        frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak * (floor_frac + (1 - floor_frac)
                      * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(s < warmup, warm, cos)
    return fn


def rsqrt_warmup(peak: float, warmup: int):
    def fn(step):
        s = _step_f32(step) + 1.0
        decay = (warmup / s) ** 0.5 if warmup else torch.ones(())
        return peak * torch.minimum(s / max(warmup, 1), decay)
    return fn


def make_lr_schedule(kind: str, peak: float, warmup: int = 100,
                     total: int = 1000):
    if kind == "constant":
        return constant_lr(peak)
    if kind == "cosine":
        return cosine_warmup(peak, warmup, total)
    if kind == "rsqrt":
        return rsqrt_warmup(peak, warmup)
    raise ValueError(f"unknown lr schedule {kind!r}")
