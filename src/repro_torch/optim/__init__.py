"""Optimizers (adamw / adafactor / sgd) and LR schedules."""

from repro_torch.optim.optimizers import (Optimizer, adafactor, adamw,
                                          make_optimizer, sgd)
from repro_torch.optim.schedules import (constant_lr, cosine_warmup,
                                         make_lr_schedule, rsqrt_warmup)

__all__ = ["Optimizer", "adamw", "adafactor", "sgd", "make_optimizer",
           "constant_lr", "cosine_warmup", "rsqrt_warmup",
           "make_lr_schedule"]
