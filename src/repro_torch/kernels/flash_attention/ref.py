"""Plain torch version of the flash_attention kernel.

Dense softmax attention in the reference's ``[BH, S, D]`` layout
(``repro.kernels.flash_attention.ref.attention_ref``): the same scale,
softcap, causal and window masks, ``q_offset`` for queries that sit
past the first key (decode), float32 scores and a fully masked row
giving 0. The wrapper in ``ops.py`` runs it for CPU tensors;
``chip_smoke.py`` and the GPU tests hold the CUDA kernel against it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["attention_ref"]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  scale: Optional[float] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """Dense softmax attention. q [BH, Sq, D], k/v [BKV, Sk, D]."""
    bh, sq, d = q.shape
    bkv, sk, _ = k.shape
    group = bh // bkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)

    k = k.repeat_interleave(group, dim=0)
    v = v.repeat_interleave(group, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)

    rows = q_offset + torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= rows >= cols
    if window is not None:
        mask &= (rows - cols) < window
    s = s.masked_fill(~mask[None], -math.inf)
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)          # fully masked rows -> 0
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
