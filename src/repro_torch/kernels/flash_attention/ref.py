"""Plain torch version of the flash_attention kernel.

Dense softmax attention in the reference's ``[BH, S, D]`` layout
(``repro.kernels.flash_attention.ref.attention_ref``): the same scale,
softcap, causal and window masks, ``q_offset`` for queries that sit
past the first key (decode), float32 scores and a fully masked row
giving 0. The wrapper in ``ops.py`` runs it for CPU tensors;
``chip_smoke.py`` and the GPU tests hold the CUDA kernel against it.

:func:`attention_bwd` is the gradient of that function, in torch ops on
every device. The reference trains through XLA einsums and has no
backward kernel; this recomputes the float32 scores as its autodiff
does (mask, softcap derivative ``1 - tanh**2``, scale, and the GQA group
summed for dK and dV).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["attention_ref", "attention_bwd"]


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


def _mask(sq: int, sk: int, causal: bool, window: Optional[int],
          q_offset: int, device) -> torch.Tensor:
    rows = q_offset + torch.arange(sq, device=device)[:, None]
    cols = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= rows >= cols
    if window is not None:
        mask &= (rows - cols) < window
    return mask


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  dout: torch.Tensor, *, causal: bool = True,
                  window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  scale: Optional[float] = None, q_offset: int = 0
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dQ, dK, dV of the attention at q [B, Sq, H, D], k/v [B, Sk, Hkv,
    D] for the output gradient ``dout`` [B, Sq, H, D], each in its
    input's dtype. Float32 throughout: scores, probabilities and the
    products."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)

    def grouped(x):          # [B, S, H, D] -> [B, Hkv, G, S, D]
        return x.float().reshape(b, x.shape[1], hkv, g, d).permute(
            0, 2, 3, 1, 4)

    qf, do = grouped(q), grouped(dout)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]       # [B, Hkv, 1, Sk, D]
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale    # [B, Hkv, G, Sq, Sk]
    t = None
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s = softcap * t
    mask = _mask(sq, sk, causal, window, q_offset, q.device)
    p = torch.softmax(s.masked_fill(~mask, -math.inf), dim=-1)
    p = torch.nan_to_num(p, nan=0.0)          # fully masked rows -> 0
    dv = torch.matmul(p.transpose(-1, -2), do).sum(2)     # [B, Hkv, Sk, D]
    dp = torch.matmul(do, vf.transpose(-1, -2))
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    if t is not None:
        ds = ds * (1.0 - t * t)
    ds = ds * scale
    dq = torch.matmul(ds, kf)                              # [B, Hkv, G, Sq, D]
    dk = torch.matmul(ds.transpose(-1, -2), qf).sum(2)     # [B, Hkv, Sk, D]
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)
    return (dq.to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))
