"""Shared layers: norms, RoPE, gated MLP, embeddings, initializers.

The port's copy of the JAX package's ``models/layers.py``. Parameters are
plain dicts of tensors with the reference's names and layouts (``wq``
is ``[d, H, head_dim]``, a table ``[vocab, d]``), so a reference pytree
converts leaf by leaf. Norms and RoPE compute in float32 whatever the
parameter dtype, and cast back, as the reference does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["trunc_normal", "init_rmsnorm", "apply_rmsnorm",
           "init_layernorm", "apply_layernorm", "apply_rope", "init_mlp",
           "apply_mlp", "activation", "init_embedding", "apply_embedding",
           "apply_unembed", "softcap"]


def trunc_normal(gen: torch.Generator, shape, dtype,
                 fan_in: Optional[int] = None,
                 scale: float = 1.0) -> torch.Tensor:
    """Truncated-normal init with 1/sqrt(fan_in) scaling (lecun-style).

    A standard normal cut at +-2 (inverse CDF of a uniform draw between
    the cut points, from ``gen``, on ``gen``'s device), times
    ``scale / sqrt(fan_in)``. The same law as the reference's
    ``jax.random.truncated_normal(key, -2, 2)``; not the same bits.
    """
    fan = fan_in if fan_in is not None else shape[0]
    std = scale / max(float(fan), 1.0) ** 0.5
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.empty(shape, dtype=torch.float32, device=gen.device)
    u.uniform_(lo, hi, generator=gen)
    x = u.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    return x.mul_(std).to(dtype)


# ----------------------------------------------------------------------------
# Norms
# ----------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype, device) -> dict:
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def apply_rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6
                  ) -> torch.Tensor:
    """Gemma-style RMSNorm, ``x / rms(x) * (1 + scale)`` in float32."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + p["scale"].float())).to(x.dtype)


def init_layernorm(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def apply_layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5
                    ) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


# ----------------------------------------------------------------------------
# Rotary position embedding
# ----------------------------------------------------------------------------

def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x [B, S, H, D] (D even), positions [B, S] integer.

    The split-halves convention: the first and second halves of D are
    the two coordinates of each rotated pair.
    """
    d_half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(d_half, dtype=torch.float32,
                                   device=x.device) / d_half)
    ang = positions[..., None].float() * freq                 # [B, S, D/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# Gated MLP (SwiGLU/GeGLU)
# ----------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d: int, d_ff: int, dtype) -> dict:
    return {
        "w_gate": trunc_normal(gen, (d, d_ff), dtype, fan_in=d),
        "w_up": trunc_normal(gen, (d, d_ff), dtype, fan_in=d),
        "w_down": trunc_normal(gen, (d_ff, d), dtype, fan_in=d_ff),
    }


def activation(act: str):
    """silu, or gelu in its tanh form (the reference's approximate=True)."""
    if act == "silu":
        return F.silu
    return lambda v: F.gelu(v, approximate="tanh")


def apply_mlp(p: dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    gate = x @ p["w_gate"]
    up = x @ p["w_up"]
    return (activation(act)(gate) * up) @ p["w_down"]


# ----------------------------------------------------------------------------
# Embedding / unembedding
# ----------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, vocab: int, d: int, dtype) -> dict:
    # std 1/sqrt(d): forward embeds are rescaled by sqrt(d) (unit variance)
    # while tied-head logits x @ table^T stay O(1).
    return {"table": trunc_normal(gen, (vocab, d), dtype, fan_in=d)}


def apply_embedding(p: dict, tokens: torch.Tensor,
                    scale_by_sqrt_d: bool = True) -> torch.Tensor:
    emb = p["table"][tokens]
    if scale_by_sqrt_d:
        emb = emb * float(p["table"].shape[1]) ** 0.5
    return emb


def apply_unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: logits = x @ table^T."""
    return x @ p["table"].t()


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)
