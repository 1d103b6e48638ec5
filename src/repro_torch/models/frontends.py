"""Modality frontend stubs: precomputed embeddings of the right shapes.

The port's copy of the JAX package's ``models/frontends.py``.
whisper-small and pixtral-12b specify the transformer backbone only; the
mel spectrogram + conv codec and the ViT are stubbed as providers of
embeddings:

  audio:  frame embeddings  [B, T_frames, d_model]   (encoder input)
  vision: patch embeddings  [B, N_patch,  d_model]   (prepended to text)

Drawn from a CPU generator and moved to ``device``, so a seed gives the
same inputs on every device. The dry run's ``*_spec`` functions wait
with the dry run.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig

__all__ = ["audio_frames_stub", "image_patches_stub", "sinusoid"]


def sinusoid(t: int, d: int) -> torch.Tensor:
    """[t, d] float32 positions as whisper's encoder adds them after its
    convs: sin on even dims, cos on odd, ``pos / 10000 ** (2 (i // 2) /
    d)``."""
    pos = torch.arange(t, dtype=torch.float32)[:, None]
    dim = torch.arange(d)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0),
                            (2 * (dim // 2)).float() / d)
    return torch.where(dim % 2 == 0, torch.sin(angle), torch.cos(angle))


def audio_frames_stub(cfg: ModelConfig, gen: torch.Generator, batch: int,
                      n_frames: Optional[int] = None,
                      device="cpu") -> torch.Tensor:
    """Stand-in for mel spectrogram -> conv1d x2 -> frame embeddings:
    Gaussian frames plus the sinusoidal positions, in the config's
    dtype."""
    t = n_frames or cfg.max_source_len
    x = torch.randn((batch, t, cfg.d_model), generator=gen).to(
        cfg.torch_dtype)
    return (x + sinusoid(t, cfg.d_model)[None].to(x.dtype)).to(device)


def image_patches_stub(cfg: ModelConfig, gen: torch.Generator, batch: int,
                       n_patches: Optional[int] = None,
                       device="cpu") -> torch.Tensor:
    """Stand-in for the ViT encoder + multimodal projector output."""
    n = n_patches or cfg.n_image_tokens
    return torch.randn((batch, n, cfg.d_model), generator=gen).to(
        cfg.torch_dtype).to(device)
