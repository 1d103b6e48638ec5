"""Wrapper of the flash_attention CUDA kernel, dispatched by the device.

The ``[B, S, H, D]`` API of the reference's ``ops.flash_attention``. A
CUDA tensor launches ``csrc/flash_attention.cu`` (or raises); a CPU
tensor runs the plain version in ``ref.py``. The kernel masks keys past
``Sk`` itself, so nothing is padded, and it reads each query head's KV
head in place, so nothing is transposed or repeated. ``launches`` counts
kernel launches and nothing else; ``launches_by_shape`` counts them by
``(B, Sq, Sk, H, Hkv, D, dtype, "local" | "global", softcap)``
(``q_offset`` is not part of the key).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import common
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["flash_attention", "shape_key", "GLOBAL_WINDOW", "HEAD_DIMS",
           "launches", "launches_by_shape"]

GLOBAL_WINDOW = 1 << 30     # a window this wide masks nothing: "global"
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
launches = 0
launches_by_shape: dict[tuple, int] = {}


def shape_key(q: torch.Tensor, k: torch.Tensor, window: Optional[int],
              softcap: Optional[float]) -> tuple:
    """The key a launch is counted under in ``launches_by_shape``."""
    b, sq, h, d = q.shape
    local = window is not None and window < GLOBAL_WINDOW
    return (b, sq, k.shape[1], h, k.shape[2], d,
            _DTYPES.get(q.dtype, str(q.dtype)),
            "local" if local else "global", softcap)


def _launch(q, k, v, causal, window, softcap, scale, q_offset):
    global launches
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    common.require_cuda("flash_attention", q, k, v)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: want q, k, v all bfloat16 or "
                         f"all float32, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    if b * h > 65535:
        raise ValueError(f"flash_attention: B*H = {b * h} > 65535")
    if q_offset < 0 or q_offset + sq >= GLOBAL_WINDOW or sk >= GLOBAL_WINDOW:
        raise ValueError(f"flash_attention: positions and Sk must lie in "
                         f"[0, {GLOBAL_WINDOW}), got q_offset={q_offset}, "
                         f"Sq={sq}, Sk={sk}")
    out = torch.empty_like(q)
    if sq == 0:
        return out
    lib = common.load("flash_attention")
    ptr = ctypes.c_void_p
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            ptr(q.data_ptr()), ptr(k.data_ptr()), ptr(v.data_ptr()),
            ptr(out.data_ptr()), ctypes.c_int(b), ctypes.c_int(sq),
            ctypes.c_int(sk), ctypes.c_int(h), ctypes.c_int(hkv),
            ctypes.c_int(d), ctypes.c_int(q_offset),
            ctypes.c_int(min(window, GLOBAL_WINDOW)), ctypes.c_int(causal),
            ctypes.c_float(scale), ctypes.c_float(softcap or 0.0),
            ctypes.c_int(q.dtype == torch.bfloat16),
            ptr(common.stream_ptr()))
    common.check(err, "flash_attention")
    launches += 1
    key = shape_key(q, k, window, softcap)
    launches_by_shape[key] = launches_by_shape.get(key, 0) + 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Multi-head attention. q [B, Sq, H, D]; k, v [B, Sk, H_kv, D].

    Returns [B, Sq, H, D] in q's dtype. Query i sits at absolute
    position ``q_offset + i`` (decode: the cache index). ``window=None``
    or at least ``GLOBAL_WINDOW`` masks nothing; ``softcap`` (> 0) caps
    the scaled logits by ``softcap * tanh(s / softcap)``; ``scale``
    defaults to ``D ** -0.5``.
    """
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"query heads {h} not a multiple of kv "
                         f"{k.shape[2]}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention: softcap must be > 0, got "
                         f"{softcap}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        def bh(x):
            return x.transpose(1, 2).reshape(-1, x.shape[1], d)
        out = attention_ref(bh(q), bh(k), bh(v), causal=causal,
                            window=window, softcap=softcap, scale=scale,
                            q_offset=q_offset)
        return out.reshape(b, h, sq, d).transpose(1, 2)
    window = GLOBAL_WINDOW if window is None else int(window)
    return _launch(q, k, v, int(causal), window, softcap, float(scale),
                   int(q_offset))
