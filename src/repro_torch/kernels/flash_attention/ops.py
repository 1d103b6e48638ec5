"""Wrapper of the flash_attention CUDA kernel, dispatched by the device.

The ``[B, S, H, D]`` API of the reference's ``ops.flash_attention``. A
CUDA tensor launches ``csrc/flash_attention.cu`` (or raises); a CPU
tensor runs the plain version in ``ref.py``. The kernel masks keys past
``Sk`` itself, so nothing is padded, and it reads each query head's KV
head in place, so nothing is transposed or repeated.

The kernel has three variants; :func:`variant` picks one from the dtype,
``Sq``, ``D`` and the GQA group ``H / Hkv`` alone:

- ``"decode"`` when ``Sq * group <= DECODE_ROWS`` (64), either dtype,
  every D: one block per (batch, KV head) whose rows are the group's
  query heads at each position, the keys split over its warps and, past
  ``SPLIT_KEYS`` visible keys, over blocks too (then a second small pass
  merges the splits, from a float32 workspace allocated here);
- ``"wgmma"`` for bf16 at D in ``WGMMA_DIMS`` above that: TMA tiles and
  ``wgmma`` on the tensor cores;
- ``"fma"`` otherwise (float32 prefill, bf16 at D 16, 32 or 80): float32
  FMA tiles. "wgmma" stores its tiles as 64-column panels, which D=80
  (zamba2's head) does not fill, so a bf16 prefill at D=80 takes "fma".

Every variant takes causal and non-causal launches (whisper's encoder
and every cross-attention are non-causal): a non-causal query sees every
key below ``Sk`` inside its window.

A variant that fails to build or launch raises; nothing falls back to
another variant or to the plain version. ``launches`` counts wrapper
calls that launched the kernel and nothing else; ``launches_by_shape``
counts them by ``(B, Sq, Sk, H, Hkv, D, dtype, "local" | "global",
softcap)`` (``q_offset`` is not part of the key), ``launches_by_variant``
by variant.

Gradient. :func:`flash_attention` is a ``torch.autograd.Function``: its
forward is the launch above (the plain version on the CPU), and its
backward is ``ref.attention_bwd``, torch ops that recompute the float32
scores, as the reference's autodiff through its einsums does (the JAX
package has no backward kernel). Under ``torch.no_grad`` (serving) the
same forward runs and nothing is kept.

The plain forward and the backward are each one ``torch.library``
custom op (``repro_torch::flash_attention_plain`` and
``::flash_attention_bwd``) with a fake implementation, so fake tensors
run them, and a dispatch mode sees one op with the kernel's inputs and
outputs, not its [S, S] temporaries.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import common
from repro_torch.kernels.flash_attention.ref import (attention_bwd,
                                                     attention_ref)

__all__ = ["flash_attention", "shape_key", "variant", "n_splits",
           "GLOBAL_WINDOW", "HEAD_DIMS", "VARIANTS", "launches",
           "launches_by_shape", "launches_by_variant"]

GLOBAL_WINDOW = 1 << 30     # a window this wide masks nothing: "global"
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
WGMMA_DIMS = (64, 128, 256)
DECODE_ROWS = 64            # "decode" takes Sq * group up to this
SPLIT_KEYS = 512            # visible keys of one "decode" split
VARIANTS = ("fma", "wgmma", "decode")    # the kernel's variant codes 0, 1, 2
_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
launches = 0
launches_by_shape: dict[tuple, int] = {}
launches_by_variant: dict[str, int] = {}


def shape_key(q: torch.Tensor, k: torch.Tensor, window: Optional[int],
              softcap: Optional[float]) -> tuple:
    """The key a launch is counted under in ``launches_by_shape``."""
    b, sq, h, d = q.shape
    local = window is not None and window < GLOBAL_WINDOW
    return (b, sq, k.shape[1], h, k.shape[2], d,
            _DTYPES.get(q.dtype, str(q.dtype)),
            "local" if local else "global", softcap)


def variant(dtype: torch.dtype, sq: int, d: int, group: int) -> str:
    """The kernel variant a launch takes: "decode" for at most
    ``DECODE_ROWS`` query rows per KV head (``Sq * group``), else "wgmma"
    for bf16 at D in ``WGMMA_DIMS``, else "fma"."""
    if sq * group <= DECODE_ROWS:
        return "decode"
    if dtype == torch.bfloat16 and d in WGMMA_DIMS:
        return "wgmma"
    return "fma"


def n_splits(sq: int, sk: int, causal: bool, window: int,
             q_offset: int) -> int:
    """Key splits of a "decode" launch: one per ``SPLIT_KEYS`` keys that
    some row sees (at least 1), as the kernel cuts them."""
    kmax = min(sk - 1, q_offset + sq - 1) if causal else sk - 1
    kmin = max(0, q_offset - window + 1)
    return max(1, -(-(kmax - kmin + 1) // SPLIT_KEYS))


def _launch(q, k, v, causal, window, softcap, scale, q_offset):
    global launches
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    common.require_cuda("flash_attention", q, k, v)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must be 16-byte "
                         "aligned")
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
    var = variant(q.dtype, sq, d, h // hkv)
    if var == "wgmma" and -(-sq // 128) > 65535:
        raise ValueError(f"flash_attention: Sq = {sq} > 65535 * 128")
    splits = (n_splits(sq, sk, bool(causal), window, q_offset)
              if var == "decode" else 1)
    ws_acc = ws_ml = None
    if splits > 1:
        rows = b * hkv * splits * sq * (h // hkv)
        ws_acc = torch.empty((rows, d), dtype=torch.float32, device=q.device)
        ws_ml = torch.empty((rows, 2), dtype=torch.float32, device=q.device)
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
            ctypes.c_int(VARIANTS.index(var)), ctypes.c_int(splits),
            ptr(0 if ws_acc is None else ws_acc.data_ptr()),
            ptr(0 if ws_ml is None else ws_ml.data_ptr()),
            ptr(common.stream_ptr()))
    common.check(err, f"flash_attention ({var})")
    launches += 1
    key = shape_key(q, k, window, softcap)
    launches_by_shape[key] = launches_by_shape.get(key, 0) + 1
    launches_by_variant[var] = launches_by_variant.get(var, 0) + 1
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
    return _Attention.apply(q, k, v, bool(causal), window, softcap,
                            float(scale), int(q_offset))


@torch.library.custom_op("repro_torch::flash_attention_plain",
                         mutates_args=())
def _plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           window: Optional[int], softcap: Optional[float], scale: float,
           q_offset: int) -> torch.Tensor:
    """The plain version at the kernel's [B, S, H, D] interface, one op
    to a dispatch mode, as the kernel is one launch."""
    b, sq, h, d = q.shape

    def bh(x):
        return x.transpose(1, 2).reshape(-1, x.shape[1], d)
    out = attention_ref(bh(q), bh(k), bh(v), causal=causal, window=window,
                        softcap=softcap, scale=scale, q_offset=q_offset)
    return out.reshape(b, h, sq, d).transpose(1, 2)


def _heads_major(x: torch.Tensor) -> torch.Tensor:
    """An empty tensor of ``x``'s [B, S, H, D] shape in the plain
    version's layout, [B, H, S, D] in memory (fake implementations)."""
    b, s, h, d = x.shape
    return x.new_empty((b, h, s, d)).transpose(1, 2)


@_plain.register_fake
def _(q, k, v, causal, window, softcap, scale, q_offset):
    return _heads_major(q)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def _backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              dout: torch.Tensor, causal: bool, window: Optional[int],
              softcap: Optional[float], scale: float, q_offset: int
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``ref.attention_bwd`` as one op, on every device."""
    return attention_bwd(q, k, v, dout, causal=causal, window=window,
                         softcap=softcap, scale=scale, q_offset=q_offset)


@_backward.register_fake
def _(q, k, v, dout, causal, window, softcap, scale, q_offset):
    return _heads_major(q), _heads_major(k), _heads_major(v)


def _forward(q, k, v, causal, window, softcap, scale, q_offset):
    """The kernel on a CUDA tensor, the plain version on a CPU one."""
    if q.device.type == "cpu":
        return _plain(q, k, v, causal, window, softcap, scale, q_offset)
    window = GLOBAL_WINDOW if window is None else int(window)
    return _launch(q, k, v, int(causal), window, softcap, scale, q_offset)


class _Attention(torch.autograd.Function):
    """K5's forward; the float32 recomputing backward of ``ref.py``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, softcap, scale, q_offset)
        return _forward(q, k, v, causal, window, softcap, scale, q_offset)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None, None
