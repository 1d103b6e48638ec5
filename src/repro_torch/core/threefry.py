"""Threefry-2x32 in torch: the port's random number generator.

The port's key is a ``[..., 2]`` tensor of 32-bit words (held in int64,
see below). Every function here reproduces the bits of ``jax.random``
under its non-partitionable threefry implementation (the mode the JAX
package's goldens and ``repro.core.threefry`` assume), so the port can
replay the reference's random streams:

* the evaluator's per-document streams — :func:`fold_in_data`,
  :func:`split2_data`, :func:`uniform_halves` and :func:`uniform_column`,
  the last drawing one column of ``uniform(key, (P, L))`` without the
  rest (the ``lda_l2r`` kernel computes the same words on the device,
  ``kernels/lda_l2r/csrc/threefry.cuh``);
* the training and serving streams — :func:`split`, :func:`uniform`,
  :func:`randint` and :func:`exponential`, batched over leading key
  dimensions so one call draws every document's stream.

Layout (as in jax's ``threefry_2x32``): a size-n draw ciphers the counts
``0 .. n-1`` split into halves ``x1 = counts[:ceil(n/2)]`` and
``x2 = counts[ceil(n/2):]`` (odd n pads one zero count), and the output
is ``concat(o1, o2)[:n]``.

PyTorch on the CPU has no ``uint32`` add or shift, so words live in
int64 and every add is masked back to 32 bits; values stay in
``[0, 2**32)``. The CUDA side uses native ``uint32_t``.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "key", "cipher", "key_data", "fold_in_data", "split2_data", "split",
    "uniform_from_bits", "uniform_halves", "uniform_column", "uniform",
    "randint", "exponential", "random_bits",
]

_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def key(seed: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """The key ``jax.random.key(seed)`` holds: words ``[seed >> 32, seed]``."""
    if seed < 0:
        raise ValueError(f"seed must be >= 0, got {seed}")
    return torch.tensor([(seed >> 32) & _M32, seed & _M32],
                        dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & _M32) | (x >> (32 - d))


def cipher(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 block cipher (5 x 4 rounds) on broadcast int64 words.

    Key schedule ``[k1, k2, k1 ^ k2 ^ PARITY]`` rotating one slot per
    4-round group, the group index folded into the second lane — the
    same loop as jax's ``threefry2x32`` and ``repro.core.threefry``.
    """
    ks = [k1, k2, k1 ^ k2 ^ _PARITY]
    x = [(x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32]
    rots = list(_ROTATIONS)
    ks = ks[1:] + ks[:1]
    for group in range(5):
        for d in rots[0]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = _rotl(x[1], d) ^ x[0]
        x = [(x[0] + ks[0]) & _M32, (x[1] + ks[1] + group + 1) & _M32]
        ks = ks[1:] + ks[:1]
        rots = rots[1:] + rots[:1]
    return x[0], x[1]


def key_data(k: torch.Tensor) -> torch.Tensor:
    """``[..., 2]`` int64 words of a key (the port's keys are their words)."""
    if k.shape[-1:] != (2,):
        raise ValueError(f"a key is a [..., 2] tensor, got {tuple(k.shape)}")
    return k.to(torch.int64)


def fold_in_data(kd: torch.Tensor, data) -> torch.Tensor:
    """``fold_in(key, data)`` for kd ``[..., 2]`` and broadcastable data.

    fold_in ciphers the single count ``data``: halves ``x1 = [0]`` and
    ``x2 = [data]``, giving the new key ``(o1, o2)``.
    """
    data = torch.as_tensor(data, dtype=torch.int64, device=kd.device) & _M32
    o1, o2 = cipher(kd[..., 0], kd[..., 1], torch.zeros_like(data), data)
    return torch.stack([o1, o2], dim=-1)


def split2_data(kd: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(k0, k1) = split(key)``: counts ``[0, 1]`` and ``[2, 3]``."""
    c = torch.arange(2, dtype=torch.int64, device=kd.device)
    o1, o2 = cipher(kd[..., 0:1], kd[..., 1:2], c, c + 2)
    return o1, o2


def random_bits(kd: torch.Tensor, n: int) -> torch.Tensor:
    """The 32-bit words of a size-n draw, ``[..., 2] -> [..., n]``."""
    h = (n + 1) // 2
    x1 = torch.arange(h, dtype=torch.int64, device=kd.device)
    x2 = x1 + h
    if 2 * h != n:                       # odd n: the pad count is zero
        x2 = torch.where(x2 < n, x2, torch.zeros_like(x2))
    o1, o2 = cipher(kd[..., 0:1], kd[..., 1:2], x1, x2)
    return torch.cat([o1, o2], dim=-1)[..., :n]


def split(kd: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``split(key, n)``: ``[..., 2] -> [..., n, 2]``."""
    return random_bits(kd, 2 * n).reshape(kd.shape[:-1] + (n, 2))


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """32-bit words -> float32 in [0, 1), jax's mantissa construction.

    Keep the top 23 bits, OR in the exponent of 1.0, bit-cast, subtract
    1.0 (``repro.core.threefry.uniform_from_bits``).
    """
    fb = (bits >> 9) | 0x3F800000
    return fb.to(torch.int32).view(torch.float32) - 1.0


def uniform(kd: torch.Tensor, shape) -> torch.Tensor:
    """``uniform(key, shape)`` float32, batched: ``[..., 2] -> [..., *shape]``."""
    shape = tuple(shape)
    n = math.prod(shape)
    bits = random_bits(kd, n)
    return uniform_from_bits(bits).reshape(kd.shape[:-1] + shape)


def randint(kd: torch.Tensor, shape, minval: int,
            maxval: int) -> torch.Tensor:
    """``randint(key, shape, minval, maxval)`` as int64, batched.

    jax draws two words per value from ``split(key)`` and folds them
    into the span with 32-bit unsigned arithmetic; the products and sums
    below wrap at 2**32 as uint32 does.
    """
    shape = tuple(shape)
    n = math.prod(shape)
    span = maxval - minval if maxval > minval else 1
    ks = split(kd, 2)
    hi = random_bits(ks[..., 0, :], n)
    lo = random_bits(ks[..., 1, :], n)
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _M32) % span
    off = (((hi % span) * mult) & _M32) + (lo % span)
    off = (off & _M32) % span
    return (minval + off).reshape(kd.shape[:-1] + shape)


def exponential(kd: torch.Tensor, shape) -> torch.Tensor:
    """``exponential(key, shape)``: ``-log1p(-u)`` of the same uniform draw.

    The log is taken in float64 and rounded once to float32, so the
    result is the correctly rounded value on every device. XLA's float32
    ``log1p`` is not correctly rounded, so about 7% of draws differ from
    jax's by one ulp; the uniforms underneath are the same bits.
    """
    u = uniform(kd, shape)
    return torch.log1p(-u.double()).neg().float()


def _halves_bits(kd: torch.Tensor, flat: torch.Tensor, n: int):
    """Words at flat positions ``flat`` of a size-n draw, one cipher each."""
    h = (n + 1) // 2
    in1 = torch.where(flat < h, flat, flat - h)
    in2 = in1 + h
    if 2 * h != n:
        in2 = torch.where(in2 < n, in2, torch.zeros_like(in2))
    o1, o2 = cipher(kd[..., 0], kd[..., 1], in1, in2)
    return torch.where(flat < h, o1, o2)


def uniform_halves(kd: torch.Tensor, n: int) -> torch.Tensor:
    """``uniform(key, (n,))`` bit for bit: ``[..., 2] -> [..., n]``."""
    flat = torch.arange(n, dtype=torch.int64, device=kd.device)
    return uniform_from_bits(_halves_bits(kd[..., None, :], flat, n))


def uniform_column(kd: torch.Tensor, p: int, l: int, i) -> torch.Tensor:
    """Column i of ``uniform(key, (p, l))``: ``[..., 2] -> [..., p]``."""
    rows = torch.arange(p, dtype=torch.int64, device=kd.device) * l
    return uniform_from_bits(_halves_bits(kd[..., None, :], rows + i, p * l))
