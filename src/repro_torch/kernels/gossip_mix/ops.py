"""Wrapper of the gossip_mix CUDA kernel, dispatched by the tensor's device.

A CUDA tensor launches ``csrc/gossip_mix.cu`` (or raises); a CPU tensor
runs the plain version in ``ref.py``. The statistic is mixed in place
(the reference returns a new array; at K=100, V=50,000 and n=50 a copy
is 1 GB). The statistic is float32 or bfloat16 (the LM trainer's
parameter leaves); any other dtype raises. ``launches`` counts kernel
launches and nothing else; ``launches_by_shape`` counts them by
``(*stats.shape, pairs)``, with ``"bf16"`` appended for a bfloat16
launch.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import common
from repro_torch.kernels.gossip_mix.ref import mix_pairs_ref_

__all__ = ["mix_pairs_", "pairs_of", "launches", "launches_by_shape",
           "MAX_PAIRS"]

MAX_PAIRS = 480        # pairs passed by value in one launch's parameters
launches = 0
launches_by_shape: dict[tuple, int] = {}


def pairs_of(partners) -> np.ndarray:
    """The matched pairs ``(i, p[i])`` with ``i < p[i]`` of an involution,
    ``[P, 2]`` int32 (self-partners dropped)."""
    p = np.asarray(partners).astype(np.int64).reshape(-1)
    i = np.nonzero(p > np.arange(len(p)))[0]
    return np.stack([i, p[i]], axis=1).astype(np.int32).reshape(-1, 2)


def _check_pairs(pairs: np.ndarray, n: int) -> np.ndarray:
    pairs = np.ascontiguousarray(pairs, dtype=np.int32).reshape(-1, 2)
    if len(pairs) and (pairs.min() < 0 or pairs.max() >= n):
        raise ValueError(f"gossip_mix: pair node out of range [0, {n})")
    if (pairs[:, 0] == pairs[:, 1]).any():
        raise ValueError("gossip_mix: a pair joins a node to itself")
    if len(np.unique(pairs)) != pairs.size:
        raise ValueError("gossip_mix: a node is in two pairs")
    return pairs


_DTYPES = {torch.float32: 4, torch.bfloat16: 8}   # elements a 16-byte vector


def _launch(stats: torch.Tensor, pairs: np.ndarray) -> torch.Tensor:
    global launches
    common.require_cuda("gossip_mix", stats)
    if len(pairs) == 0:
        return stats
    row = stats[0].numel()
    bf16 = stats.dtype == torch.bfloat16
    vec = int(row % _DTYPES[stats.dtype] == 0 and stats.data_ptr() % 16 == 0)
    lib = common.load("gossip_mix")
    with torch.cuda.device(stats.device):
        for q0 in range(0, len(pairs), MAX_PAIRS):
            chunk = np.ascontiguousarray(pairs[q0:q0 + MAX_PAIRS])
            err = lib.gossip_mix_pairs(
                ctypes.c_void_p(stats.data_ptr()), ctypes.c_longlong(row),
                chunk.ctypes.data_as(ctypes.c_void_p),
                ctypes.c_int(len(chunk)), ctypes.c_int(vec),
                ctypes.c_int(bf16), ctypes.c_void_p(common.stream_ptr()))
            common.check(err, "gossip_mix")
            launches += 1
            shape = (*stats.shape, len(chunk)) + (("bf16",) if bf16 else ())
            launches_by_shape[shape] = launches_by_shape.get(shape, 0) + 1
    return stats


def mix_pairs_(stats: torch.Tensor, pairs) -> torch.Tensor:
    """In place: ``s_i, s_j <- 0.5 * (s_i + s_j)`` for each pair ``(i, j)``.

    stats ``[n, ...]`` float32 or bfloat16 (contiguous on the card); a
    pair's average is ``0.5 * (a + b)`` taken in float32 and rounded once
    to the dtype; pairs a host
    ``[P, 2]`` integer array of distinct nodes, ``i != j`` (an empty list
    mixes nothing and launches nothing). Returns ``stats``.
    """
    if stats.dim() < 1:
        raise ValueError("gossip_mix: statistics need a node axis")
    if stats.dtype not in _DTYPES:
        raise ValueError(f"gossip_mix: want float32 or bfloat16 "
                         f"statistics, got {stats.dtype}")
    pairs = _check_pairs(pairs, stats.shape[0])
    if stats.device.type == "cpu":
        return mix_pairs_ref_(stats, pairs)
    return _launch(stats, pairs)
