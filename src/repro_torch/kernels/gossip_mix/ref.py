"""Plain torch versions of the gossip_mix kernel.

:func:`mix_matching_ref` is the function of the TPU kernel, out of place:
as in the reference, it IS the simulation's ``core.gossip.mix_matching``,
and ``chip_smoke.py`` holds the CUDA kernel against it.
:func:`mix_pairs_ref_` is its in-place pair form, which the wrapper runs
for CPU tensors: it touches only the matched rows, with the same float
operations, so it gives the same bits. A bfloat16 statistic is averaged
in float32 and rounded once, as the kernel does (for bf16 inputs the
same bits as the bf16 ``0.5 * (a + b)`` of the reference).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.gossip import mix_matching as mix_matching_ref

__all__ = ["mix_matching_ref", "mix_pairs_ref_"]


def mix_pairs_ref_(stats: torch.Tensor, pairs: np.ndarray) -> torch.Tensor:
    """In place: ``s_i, s_j <- 0.5 * (s_i + s_j)`` for each pair ``(i, j)``."""
    i = torch.as_tensor(pairs[:, 0], dtype=torch.int64, device=stats.device)
    j = torch.as_tensor(pairs[:, 1], dtype=torch.int64, device=stats.device)
    avg = (0.5 * (stats[i].float() + stats[j].float())).to(stats.dtype)
    stats[i] = avg
    stats[j] = avg
    return stats
