"""CUDA kernel for left-to-right held-out scoring (serving's "ll" queries)."""

from repro_torch.kernels.lda_l2r.ops import l2r_scores

__all__ = ["l2r_scores"]
