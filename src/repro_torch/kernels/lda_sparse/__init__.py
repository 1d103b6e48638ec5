"""CUDA kernel for the count-weighted sweeps of the unique-token layout."""

from repro_torch.kernels.lda_sparse.ops import sparse_sweeps

__all__ = ["sparse_sweeps"]
