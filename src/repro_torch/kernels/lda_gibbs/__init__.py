"""CUDA kernel for the collapsed-Gibbs sweeps (G-OEM E-step, mixtures)."""

from repro_torch.kernels.lda_gibbs.ops import gibbs_sweeps

__all__ = ["gibbs_sweeps"]
