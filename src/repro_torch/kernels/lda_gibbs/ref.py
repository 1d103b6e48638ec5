"""Plain torch version of the lda_gibbs kernel.

As in the reference, the plain version IS the shared sweep core
(``repro_torch.core.estep.gibbs_sweeps_dense``): the kernel repeats its
float operations in the same order, so the two make the same draws;
their outputs agree to one ulp (PyTorch's CUDA division by a Python
number multiplies by its reciprocal, the kernel divides).
"""

from repro_torch.core.estep import gibbs_sweeps_dense

gibbs_sweeps_ref = gibbs_sweeps_dense

__all__ = ["gibbs_sweeps_ref"]
