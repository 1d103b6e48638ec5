"""Plain torch version of the lda_sparse kernel.

As in the reference, the plain version IS the sparse sweep core
(``repro_torch.core.estep.gibbs_sweeps_sparse``): the kernel repeats its
float operations in the same order, so the two make the same draws;
their outputs agree to one ulp (the final division by S - burnin).
"""

from repro_torch.core.estep import gibbs_sweeps_sparse

sparse_sweeps_ref = gibbs_sweeps_sparse

__all__ = ["sparse_sweeps_ref"]
