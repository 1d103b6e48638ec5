"""Plain torch version of the lda_l2r kernel.

As in the reference, the plain version IS the evaluator's fused core
(``repro_torch.core.evaluation.l2r_position_scores``): the kernel
repeats its float operations in the same order.
"""

from repro_torch.core.evaluation import l2r_position_scores

l2r_scores_ref = l2r_position_scores

__all__ = ["l2r_scores_ref"]
