"""Collapsed Gibbs sampling E-step for LDA (the G-OEM inner loop).

The torch counterpart of ``repro.core.gibbs``, a thin wrapper over
:class:`repro_torch.core.estep.DenseEStep`: theta is integrated out and
each position's topic is resampled from

    p(z_i = k | z_{-i}, w) ~ (n_dk^{(-i)} + alpha) * beta[k, w_i],

and the E-step's statistic is the mean over the kept sweeps of the
per-position conditional posterior (the Rao-Blackwell estimator), the
``lda_gibbs`` kernel on the card and its plain version on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch.core.estep import GibbsResult, get_estep
from repro_torch.core.lda import LDAConfig

__all__ = ["GibbsResult", "gibbs_estep"]


def gibbs_estep(config: LDAConfig, key: torch.Tensor, words: torch.Tensor,
                mask: torch.Tensor, beta: torch.Tensor,
                rao_blackwell: bool = True) -> GibbsResult:
    """Run the collapsed-Gibbs E-step on a batch of documents.

    words ``[B, L]`` token ids, mask ``[B, L]`` bool, beta ``[K, V]``.
    Returns a :class:`GibbsResult` whose ``stats`` is the mean over
    documents of the expected per-document (topic, word) counts ``[K, V]``.
    Only the Rao-Blackwell estimator is ported (the ``lda_gibbs`` kernel
    computes no other); ``rao_blackwell=False`` raises.
    """
    if not rao_blackwell:
        raise NotImplementedError(
            "gibbs_estep: the lda_gibbs kernel computes the Rao-Blackwell "
            "mean only; the sampled one-hot estimator is not ported")
    return get_estep()(config, key, words, mask, beta)
