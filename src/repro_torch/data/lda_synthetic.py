"""Synthetic LDA corpora (paper S4 setup), dense and frozen.

The torch counterpart of the frozen IID corpus of
``repro.data.lda_synthetic``: a ground-truth beta* ~ Dirichlet(0.1)^K,
``n_nodes`` shards of ``docs_per_node`` documents with Poisson lengths
clipped to ``[2, doc_len_max]``, and an IID held-out set (Poisson lengths
too, or uniform in ``[2, doc_len_max]`` with ``test_len_uniform``). Words
are drawn per token from the row beta*[z] by inverse CDF, so at
V = 50,000 no ``[L, V]`` logits are built per document.

The reference's gamma and Dirichlet draws cannot be replayed bit for
bit, so a port corpus is not the reference corpus for the same seed;
parity tests hand the reference's corpus arrays to the port instead.
Not ported: topic skew, Zipf envelopes, lognormal lengths, streaming.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import threefry as tf3
from repro_torch.core.lda import (LDAConfig, generator_from_key,
                                  sample_documents, sample_topic_matrix)

__all__ = ["CorpusSpec", "SyntheticCorpus", "make_corpus"]


class SyntheticCorpus(NamedTuple):
    """A node-sharded synthetic corpus with its generating parameters."""

    words: torch.Tensor        # [n_nodes, docs_per_node, L] int64
    mask: torch.Tensor         # [n_nodes, docs_per_node, L] bool
    test_words: torch.Tensor   # [n_test, L] held-out documents
    test_mask: torch.Tensor    # [n_test, L]
    beta_star: torch.Tensor    # [K, V] generating topic matrix
    alpha_star: float          # generating Dirichlet parameter
    length_truncation_frac: float   # drawn lengths clipped into [2, L]

    @property
    def flat_words(self) -> torch.Tensor:
        """Centralized view [n*docs, L] for the G-OEM baseline."""
        return self.words.reshape(-1, self.words.shape[-1])

    @property
    def flat_mask(self) -> torch.Tensor:
        return self.mask.reshape(-1, self.mask.shape[-1])


@dataclasses.dataclass(frozen=True)
class CorpusSpec:
    """Paper S4 defaults."""

    n_nodes: int = 50
    docs_per_node: int = 20
    n_test: int = 100
    doc_len_poisson: float = 10.0
    topic_concentration: float = 0.1   # Dirichlet conc. of beta* rows
    # held-out lengths uniform in [2, doc_len_max] instead of Poisson: the
    # request-length mix of benchmarks/serve_bench.py, which fills every
    # serving bucket of a long doc_len_max
    test_len_uniform: bool = False


def _lengths(key: torch.Tensor, lam: float, n: int, max_len: int):
    """Poisson(lam) lengths clipped to [2, max_len], and the clipped mask."""
    rate = torch.full((n,), lam, dtype=torch.float32, device=key.device)
    raw = torch.poisson(rate, generator=generator_from_key(key))
    truncated = (raw < 2) | (raw > max_len)
    return torch.clamp(raw, 2, max_len).to(torch.int64), truncated


def make_corpus(config: LDAConfig, key: torch.Tensor,
                spec: CorpusSpec = CorpusSpec()) -> SyntheticCorpus:
    """The node-sharded corpus and held-out set, on the key's device."""
    k_beta, k_len, k_doc, k_tlen, k_tdoc = tf3.split(key, 5)
    beta_star = sample_topic_matrix(config, k_beta,
                                    spec.topic_concentration)
    n_train = spec.n_nodes * spec.docs_per_node
    lengths, trunc = _lengths(k_len, spec.doc_len_poisson, n_train,
                              config.doc_len_max)
    words, mask = sample_documents(config, generator_from_key(k_doc),
                                   beta_star, lengths)
    if spec.test_len_uniform:
        t_lengths = torch.randint(2, config.doc_len_max + 1, (spec.n_test,),
                                  generator=generator_from_key(k_tlen),
                                  device=key.device)
        t_trunc = torch.zeros_like(t_lengths, dtype=torch.bool)
    else:
        t_lengths, t_trunc = _lengths(k_tlen, spec.doc_len_poisson,
                                      spec.n_test, config.doc_len_max)
    t_words, t_mask = sample_documents(config, generator_from_key(k_tdoc),
                                       beta_star, t_lengths)
    shape = (spec.n_nodes, spec.docs_per_node, config.doc_len_max)
    trunc_frac = float(torch.cat([trunc, t_trunc]).float().mean())
    return SyntheticCorpus(words=words.reshape(shape),
                           mask=mask.reshape(shape), test_words=t_words,
                           test_mask=t_mask, beta_star=beta_star,
                           alpha_star=config.alpha,
                           length_truncation_frac=trunc_frac)
