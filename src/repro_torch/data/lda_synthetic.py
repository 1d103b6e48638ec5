"""Synthetic LDA corpora (paper S4 setup), frozen and IID.

The torch counterpart of the frozen IID corpus of
``repro.data.lda_synthetic``: a ground-truth beta* ~ Dirichlet(0.1)^K,
``n_nodes`` shards of ``docs_per_node`` documents with Poisson lengths
clipped to ``[2, doc_len_max]``, and an IID held-out set (Poisson lengths
too, or uniform in ``[2, doc_len_max]`` with ``test_len_uniform``). Words
are drawn per token from the row beta*[z] by inverse CDF, so at
V = 50,000 no ``[L, V]`` logits are built per document.

The realistic-corpus options of ``benchmarks/sparse_bench.py``:
``zipf_exponent`` folds a power-law word-frequency envelope into beta*
(many repeated words per document, the regime of the unique-token
layout) and ``doc_len_lognormal`` draws lognormal lengths instead of
Poisson ones. A corpus with more than 5% of its lengths clipped warns.
:meth:`SyntheticCorpus.unique_view` gives the (word_id, count) view.

The reference's gamma and Dirichlet draws cannot be replayed bit for
bit, so a port corpus is not the reference corpus for the same seed;
parity tests hand the reference's corpus arrays to the port instead.
The port's corpus is a function of its key alone: it is drawn and
shaped on the CPU and moved to the key's device at the end, so a CUDA
run and a CPU run of one seed train on the same corpus.
Not ported: topic skew, streaming corpora.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple

import torch

from repro_torch.core import threefry as tf3
from repro_torch.core.estep import unique_view
from repro_torch.core.lda import (LDAConfig, generator_from_key,
                                  sample_documents, sample_topic_matrix)

__all__ = ["CorpusSpec", "SyntheticCorpus", "make_corpus",
           "LENGTH_TRUNCATION_WARN_FRAC"]

# warn when more than this share of drawn lengths was clipped into
# [2, doc_len_max]: the realized lengths no longer follow the spec
LENGTH_TRUNCATION_WARN_FRAC = 0.05


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

    def unique_view(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(word_id, count) view of the training shards, ``[n, D, U]``
        each, U the realized maximum of distinct words per document."""
        return unique_view(self.words, self.mask)

    def test_unique_view(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(word_id, count) view of the held-out documents, ``[n_test, U]``."""
        return unique_view(self.test_words, self.test_mask)


@dataclasses.dataclass(frozen=True)
class CorpusSpec:
    """Paper S4 defaults, and the realistic-corpus options."""

    n_nodes: int = 50
    docs_per_node: int = 20
    n_test: int = 100
    doc_len_poisson: float = 10.0
    topic_concentration: float = 0.1   # Dirichlet conc. of beta* rows
    # held-out lengths uniform in [2, doc_len_max] instead of Poisson: the
    # request-length mix of benchmarks/serve_bench.py, which fills every
    # serving bucket of a long doc_len_max
    test_len_uniform: bool = False
    # p(v) ~ (v + 1)^-a word-frequency envelope folded into beta*
    zipf_exponent: float | None = None
    # (mu, sigma): lengths round(exp(mu + sigma * N(0, 1))), not Poisson
    doc_len_lognormal: tuple[float, float] | None = None

    def __post_init__(self):
        if self.zipf_exponent is not None and self.zipf_exponent <= 0.0:
            raise ValueError(f"zipf_exponent must be positive, "
                             f"got {self.zipf_exponent}")
        if self.doc_len_lognormal is not None:
            if (len(self.doc_len_lognormal) != 2
                    or self.doc_len_lognormal[1] <= 0.0):
                raise ValueError(
                    f"doc_len_lognormal must be (mu, sigma > 0), "
                    f"got {self.doc_len_lognormal}")


def _lengths(key: torch.Tensor, spec: CorpusSpec, n: int, max_len: int):
    """Lengths clipped to [2, max_len], and the clipped mask: Poisson, or
    lognormal with ``spec.doc_len_lognormal``."""
    gen = generator_from_key(key)
    if spec.doc_len_lognormal is not None:
        mu, sigma = spec.doc_len_lognormal
        z = torch.randn((n,), generator=gen)
        raw = torch.round(torch.exp(mu + sigma * z))
    else:
        rate = torch.full((n,), spec.doc_len_poisson, dtype=torch.float32)
        raw = torch.poisson(rate, generator=gen)
    truncated = (raw < 2) | (raw > max_len)
    return torch.clamp(raw, 2, max_len).to(torch.int64), truncated


def _zipf_envelope(beta_star: torch.Tensor, exponent: float) -> torch.Tensor:
    """Each topic's column v times (v + 1)^-exponent, rows renormalised:
    the corpus' word marginal gets a Zipf head and tail."""
    v = beta_star.shape[-1]
    env = (torch.arange(v, dtype=beta_star.dtype, device=beta_star.device)
           + 1.0) ** (-exponent)
    out = beta_star * env
    return out / out.sum(dim=-1, keepdim=True)


def make_corpus(config: LDAConfig, key: torch.Tensor,
                spec: CorpusSpec = CorpusSpec()) -> SyntheticCorpus:
    """The node-sharded corpus and held-out set, on the key's device
    (drawn on the CPU: the same corpus on every device)."""
    dev, key = key.device, key.cpu()
    k_beta, k_len, k_doc, k_tlen, k_tdoc = tf3.split(key, 5)
    beta_star = sample_topic_matrix(config, k_beta,
                                    spec.topic_concentration)
    if spec.zipf_exponent is not None:
        beta_star = _zipf_envelope(beta_star, spec.zipf_exponent)
    n_train = spec.n_nodes * spec.docs_per_node
    lengths, trunc = _lengths(k_len, spec, n_train, config.doc_len_max)
    words, mask = sample_documents(config, generator_from_key(k_doc),
                                   beta_star, lengths)
    if spec.test_len_uniform:
        t_lengths = torch.randint(2, config.doc_len_max + 1, (spec.n_test,),
                                  generator=generator_from_key(k_tlen))
        t_trunc = torch.zeros_like(t_lengths, dtype=torch.bool)
    else:
        t_lengths, t_trunc = _lengths(k_tlen, spec, spec.n_test,
                                      config.doc_len_max)
    t_words, t_mask = sample_documents(config, generator_from_key(k_tdoc),
                                       beta_star, t_lengths)
    shape = (spec.n_nodes, spec.docs_per_node, config.doc_len_max)
    trunc_frac = float(torch.cat([trunc, t_trunc]).float().mean())
    if trunc_frac > LENGTH_TRUNCATION_WARN_FRAC:
        warnings.warn(
            f"{trunc_frac:.1%} of drawn document lengths fell outside "
            f"[2, doc_len_max={config.doc_len_max}] and were clipped; the "
            f"realized lengths are biased", stacklevel=2)
    return SyntheticCorpus(words=words.reshape(shape).to(dev),
                           mask=mask.reshape(shape).to(dev),
                           test_words=t_words.to(dev),
                           test_mask=t_mask.to(dev),
                           beta_star=beta_star.to(dev),
                           alpha_star=config.alpha,
                           length_truncation_frac=trunc_frac)
