"""Synthetic LDA corpora (paper S4 setup), IID or topic-skewed per node.

The torch counterpart of ``repro.data.lda_synthetic``: a ground-truth beta* ~ Dirichlet(0.1)^K,
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

A streaming corpus (:class:`CorpusStream`, ``CorpusSpec.refresh_every``)
re-draws every node's training shard every ``refresh_every`` rounds while
beta* and the held-out set stay fixed; ``run_deleda(stream=)`` swaps it
in between segments. Its segment s >= 1 draws from ``split(fold_in(
fold_in(key, 0x5EA5), s))``, on the CPU as the base corpus is.

Non-IID shards (``CorpusSpec.topic_skew``): node i draws topic weights
w_i ~ Dirichlet(topic_skew) from ``fold_in(key, 0x5157)``, a key beside
the unchanged 5-way split, and its documents' prior is K * alpha * w_i
(:func:`node_alpha_vectors`): the total concentration of the symmetric
prior, allocated unevenly. beta* and the held-out set stay those of the
IID corpus of the same key (the held-out documents stay IID), and
``topic_skew=None`` draws every earlier corpus bit for bit. The weights
come from the port's CPU generator, so they are not the reference's
for a seed; the transform from weights to priors is the reference's.
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

__all__ = ["CorpusSpec", "SyntheticCorpus", "make_corpus", "CorpusStream",
           "make_corpus_stream", "node_alpha_vectors", "paper_corpus",
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
    node_topic_weights: torch.Tensor | None = None
                               # [n_nodes, K] per-node topic weights of a
                               # skewed corpus (None: IID shards)

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
    topic_skew: float | None = None    # per-node topic bias; None = IID
    # held-out lengths uniform in [2, doc_len_max] instead of Poisson: the
    # request-length mix of benchmarks/serve_bench.py, which fills every
    # serving bucket of a long doc_len_max
    test_len_uniform: bool = False
    # p(v) ~ (v + 1)^-a word-frequency envelope folded into beta*
    zipf_exponent: float | None = None
    # (mu, sigma): lengths round(exp(mu + sigma * N(0, 1))), not Poisson
    doc_len_lognormal: tuple[float, float] | None = None
    # a streaming corpus re-draws the training shards every this many
    # gossip rounds (make_corpus_stream); 0 = the frozen corpus
    refresh_every: int = 0

    def __post_init__(self):
        if self.refresh_every < 0:
            raise ValueError(f"refresh_every must be >= 0 (0 = frozen), "
                             f"got {self.refresh_every}")
        if self.topic_skew is not None and self.topic_skew <= 0.0:
            raise ValueError(
                f"topic_skew must be positive (small = more skewed), "
                f"got {self.topic_skew}")
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


# the fold_in lane of the per-node topic-skew key (the reference's)
_SKEW_SALT = 0x5157


def _skewed_priors(config: LDAConfig, weights: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Drawn topic weights [n, K] to (weights floored at 1e-6 and
    renormalised, priors K * alpha * weights), the reference's transform."""
    weights = torch.clamp(weights, min=1e-6)
    weights = weights / weights.sum(dim=-1, keepdim=True)
    return weights, config.n_topics * config.alpha * weights


def node_alpha_vectors(config: LDAConfig, key: torch.Tensor, n_nodes: int,
                       topic_skew: float
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-node Dirichlet-skewed topic priors, on the key's device.

    Returns (weights [n, K] ~ Dirichlet(topic_skew * 1), drawn on the CPU;
    alpha_vecs [n, K] = K * alpha * weights). Every row of alpha_vecs sums
    to K * alpha, the symmetric prior's total: only the allocation of
    topics to nodes changes.
    """
    conc = torch.full((n_nodes, config.n_topics), float(topic_skew),
                      dtype=torch.float32)
    g = torch.clamp(torch._standard_gamma(
        conc, generator=generator_from_key(key.cpu())), min=1e-30)
    weights, alpha_vecs = _skewed_priors(config,
                                         g / g.sum(dim=-1, keepdim=True))
    return weights.to(key.device), alpha_vecs.to(key.device)


def _train_alpha_vecs(config: LDAConfig, spec: CorpusSpec,
                      key: torch.Tensor):
    """(node weights, per-document priors [n*D, K]) of a skewed spec on
    the CPU, from the skew lane of the corpus ``key``; (None, None) for
    IID shards (the symmetric alpha)."""
    if spec.topic_skew is None:
        return None, None
    weights, node_alphas = node_alpha_vectors(
        config, tf3.fold_in_data(key.cpu(), _SKEW_SALT), spec.n_nodes,
        spec.topic_skew)
    return weights, node_alphas.repeat_interleave(spec.docs_per_node, dim=0)


def _draw_training_shards(config: LDAConfig, spec: CorpusSpec,
                          beta_star: torch.Tensor,
                          alpha_vecs: torch.Tensor | None,
                          k_len: torch.Tensor, k_doc: torch.Tensor):
    """One draw of every node's ``[D, L]`` training shard on the CPU:
    (words, mask, the lengths' clipped mask). ``alpha_vecs`` [n*D, K] are
    the documents' priors (None: the symmetric alpha)."""
    n_train = spec.n_nodes * spec.docs_per_node
    lengths, trunc = _lengths(k_len, spec, n_train, config.doc_len_max)
    words, mask = sample_documents(config, generator_from_key(k_doc),
                                   beta_star, lengths, alpha_vecs)
    shape = (spec.n_nodes, spec.docs_per_node, config.doc_len_max)
    return words.reshape(shape), mask.reshape(shape), trunc


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
    weights, alpha_vecs = _train_alpha_vecs(config, spec, key)
    words, mask, trunc = _draw_training_shards(config, spec, beta_star,
                                               alpha_vecs, k_len, k_doc)
    # the held-out documents stay IID: perplexity measures the global
    # model, however the training shards are biased
    if spec.test_len_uniform:
        t_lengths = torch.randint(2, config.doc_len_max + 1, (spec.n_test,),
                                  generator=generator_from_key(k_tlen))
        t_trunc = torch.zeros_like(t_lengths, dtype=torch.bool)
    else:
        t_lengths, t_trunc = _lengths(k_tlen, spec, spec.n_test,
                                      config.doc_len_max)
    t_words, t_mask = sample_documents(config, generator_from_key(k_tdoc),
                                       beta_star, t_lengths)
    trunc_frac = float(torch.cat([trunc, t_trunc]).float().mean())
    if trunc_frac > LENGTH_TRUNCATION_WARN_FRAC:
        warnings.warn(
            f"{trunc_frac:.1%} of drawn document lengths fell outside "
            f"[2, doc_len_max={config.doc_len_max}] and were clipped; the "
            f"realized lengths are biased", stacklevel=2)
    return SyntheticCorpus(words=words.to(dev), mask=mask.to(dev),
                           test_words=t_words.to(dev),
                           test_mask=t_mask.to(dev),
                           beta_star=beta_star.to(dev),
                           alpha_star=config.alpha,
                           length_truncation_frac=trunc_frac,
                           node_topic_weights=(None if weights is None
                                               else weights.to(dev)))


# the fold_in lane of the streaming re-draw keys (the reference's)
_STREAM_SALT = 0x5EA5


@dataclasses.dataclass(frozen=True)
class CorpusStream:
    """A streaming view of a synthetic corpus.

    Segment 0 is the base corpus, ``make_corpus`` with the same (config,
    key, spec). Segment s >= 1 re-draws every node's training shard
    (lengths and words) from ``split(fold_in(fold_in(key, 0x5EA5), s))``
    with beta*, the per-node skew (``alpha_vecs``, the documents' priors
    [n*D, K] on the CPU, None for IID shards) and the held-out set fixed,
    on the CPU, and returns it on the key's device: segment s is a
    function of the stream alone, so a restored run re-draws the shard an
    uninterrupted one used.
    """

    config: LDAConfig
    key: torch.Tensor
    spec: CorpusSpec
    base: SyntheticCorpus
    alpha_vecs: torch.Tensor | None = None

    @property
    def refresh_every(self) -> int:
        return self.spec.refresh_every

    @property
    def n_nodes(self) -> int:
        return self.spec.n_nodes

    def segment(self, s: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(words, mask) ``[n, D, L]`` of streaming segment ``s``."""
        if s < 0:
            raise ValueError(f"segment index must be >= 0, got {s}")
        if s == 0:
            return self.base.words, self.base.mask
        k_seg = tf3.fold_in_data(
            tf3.fold_in_data(self.key.cpu(), _STREAM_SALT), s)
        k_len, k_doc = tf3.split(k_seg)
        words, mask, _ = _draw_training_shards(
            self.config, self.spec, self.base.beta_star.cpu(),
            self.alpha_vecs, k_len, k_doc)
        return words.to(self.key.device), mask.to(self.key.device)


def make_corpus_stream(config: LDAConfig, key: torch.Tensor,
                       spec: CorpusSpec) -> CorpusStream:
    """The streaming corpus of ``spec.refresh_every > 0`` rounds a
    segment, on the key's device."""
    if spec.refresh_every <= 0:
        raise ValueError("make_corpus_stream needs spec.refresh_every > 0 "
                         f"(got {spec.refresh_every}); use make_corpus for "
                         "a frozen corpus")
    return CorpusStream(config=config, key=key, spec=spec,
                        base=make_corpus(config, key, spec),
                        alpha_vecs=_train_alpha_vecs(config, spec, key)[1])


def paper_corpus(key: torch.Tensor, doc_len_max: int = 32
                 ) -> tuple[LDAConfig, SyntheticCorpus]:
    """The exact paper configuration: n=50, 20 docs/node, V=100, K=5."""
    config = LDAConfig(n_topics=5, vocab_size=100, alpha=0.5,
                       doc_len_max=doc_len_max)
    return config, make_corpus(config, key, CorpusSpec())
