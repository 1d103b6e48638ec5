"""Latent Dirichlet Allocation model: config, state, M-step, generation.

The torch counterpart of ``repro.core.lda``. A learner carries the K x V
sufficient statistic ``s[k, v]`` (the expected per-document count of
topic k on word v, step-size averaged by online EM); the M-step is row
normalisation of the smoothed statistic,
``beta[k] = (s[k] + tau) / sum_v (s[k] + tau)``. alpha stays fixed.

Random draws take the port's threefry keys (:mod:`.threefry`). The
Dirichlet draws of the generative process use a CPU ``torch.Generator``
seeded from the key's words (the gamma sampler has no threefry replay),
and run on the CPU whatever the key's device: a generated corpus is a
function of the key alone, and only its result moves to the device.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import threefry as tf3

__all__ = [
    "LDAConfig", "LDAState", "init_stats", "init_state", "eta_star",
    "eta_star_denom", "log_eta_star", "sample_topic_matrix",
    "sample_document", "beta_distance", "generator_from_key",
]


@dataclasses.dataclass(frozen=True)
class LDAConfig:
    """Static configuration of an LDA model instance."""

    n_topics: int                  # K
    vocab_size: int                # V
    alpha: float = 0.5             # symmetric Dirichlet prior on theta
    tau: float = 1e-2              # Dirichlet smoothing of the M-step
    n_gibbs: int = 30              # Gibbs sweeps per E-step
    n_gibbs_burnin: int = 15       # sweeps discarded before averaging
    doc_len_max: int = 64          # padded document length (tokens)
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.n_topics < 2:
            raise ValueError(f"n_topics must be >= 2, got {self.n_topics}")
        if self.vocab_size < 2:
            raise ValueError(
                f"vocab_size must be >= 2, got {self.vocab_size}")
        if not 0 < self.n_gibbs_burnin < self.n_gibbs:
            raise ValueError(
                f"need 0 < n_gibbs_burnin < n_gibbs, got "
                f"{self.n_gibbs_burnin} / {self.n_gibbs}")


@dataclasses.dataclass(frozen=True)
class LDAState:
    """Carried state of one G-OEM learner.

    ``stats`` is ``[K, V]`` (or vocab-sharded ``[K, S, V/S]``), ``step``
    and ``stats_version`` are 0-d int32 tensors; ``stats_version`` bumps
    every time ``stats`` changes (the serving cache's staleness key).
    """

    stats: torch.Tensor
    step: torch.Tensor
    stats_version: torch.Tensor

    def beta(self, tau: float = 1e-2) -> torch.Tensor:
        return eta_star(self.stats, tau)


def init_stats(config: LDAConfig, key: torch.Tensor) -> torch.Tensor:
    """Random positive initial statistic s0 ``[..., K, V]``: Dirichlet(1)
    rows, one statistic per leading index of the key ``[..., 2]``.

    Normalised Exponential(1) draws, as the reference draws them.
    """
    g = tf3.exponential(key, (config.n_topics, config.vocab_size))
    return (g / g.sum(dim=-1, keepdim=True)).to(config.dtype)


def init_state(config: LDAConfig, key: torch.Tensor) -> LDAState:
    zero = torch.zeros((), dtype=torch.int32, device=key.device)
    return LDAState(stats=init_stats(config, key), step=zero,
                    stats_version=zero.clone())


def eta_star(stats: torch.Tensor, tau: float = 1e-2) -> torch.Tensor:
    """M-step: row-normalised smoothed statistic (multinomial MLE)."""
    smoothed = stats + tau
    return smoothed / smoothed.sum(dim=-1, keepdim=True)


def eta_star_denom(stats: torch.Tensor, tau: float = 1e-2) -> torch.Tensor:
    """The [K] row normaliser ``sum_v (s[k, v] + tau)``, trailing axes
    flattened — the same reduction as :func:`eta_star`'s row sum."""
    k = stats.shape[0]
    return (stats.reshape(k, -1) + tau).sum(dim=-1)


def log_eta_star(stats: torch.Tensor, tau: float = 1e-2,
                 denom: torch.Tensor | None = None) -> torch.Tensor:
    """``log eta_star(stats)``; ``denom`` optionally the cached normaliser."""
    smoothed = stats + tau
    if denom is None:
        return torch.log(smoothed) - torch.log(
            smoothed.sum(dim=-1, keepdim=True))
    return torch.log(smoothed) - torch.log(denom)[:, None]


def generator_from_key(key: torch.Tensor) -> torch.Generator:
    """A CPU ``torch.Generator`` seeded by the key's two words, on every
    device: CPU and CUDA generators give different streams, so draws are
    made on the CPU and their results moved."""
    words = key.reshape(-1, 2)[0].tolist()
    gen = torch.Generator()
    gen.manual_seed((int(words[0]) << 32) | int(words[1]))
    return gen


def sample_topic_matrix(config: LDAConfig, key: torch.Tensor,
                        concentration: float = 0.1) -> torch.Tensor:
    """Ground-truth topic matrix beta* ~ Dirichlet(concentration)^K,
    drawn on the CPU and returned on the key's device."""
    conc = torch.full((config.n_topics, config.vocab_size), concentration,
                      dtype=torch.float32)
    g = torch._standard_gamma(conc, generator=generator_from_key(key))
    g = torch.clamp(g, min=1e-30)
    beta = (g / g.sum(dim=1, keepdim=True)).to(config.dtype)
    return beta.to(key.device)


def _topic_cdf(beta: torch.Tensor) -> torch.Tensor:
    """Flattened float64 row CDFs of beta, row k shifted up by k.

    One monotone array of K*V values: a draw ``k + u`` lands in row k,
    so every word of a batch is found by one ``searchsorted``.
    """
    cdf = torch.cumsum(beta.double(), dim=-1)
    cdf = cdf / cdf[:, -1:]
    k = beta.shape[0]
    return (cdf + torch.arange(k, dtype=torch.float64,
                               device=beta.device)[:, None]).reshape(-1)


def draw_words(beta: torch.Tensor, z: torch.Tensor,
               gen: torch.Generator) -> torch.Tensor:
    """Words ``w ~ beta[z]`` for topic assignments z (any shape), int64.

    Inverse CDF on each topic's row: the ``[len(z), V]`` logits of a
    categorical draw per token are never built.
    """
    v = beta.shape[1]
    u = torch.rand(z.shape, generator=gen, dtype=torch.float64,
                   device=beta.device)
    idx = torch.searchsorted(_topic_cdf(beta), z.double() + u, right=True)
    return torch.clamp(idx - z * v, 0, v - 1)


def sample_documents(config: LDAConfig, gen: torch.Generator,
                     beta: torch.Tensor, lengths: torch.Tensor,
                     alpha_vec: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """A batch of documents by the LDA generative process.

    lengths ``[D]``; returns (words ``[D, L]`` int64, mask ``[D, L]``
    bool) with tokens past each length masked and set to 0. ``gen`` is a
    CPU generator (:func:`generator_from_key`): the draws run on the CPU,
    from CPU copies of beta and the lengths, and the result lands on
    beta's device.
    """
    d, k, l = lengths.shape[0], config.n_topics, config.doc_len_max
    dev = beta.device
    beta, lengths = beta.cpu(), lengths.cpu()
    if alpha_vec is None:
        alpha_vec = torch.full((k,), config.alpha, dtype=torch.float32)
    g = torch._standard_gamma(alpha_vec.cpu().expand(d, k).contiguous(),
                              generator=gen)
    theta = g / g.sum(dim=-1, keepdim=True)
    z = torch.multinomial(theta, l, replacement=True, generator=gen)
    words = draw_words(beta, z, gen)
    mask = torch.arange(l)[None, :] < lengths[:, None]
    words = torch.where(mask, words, torch.zeros_like(words))
    return words.to(dev), mask.to(dev)


def sample_document(config: LDAConfig, key: torch.Tensor,
                    beta: torch.Tensor, length: int,
                    alpha_vec: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One padded document: (words ``[L]`` int64, mask ``[L]`` bool)."""
    lengths = torch.tensor([int(length)], device=beta.device)
    words, mask = sample_documents(config, generator_from_key(key), beta,
                                   lengths, alpha_vec)
    return words[0], mask[0]


def beta_distance(beta: torch.Tensor,
                  beta_star: torch.Tensor) -> torch.Tensor:
    """D(beta, beta*) = min_M ||M beta - beta*||_F / ||beta*||_F.

    K least-squares problems ``min_m ||beta^T m - beta*_k||`` in one
    ``lstsq``; invariant to row (topic) permutations of beta.
    """
    beta = beta.float()
    beta_star = beta_star.float()
    mt = torch.linalg.lstsq(beta.T, beta_star.T).solution     # [K, K]
    resid = mt.T @ beta - beta_star
    return torch.linalg.norm(resid) / torch.linalg.norm(beta_star)
