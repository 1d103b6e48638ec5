"""Evaluation: streaming, chunk-invariant left-to-right log-likelihoods.

The torch counterpart of ``repro.core.evaluation``
(Wallach et al. 2009, algorithm 3): for a document w_1..w_N,

    p(w | beta, alpha) ~= prod_n (1/P) sum_p p(w_n | z^p_<n, beta, alpha),

resampling every particle's earlier assignments before scoring position n.

* **chunk-invariant streams** — a document's stream is
  ``fold_in(key, doc_id)`` and position n's is ``fold_in(doc_key, n)``
  split into a resample key and a draw key; its estimate does not depend
  on which documents share its batch or on ``chunk_docs``.
* **one estimator, two devices** — :func:`left_to_right_fused` hands the
  doc keys to ``kernels.lda_l2r.ops.l2r_scores``: the CUDA kernel on the
  card, :func:`l2r_position_scores` (the plain version) on the CPU. Both
  return ``[L, B]`` per-position scores, summed here over positions in a
  fixed sequential order.
* **blocked-stats beta** — :func:`ll_slab_from_stats` gathers only the
  O(B*L*K) columns of beta the documents hit, from a dense ``[K, V]`` or
  vocab-sharded ``[K, S, V/S]`` statistic.

* **held-out LP** — :func:`heldout_lp_from_stats` (the in-loop
  evaluator of ``deleda.train_steps``, several probe statistics in one
  kernel launch), :func:`log_perplexity`, :func:`log_perplexity_from_stats`
  and :func:`relative_perplexity_error` (paper Fig. 1a), with
  :class:`EvalSpec` the in-loop request.
* **two layouts** — ``layout="dense"`` scores positions under the 0/1
  mask; ``layout="unique"`` scores (word_id, count) slots under their
  counts, slot n contributing ``c_n * log p``
  (:func:`left_to_right_unique_fused`, the kernel's ``count_weighted``
  mode). :func:`evaluate_heldout` converts dense documents with
  ``estep.unique_view``; :func:`heldout_lp_from_stats` takes the slots
  as given.

The reference's serial estimators (:func:`left_to_right_from_beta_w`,
:func:`left_to_right_unique_from_beta_w`) are bit-compatible with its
fused scan per document, so here they are the fused estimator under
their public names; :func:`left_to_right_log_likelihood` is the public
words-and-beta entry.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import estep as estep_mod
from repro_torch.core import threefry as tf3

__all__ = [
    "EvalSpec", "LAYOUTS", "l2r_position_scores", "left_to_right_fused",
    "left_to_right_unique_fused", "left_to_right_from_beta_w",
    "left_to_right_unique_from_beta_w", "left_to_right_log_likelihood",
    "ll_slab_from_beta",
    "ll_slab_from_stats", "auto_chunk_docs", "evaluate_heldout",
    "heldout_lp_from_stats", "log_perplexity",
    "log_perplexity_from_stats", "relative_perplexity_error",
]


@dataclasses.dataclass(frozen=True)
class EvalSpec:
    """A held-out evaluation request run inside the training loop.

    ``words``/``mask`` are the ``[B, L]`` held-out documents, ``key`` the
    estimator's key (fixed, so the LP trajectory is comparable point to
    point); ``probe_nodes`` leading nodes are evaluated at each point.
    ``layout="unique"`` scores the documents' (word_id, count) view
    (``estep.dense_to_unique`` with U = L, made once per segment).
    """

    words: torch.Tensor
    mask: torch.Tensor
    key: torch.Tensor
    n_particles: int = 10
    probe_nodes: int = 3
    layout: str = "dense"


LAYOUTS = ("dense", "unique")


def _doc_keys(key: torch.Tensor, doc_ids: torch.Tensor) -> torch.Tensor:
    """Per-document key words ``[B, 2]``: ``fold_in(key, doc_id)``."""
    return tf3.fold_in_data(key, doc_ids.to(torch.int64))


def _sum_positions(scores: torch.Tensor) -> torch.Tensor:
    """``[L, B] -> [B]``, summed ((s0 + s1) + s2) + ... per document."""
    acc = scores[0]
    for n in range(1, scores.shape[0]):
        acc = acc + scores[n]
    return acc


def l2r_position_scores(keys_kd: torch.Tensor, beta_w: torch.Tensor,
                        weights: torch.Tensor, alpha: float,
                        n_particles: int,
                        count_weighted: bool = False) -> torch.Tensor:
    """Plain left-to-right scan: per-position scores ``[L, B]``.

    keys_kd ``[B, 2]`` doc-folded key words, beta_w ``[B, L, K]``,
    weights ``[B, L]`` the 0/1 mask or, with ``count_weighted``, the
    unique layout's counts (slot n scores ``c_n * log p``). The function
    of the ``lda_l2r`` kernel: the reference's ``_l2r_fused_core`` before
    its sum over L, with every running sum in the fixed sequential
    association. Position n's resample uniforms are the columns of
    ``uniform(k_rs, (P, L))``, the same bits as the reference's
    ``uniform_column``. Positions past the batch's last weighted one
    score 0 and change nothing a score reads, so the scan stops there.
    """
    b, l, k = beta_w.shape
    p = n_particles
    dt = beta_w.dtype
    alpha_sum = alpha * k
    bw_t = beta_w.transpose(0, 1)                   # [L, B, K]
    w_t = weights.to(dt).T                          # [L, B]
    z = torch.zeros((l, b, p), dtype=torch.int64, device=beta_w.device)
    n_k = torch.zeros((b, p, k), dtype=dt, device=beta_w.device)
    out = torch.zeros((l, b), dtype=dt, device=beta_w.device)
    weighted = torch.nonzero((w_t > 0).any(1))
    end = int(weighted[-1]) + 1 if len(weighted) else 0
    for n in range(end):
        rs_d, dr_d = tf3.split2_data(tf3.fold_in_data(keys_kd, n))
        u_dr = tf3.uniform_halves(dr_d, p)          # [B, P]
        u_rs = tf3.uniform(rs_d, (p, l)) if n else None   # [B, P, L]
        for i in range(n):
            new_z, n_k, _post = estep_mod.gibbs_position_update(
                n_k, z[i], bw_t[i][:, None, :],
                w_t[i][:, None].expand(b, p), u_rs[..., i], alpha)
            z[i] = new_z
        bw_n = bw_t[n]                              # [B, K]
        w_n = w_t[n]                                # [B]
        n_lt = estep_mod.seq_sum(n_k)               # [B, P, 1]
        theta_hat = (n_k + alpha) / (n_lt + alpha_sum)
        p_w = estep_mod.seq_sum(theta_hat * bw_n[:, None, :])[..., 0]
        mean = estep_mod.seq_sum(p_w)[..., 0] / p
        raw = torch.log(torch.clamp(mean, min=1e-30))
        if count_weighted:
            raw = w_n * raw
        out[n] = torch.where(w_n > 0, raw, torch.zeros_like(raw))
        probs_n = (n_k + alpha) * bw_n[:, None, :]
        z_n = estep_mod.sample_from_unnormalized(probs_n, u_dr)
        n_k = n_k + w_n[:, None, None] * estep_mod._one_hot(z_n, k, dt)
        z[n] = torch.where((w_n > 0)[:, None], z_n, z[n])
    return out


def _l2r_fused_core(keys_kd, beta_w, weights, alpha, n_particles,
                    count_weighted=False):
    """Plain ``[B]`` estimates: :func:`l2r_position_scores` summed over L."""
    return _sum_positions(l2r_position_scores(keys_kd, beta_w, weights,
                                              alpha, n_particles,
                                              count_weighted))


def _scores(key, doc_ids, beta_w, weights, alpha, n_particles,
            count_weighted):
    from repro_torch.kernels.lda_l2r import ops as l2r_ops

    scores = l2r_ops.l2r_scores(_doc_keys(key, doc_ids), beta_w,
                                weights.to(beta_w.dtype), alpha,
                                n_particles=n_particles,
                                count_weighted=count_weighted)
    return _sum_positions(scores)


def left_to_right_fused(key: torch.Tensor, doc_ids: torch.Tensor,
                        beta_w: torch.Tensor, mask: torch.Tensor,
                        alpha: float, n_particles: int = 10) -> torch.Tensor:
    """``[B]`` per-document LL estimates from likelihood rows ``[B, L, K]``.

    The ``lda_l2r`` kernel on CUDA tensors, the plain scan on CPU ones.
    """
    return _scores(key, doc_ids, beta_w, mask, alpha, n_particles, False)


def left_to_right_unique_fused(key: torch.Tensor, doc_ids: torch.Tensor,
                               beta_w: torch.Tensor, counts: torch.Tensor,
                               alpha: float,
                               n_particles: int = 10) -> torch.Tensor:
    """``[B]`` LLs of unique-token documents: rows ``[B, U, K]`` of the
    slots' words, ``counts`` ``[B, U]``; slot n scores ``c_n * log p``."""
    return _scores(key, doc_ids, beta_w, counts, alpha, n_particles, True)


def left_to_right_from_beta_w(key: torch.Tensor, doc_ids: torch.Tensor,
                              beta_w: torch.Tensor, mask: torch.Tensor,
                              alpha: float,
                              n_particles: int = 10) -> torch.Tensor:
    """``[B]`` per-document LL estimates from likelihood rows ``[B, L, K]``
    (gathered from a dense beta or a statistic), mask ``[B, L]``, doc_ids
    ``[B]`` the documents' stream identities. The reference's serial
    estimator, which its fused scan equals per document: here the
    ``lda_l2r`` kernel on the card, its plain scan on the CPU."""
    return left_to_right_fused(key, doc_ids, beta_w, mask, alpha,
                               n_particles)


def left_to_right_unique_from_beta_w(key: torch.Tensor,
                                     doc_ids: torch.Tensor,
                                     beta_w: torch.Tensor,
                                     counts: torch.Tensor, alpha: float,
                                     n_particles: int = 10) -> torch.Tensor:
    """The count-weighted twin of :func:`left_to_right_from_beta_w`: rows
    ``[B, U, K]`` of the unique slots' words, counts ``[B, U]`` (0 =
    padding); slot n contributes ``c_n * log p``."""
    return left_to_right_unique_fused(key, doc_ids, beta_w, counts, alpha,
                                      n_particles)


def left_to_right_log_likelihood(key: torch.Tensor, words: torch.Tensor,
                                 mask: torch.Tensor, beta: torch.Tensor,
                                 alpha: float, n_particles: int = 10,
                                 doc_ids: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """``[B]`` per-document log-likelihood estimates of words/mask
    ``[B, L]`` under beta ``[K, V]``. ``doc_ids`` (default ``arange(B)``)
    key the per-document streams: pass global ids to score a slice of a
    larger set with the full batch's bits."""
    if doc_ids is None:
        doc_ids = torch.arange(words.shape[0], device=words.device)
    return left_to_right_fused(key, doc_ids, beta.T[words], mask, alpha,
                               n_particles)


def _ll_from_beta_w(key, doc_ids, beta_w, weights, alpha, n_particles,
                    layout):
    """The estimator of ``layout``; in "unique" the weights are counts."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be dense|unique, got {layout!r}")
    fn = left_to_right_unique_fused if layout == "unique" else \
        left_to_right_fused
    return fn(key, doc_ids, beta_w, weights, alpha, n_particles)


def ll_slab_from_stats(key, doc_ids, words, mask, stats, tau, alpha,
                       n_particles=10, denom=None, layout="dense"):
    """``[C]`` LLs for one slab, beta gathered from the statistic."""
    beta_w = estep_mod.beta_w_from_stats(stats, words, tau, denom=denom)
    return _ll_from_beta_w(key, doc_ids, beta_w, mask, alpha, n_particles,
                           layout)


def ll_slab_from_beta(key, doc_ids, words, mask, beta, alpha,
                      n_particles=10, layout="dense"):
    """``[C]`` LLs for one slab against a dense ``[K, V]`` beta."""
    return _ll_from_beta_w(key, doc_ids, beta.T[words], mask, alpha,
                           n_particles, layout)


_CHUNK_BUDGET_BYTES = 64 << 20


def _z_packing(n_particles: int, k_dim: int) -> tuple[int, int, int]:
    """(bits per assignment, particles per uint32 word, words per doc).

    The reference's packed-z arithmetic, kept so that slab sizes match.
    """
    bits = max(1, (k_dim - 1).bit_length())
    ppw = max(1, 32 // bits)
    return bits, ppw, -(-n_particles // ppw)


def auto_chunk_docs(n_docs: int, doc_len: int, n_particles: int,
                    n_topics: int,
                    budget_bytes: int = _CHUNK_BUDGET_BYTES) -> int:
    """Chunk size whose live eval footprint fits a memory budget.

    The same per-document byte count as the reference, so the port's
    slabs are the reference's slabs.
    """
    _bits, _ppw, n_words = _z_packing(n_particles, n_topics)
    per_doc = 4 * (2 * doc_len * n_topics + doc_len * n_words
                   + 8 * n_particles * n_topics + 4 * n_particles
                   + doc_len)
    return max(1, min(int(budget_bytes) // per_doc, n_docs))


def evaluate_heldout(key: torch.Tensor, words: torch.Tensor,
                     mask: torch.Tensor, *, beta: torch.Tensor | None = None,
                     stats: torch.Tensor | None = None, tau: float = 1e-2,
                     alpha: float, n_particles: int = 10,
                     chunk_docs: int | None = None,
                     layout: str = "dense") -> torch.Tensor:
    """Per-document held-out log-likelihoods ``[B]``.

    Pass exactly one of ``beta=`` ([K, V]) or ``stats=`` ([K, V] or
    [K, S, V/S]). Documents are scored ``chunk_docs`` at a time (default
    from :func:`auto_chunk_docs`), the last chunk padded with empty
    documents; streams are keyed by the global document index, so the
    result is the same for every chunking. ``layout="unique"`` converts
    the documents once to their (word_id, count) view (``unique_view``:
    U the realized maximum) and runs the count-weighted estimator.
    """
    if (beta is None) == (stats is None):
        raise ValueError("pass exactly ONE of beta= or stats=")
    if layout == "unique":
        words, mask = estep_mod.unique_view(words, mask)
    b, l = words.shape
    if chunk_docs is None:
        k_dim = (beta if beta is not None else stats).shape[0]
        c = auto_chunk_docs(b, l, n_particles, k_dim)
    else:
        c = max(1, min(int(chunk_docs), b))
    n_chunks = -(-b // c)
    pad = n_chunks * c - b
    if pad:
        words = torch.cat([words, words.new_zeros((pad, l))])
        mask = torch.cat([mask, mask.new_zeros((pad, l))])
    doc_ids = torch.arange(n_chunks * c, device=words.device)
    lls = []
    for ci in range(n_chunks):
        sl = slice(ci * c, (ci + 1) * c)
        if stats is not None:
            lls.append(ll_slab_from_stats(key, doc_ids[sl], words[sl],
                                          mask[sl], stats, tau, alpha,
                                          n_particles, layout=layout))
        else:
            lls.append(ll_slab_from_beta(key, doc_ids[sl], words[sl],
                                         mask[sl], beta, alpha,
                                         n_particles, layout))
    return torch.cat(lls)[:b]


def _lp_mean(ll: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """LP = -mean log-likelihood over the NON-EMPTY documents (last axis)."""
    return -ll.sum(-1) / estep_mod.count_nonempty(mask).to(ll.dtype)


def heldout_lp_from_stats(key: torch.Tensor, words: torch.Tensor,
                          mask: torch.Tensor, stats: torch.Tensor,
                          tau: float, alpha: float,
                          n_particles: int = 10,
                          layout: str = "dense") -> torch.Tensor:
    """LP straight from a statistic: scalar for stats ``[K, V]``, ``[A]``
    for A statistics ``[A, K, V]`` or vocab-sharded ``[A, K, S, V/S]``
    (a single sharded ``[K, S, V/S]`` goes in as ``stats[None]``).

    The documents of all A statistics go to the estimator as one
    ``[A*B, L]`` batch (one ``lda_l2r`` launch on the card); every
    document keeps its stream ``fold_in(key, doc_id)``, so each LP is the
    one its statistic alone would give. With ``layout="unique"``,
    ``words``/``mask`` are already the (word_id, count) slots.
    """
    if stats.dim() == 2:
        return heldout_lp_from_stats(key, words, mask, stats[None], tau,
                                     alpha, n_particles, layout)[0]
    a, k = stats.shape[:2]
    b, l = words.shape
    beta_w = estep_mod.beta_w_from_stats_batch(
        stats.reshape(a, k, -1), words.expand(a, b, l), tau)
    doc_ids = torch.arange(b, device=words.device).repeat(a)
    ll = _ll_from_beta_w(key, doc_ids, beta_w.reshape(a * b, l, -1),
                         mask.repeat(a, 1), alpha, n_particles, layout)
    return _lp_mean(ll.reshape(a, b), mask)


def log_perplexity(key: torch.Tensor, words: torch.Tensor,
                   mask: torch.Tensor, beta: torch.Tensor, alpha: float,
                   n_particles: int = 10) -> torch.Tensor:
    """Held-out log-perplexity LP = -mean_d log p(X_d | beta), the mean
    over non-empty documents (one estimator call over the whole batch)."""
    doc_ids = torch.arange(words.shape[0], device=words.device)
    ll = ll_slab_from_beta(key, doc_ids, words, mask, beta, alpha,
                           n_particles)
    return _lp_mean(ll, mask)


def log_perplexity_from_stats(key: torch.Tensor, words: torch.Tensor,
                              mask: torch.Tensor, stats: torch.Tensor, *,
                              tau: float = 1e-2, alpha: float,
                              n_particles: int = 10,
                              chunk_docs: int | None = None,
                              layout: str = "dense") -> torch.Tensor:
    """LP through the streaming evaluator (chunked, blocked-stats)."""
    ll = evaluate_heldout(key, words, mask, stats=stats, tau=tau,
                          alpha=alpha, n_particles=n_particles,
                          chunk_docs=chunk_docs, layout=layout)
    return _lp_mean(ll, mask)


def relative_perplexity_error(lp, lp_star):
    """The paper's reported metric: LP / LP* - 1."""
    return lp / lp_star - 1.0
