"""G-OEM E-step: the categorical-sweep core and its front ends.

The torch counterpart of ``repro.core.estep``:

* the **sweep core** — :func:`sample_from_unnormalized` (inverse-CDF
  draw), :func:`gibbs_position_update` (one masked collapsed-Gibbs move)
  and :func:`gibbs_sweeps_dense` (S sweeps over a document batch). This
  is the plain version of the ``lda_gibbs`` CUDA kernel, which performs
  the same float operations in the same order; the two make the same
  draws and agree to one ulp (``chip_smoke.py`` holds them against each
  other on the card).
* the **front end** — :func:`draw_gibbs_randoms` (the reference's PRNG
  stream, replayed through :mod:`.threefry`), :func:`stats_from_per_pos`
  (a deterministic ``[K, V]`` scatter-add), :func:`beta_w_from_stats`,
  :func:`theta_slab` (serving's mixture queries) and the
  :class:`DenseEStep` called by ``oem.oem_update``.
* the **fused multi-node batch** — :func:`fused_sweeps`,
  :func:`estep_batch` and :func:`estep_batch_from_stats`: DELEDA's awake
  nodes' minibatches as one ``[A*B, L]`` sweep call (one kernel launch),
  scattered back into ``[A, K, V]`` per-node statistics.
* the **unique-token (CSR) layout** — :func:`dense_to_unique` /
  :func:`unique_view` turn ``[..., L]`` documents into ``(word_id,
  count)`` pairs padded to U slots; :func:`gibbs_sweeps_sparse` moves all
  ``c`` copies of a word with one count-weighted draw per slot (O(U)
  draws a sweep, not O(L)); :func:`stats_from_unique` is the same
  deterministic scatter on the unique ids; :class:`SparseEStep`,
  :func:`fused_sweeps_sparse` and :func:`estep_batch_from_stats_unique`
  are its front ends (DELEDA's ``corpus_layout="unique"``). With counts
  in {0, 1} the sparse sweeps are the dense sweeps on the sorted
  document, bit for bit.

Dispatch is by device: :func:`theta_slab`, :class:`DenseEStep` and
:func:`fused_sweeps` call
``kernels.lda_gibbs.ops.gibbs_sweeps``, which launches the kernel for
CUDA tensors and runs :func:`gibbs_sweeps_dense` for CPU tensors;
:class:`SparseEStep` and :func:`fused_sweeps_sparse` call
``kernels.lda_sparse.ops.sparse_sweeps`` (the ``lda_sparse`` kernel, or
:func:`gibbs_sweeps_sparse` on the CPU).

One association everywhere. Every running sum over topics is built as
``((p0 + p1) + p2) + ...``: the draw's CDF, its total (also the
Rao-Blackwell normaliser, in both layouts) and the topic sums of
:func:`theta_slab`.
The reference draws with ``jnp.cumsum``, whose association XLA picks, so
a draw can differ from the reference's where ``u * total`` falls within
an ulp of a CDF value; the tests count such ties.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import threefry as tf3
from repro_torch.core.lda import LDAConfig

__all__ = [
    "GibbsResult", "seq_cumsum", "seq_sum", "sample_from_unnormalized",
    "sample_from_unnormalized_seq", "gibbs_position_update",
    "gibbs_sweeps_dense", "gibbs_tie_margins", "draw_gibbs_randoms",
    "count_nonempty", "stats_from_per_pos", "stats_from_per_pos_batch",
    "beta_w_from_stats", "beta_w_from_stats_batch", "theta_slab",
    "DenseEStep", "get_estep", "fused_sweeps", "estep_batch",
    "estep_batch_from_stats", "SparseGibbsResult", "dense_to_unique",
    "unique_view", "stats_from_unique", "gibbs_sweeps_sparse",
    "SparseEStep", "fused_sweeps_sparse",
    "estep_batch_from_stats_unique",
]


class GibbsResult(NamedTuple):
    stats: torch.Tensor   # [K, V] mean per-document sufficient statistics
    z: torch.Tensor       # [B, L] final topic assignments (int64)
    n_dk: torch.Tensor    # [B, K] final doc-topic counts
    theta: torch.Tensor   # [B, K] posterior-mean topic proportions


class SparseGibbsResult(NamedTuple):
    """E-step result in the unique-token layout: ``m[b, u, k]`` is how
    many of slot u's ``c`` copies sit in topic k (``m.sum(-1) == c``)."""

    stats: torch.Tensor   # [K, V] mean per-document sufficient statistics
    m: torch.Tensor       # [B, U, K] final per-slot count splits
    n_dk: torch.Tensor    # [B, K] final doc-topic counts
    theta: torch.Tensor   # [B, K] posterior-mean topic proportions


def _one_hot(z: torch.Tensor, k: int, dtype) -> torch.Tensor:
    return (z[..., None] == torch.arange(k, device=z.device)).to(dtype)


def seq_cumsum(x: torch.Tensor) -> list[torch.Tensor]:
    """Running sums over the last axis, ``((x0 + x1) + x2) + ...``.

    Not ``torch.cumsum``: on the CPU it accumulates float32 in double,
    on the GPU it scans in parallel; neither is the kernels' order.
    """
    cols = x.unbind(-1)
    c = cols[0]
    out = [c]
    for col in cols[1:]:
        c = c + col
        out.append(c)
    return out


def seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Last-axis sum in the fixed sequential association, keepdim.

    A row's sum depends on that row alone, never on the batch it sits in.
    """
    return seq_cumsum(x)[-1][..., None]


def sample_from_unnormalized(probs: torch.Tensor,
                             u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF draw from unnormalised probabilities ``[..., K]``.

    ``count(cum_j < u * total)`` over the sequential running sums.
    """
    cums = torch.stack(seq_cumsum(probs), dim=-1)
    return (cums < (u * cums[..., -1])[..., None]).sum(-1)


# the reference keeps a separate fixed-association variant beside its
# jnp.cumsum draw; in the port every draw already has that association
sample_from_unnormalized_seq = sample_from_unnormalized


def gibbs_position_update(n_dk, zi, bw, mf, u, alpha):
    """One masked collapsed-Gibbs move at one position.

    n_dk ``[..., K]`` counts; zi ``[...]`` current assignments; bw
    ``[..., K]`` likelihood rows; mf ``[...]`` mask; u ``[...]``
    uniforms. Returns (new_z, n_dk, post) with post the Rao-Blackwell
    conditional ``probs / max(total, 1e-30)``.
    """
    k = n_dk.shape[-1]
    n_dk = n_dk - mf[..., None] * _one_hot(zi, k, n_dk.dtype)
    probs = (n_dk + alpha) * bw
    cums = torch.stack(seq_cumsum(probs), dim=-1)
    total = cums[..., -1:]
    new_z = (cums < u[..., None] * total).sum(-1)
    new_z = torch.where(mf > 0, new_z, zi)
    n_dk = n_dk + mf[..., None] * _one_hot(new_z, k, n_dk.dtype)
    post = probs / torch.clamp(total, min=1e-30)
    return new_z, n_dk, post


def gibbs_sweeps_dense(beta_w: torch.Tensor, maskf: torch.Tensor,
                       uniforms: torch.Tensor, z0: torch.Tensor, *,
                       alpha: float, n_sweeps: int, burnin: int
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain Gibbs sweeps over a batch: the ``lda_gibbs`` kernel's function.

    beta_w ``[B, L, K]``, maskf ``[B, L]``, uniforms ``[S, B, L]``, z0
    ``[B, L]``. Returns (per_pos ``[B, L, K]``, z ``[B, L]`` int64,
    ndk_mean ``[B, K]``): the mean Rao-Blackwell conditional over the
    sweeps ``s >= burnin``, the final assignments, and the mean counts.
    """
    b, l, k = beta_w.shape
    n_keep = n_sweeps - burnin
    z = z0.to(torch.int64).clone()
    n_dk = (_one_hot(z, k, beta_w.dtype) * maskf[..., None]).sum(1)
    acc = torch.zeros_like(beta_w)
    ndk_acc = torch.zeros((b, k), dtype=beta_w.dtype, device=beta_w.device)
    for s in range(n_sweeps):
        for i in range(l):
            m = maskf[:, i]
            new_z, n_dk, post = gibbs_position_update(
                n_dk, z[:, i], beta_w[:, i], m, uniforms[s, :, i], alpha)
            if s >= burnin:
                acc[:, i] += m[:, None] * post
            z[:, i] = new_z
        if s >= burnin:
            ndk_acc = ndk_acc + n_dk
    per_pos = acc / n_keep * maskf[..., None]
    return per_pos, z, ndk_acc / n_keep


def gibbs_sweeps_sparse(beta_w: torch.Tensor, countf: torch.Tensor,
                        uniforms: torch.Tensor, z0: torch.Tensor, *,
                        alpha: float, n_sweeps: int, burnin: int
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain count-weighted sweeps: the ``lda_sparse`` kernel's function.

    beta_w ``[B, U, K]`` rows of each slot's word, countf ``[B, U]``
    counts (0 on padding slots), uniforms ``[S, B, U]``, z0 ``[B, U]``.
    All ``c`` copies of a slot share one topic z: each move removes the
    split ``c * onehot(z)`` from n_dk, draws z from ``(n_dk + alpha) *
    beta_w`` and adds ``c * onehot(z)`` back. Returns (per_unique
    ``[B, U, K]``, the mean over kept sweeps of ``c`` times the
    Rao-Blackwell conditional; m ``[B, U, K]`` the final splits;
    ndk_mean ``[B, K]``).
    """
    b, u_dim, k = beta_w.shape
    n_keep = n_sweeps - burnin
    z = z0.to(torch.int64).clone()
    n_dk = (_one_hot(z, k, beta_w.dtype) * countf[..., None]).sum(1)
    acc = torch.zeros_like(beta_w)
    ndk_acc = torch.zeros((b, k), dtype=beta_w.dtype, device=beta_w.device)
    for s in range(n_sweeps):
        for i in range(u_dim):
            c = countf[:, i, None]
            n_dk = n_dk - c * _one_hot(z[:, i], k, n_dk.dtype)
            probs = (n_dk + alpha) * beta_w[:, i]
            cums = torch.stack(seq_cumsum(probs), dim=-1)
            total = cums[..., -1:]
            z[:, i] = (cums < uniforms[s, :, i, None] * total).sum(-1)
            n_dk = n_dk + c * _one_hot(z[:, i], k, n_dk.dtype)
            if s >= burnin:
                acc[:, i] += c * (probs / torch.clamp(total, min=1e-30))
        if s >= burnin:
            ndk_acc = ndk_acc + n_dk
    slotf = (countf > 0).to(beta_w.dtype)
    per_unique = acc / n_keep * slotf[..., None]
    m = countf[..., None] * _one_hot(z, k, beta_w.dtype)
    return per_unique, m, ndk_acc / n_keep


def gibbs_tie_margins(beta_w: torch.Tensor, maskf: torch.Tensor,
                      uniforms: torch.Tensor, z0: torch.Tensor, *,
                      alpha: float, n_sweeps: int) -> torch.Tensor:
    """Per-document smallest tie margin of the plain Gibbs chain, ``[B]``.

    Replays :func:`gibbs_sweeps_dense` and records, over every unmasked
    draw, ``min_j |cum_j - u * total| / total``. A draw whose margin is
    at float32 resolution can go the other way under another summation
    order (the reference's ``jnp.cumsum``): a counted tie, not a fault.
    """
    b, l, k = beta_w.shape
    z = z0.to(torch.int64).clone()
    n_dk = (_one_hot(z, k, beta_w.dtype) * maskf[..., None]).sum(1)
    margin = torch.full((b,), float("inf"), dtype=torch.float64,
                        device=beta_w.device)
    for s in range(n_sweeps):
        for i in range(l):
            m = maskf[:, i]
            n_rm = n_dk - m[:, None] * _one_hot(z[:, i], k, n_dk.dtype)
            cums = torch.stack(seq_cumsum((n_rm + alpha) * beta_w[:, i]), -1)
            total = cums[:, -1:]
            gap = ((cums - uniforms[s, :, i, None] * total).abs()
                   / total).min(-1).values.double()
            margin = torch.where(m > 0, torch.minimum(margin, gap), margin)
            z[:, i], n_dk, _ = gibbs_position_update(
                n_dk, z[:, i], beta_w[:, i], m, uniforms[s, :, i], alpha)
    return margin


def draw_gibbs_randoms(config: LDAConfig, key: torch.Tensor, b: int,
                       l: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The E-step stream: (uniforms ``[..., S, B, L]``, z0 ``[..., B, L]``)
    for a key ``[..., 2]`` (one stream per leading index)."""
    ks = tf3.split(key)
    k_init, k_u = ks[..., 0, :], ks[..., 1, :]
    uniforms = tf3.uniform(k_u, (config.n_gibbs, b, l))
    z0 = tf3.randint(k_init, (b, l), 0, config.n_topics)
    return uniforms, z0


def count_nonempty(mask: torch.Tensor) -> torch.Tensor:
    """Number of documents with >= 1 unmasked position, at least 1.

    mask ``[..., B, L]``; one count per leading index.
    """
    n = (mask.to(torch.float32).sum(-1) > 0).sum(-1)
    return torch.clamp(n, min=1)


def stats_from_per_pos_batch(words: torch.Tensor, per_pos: torch.Tensor,
                             vocab_size: int,
                             maskf: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """Scatter ``[A, B, L, K]`` per-position stats into ``[A, K, V]``
    per-document means, one ``[K, V]`` statistic per leading index.

    One scatter-add over the flat index ``a * V + word``, run under
    deterministic algorithms (on the GPU a sorted, segmented
    accumulation instead of atomics), so a training run gives the same
    bits every time. ``maskf`` ``[A, B, L]`` sets each denominator to the
    number of non-empty documents.
    """
    a, b, _l, k = per_pos.shape
    offs = torch.arange(a, device=words.device)[:, None, None] * vocab_size
    flat_w = (words.to(torch.int64) + offs).reshape(-1)
    flat_p = per_pos.reshape(-1, k)
    acc = torch.zeros((a * vocab_size, k), dtype=per_pos.dtype,
                      device=per_pos.device)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        acc.index_put_((flat_w,), flat_p, accumulate=True)
    finally:
        torch.use_deterministic_algorithms(prev)
    out = acc.view(a, vocab_size, k).transpose(1, 2).contiguous()
    if maskf is None:
        return out.div_(float(b))
    return out.div_(count_nonempty(maskf).to(per_pos.dtype)[:, None, None])


def stats_from_per_pos(words: torch.Tensor, per_pos: torch.Tensor,
                       vocab_size: int,
                       maskf: torch.Tensor | None = None) -> torch.Tensor:
    """Scatter ``[B, L, K]`` per-position stats into the per-doc-mean [K, V].

    :func:`stats_from_per_pos_batch` for one batch; ``maskf`` sets the
    denominator to the number of non-empty documents.
    """
    return stats_from_per_pos_batch(
        words[None], per_pos[None], vocab_size,
        None if maskf is None else maskf[None])[0]


def beta_w_from_stats(stats: torch.Tensor, words: torch.Tensor, tau: float,
                      denom: torch.Tensor | None = None) -> torch.Tensor:
    """Likelihood rows ``beta[:, words]`` gathered from the statistic.

    stats ``[K, V]`` or ``[K, S, V/S]`` (trailing axes flattened), words
    ``[B, L]``; returns ``[B, L, K]`` without building the [K, V] beta.
    ``denom`` is the cached [K] normaliser (``lda.eta_star_denom``).
    """
    k = stats.shape[0]
    return beta_w_from_stats_batch(
        stats.reshape(k, -1)[None], words[None], tau,
        None if denom is None else denom[None])[0]


def _gather_columns(mat: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """``mat[a][:, words[a]]`` moved to ``[A, B, L, K]``, for mat
    ``[A, K, V]`` and words ``[A, B, L]``."""
    a, k, _v = mat.shape
    idx = words.reshape(a, 1, -1).to(torch.int64).expand(a, k, -1)
    cols = torch.gather(mat, 2, idx).transpose(1, 2)             # [A, BL, K]
    return cols.reshape(*words.shape, k)


def beta_w_from_stats_batch(stats: torch.Tensor, words: torch.Tensor,
                            tau: float,
                            denom: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """:func:`beta_w_from_stats` for A statistics at once.

    stats ``[A, K, V]``, words ``[A, B, L]``, ``denom`` the cached
    ``[A, K]`` normalisers or None; returns ``[A, B, L, K]``.
    """
    if denom is None:
        denom = (stats + tau).sum(-1)                            # [A, K]
    cols = _gather_columns(stats, words)
    return (cols + tau) / denom[:, None, None, :]


def theta_slab(key: torch.Tensor, doc_ids: torch.Tensor,
               beta_w: torch.Tensor, maskf: torch.Tensor, *, alpha: float,
               n_sweeps: int, burnin: int) -> torch.Tensor:
    """Posterior topic mixtures ``[B, K]`` for one serving slab.

    A few Gibbs sweeps (the ``lda_gibbs`` kernel on the card) against
    fixed rows ``beta_w``; ``theta = (mean kept n_dk + alpha)``
    normalised. Each document's stream is ``fold_in(key, doc_id)``, so
    its mixture does not depend on the slab it was served in.
    """
    from repro_torch.kernels.lda_gibbs import ops as gibbs_ops

    _b, l, k = beta_w.shape
    keys_d = tf3.fold_in_data(key, doc_ids)              # [B, 2]
    ks = tf3.split(keys_d)                               # same split as
    uniforms = tf3.uniform(ks[:, 1], (n_sweeps, l))      # the trainer
    z0 = tf3.randint(ks[:, 0], (l,), 0, k)
    _per_pos, _z, ndk_mean = gibbs_ops.gibbs_sweeps(
        beta_w, maskf, uniforms.transpose(0, 1).contiguous(), z0,
        alpha=alpha, n_sweeps=n_sweeps, burnin=burnin)
    theta = ndk_mean + alpha
    return theta / seq_sum(theta)


class DenseEStep:
    """The E-step over dense ``[B, L]`` documents (device-dispatched sweeps)."""

    name = "dense"

    def __call__(self, config: LDAConfig, key: torch.Tensor,
                 words: torch.Tensor, mask: torch.Tensor,
                 beta: torch.Tensor) -> GibbsResult:
        """Run the E-step on a batch: words/mask ``[B, L]``, beta ``[K, V]``."""
        from repro_torch.kernels.lda_gibbs import ops as gibbs_ops

        b, l = words.shape
        k = config.n_topics
        uniforms, z0 = draw_gibbs_randoms(config, key, b, l)
        beta_w = beta.T[words]                                # [B, L, K]
        maskf = mask.to(beta.dtype)
        per_pos, z, ndk_mean = gibbs_ops.gibbs_sweeps(
            beta_w, maskf, uniforms, z0, alpha=config.alpha,
            n_sweeps=config.n_gibbs, burnin=config.n_gibbs_burnin)
        stats = stats_from_per_pos(words, per_pos, config.vocab_size, maskf)
        n_dk = (_one_hot(z, k, beta.dtype) * maskf[..., None]).sum(1)
        theta = ndk_mean + config.alpha
        return GibbsResult(stats=stats, z=z, n_dk=n_dk,
                           theta=theta / seq_sum(theta))


def get_estep() -> DenseEStep:
    """The E-step; only the dense corpus layout is ported."""
    return DenseEStep()


# ----------------------------------------------------------------------------
# Fused multi-node batch path (DELEDA's local updates)
# ----------------------------------------------------------------------------

def fused_sweeps(config: LDAConfig, keys: torch.Tensor,
                 beta_w: torch.Tensor, maskf: torch.Tensor) -> torch.Tensor:
    """A nodes' minibatches as ONE ``[A*B, L]`` sweep call.

    keys ``[A, 2]`` per-node streams, beta_w ``[A, B, L, K]`` likelihood
    rows, maskf ``[A, B, L]``. Returns per-position statistics
    ``[A, B, L, K]``: one ``lda_gibbs`` launch on the card. Every sweep
    operation is per document, so fusing the nodes changes no bits.
    """
    from repro_torch.kernels.lda_gibbs import ops as gibbs_ops

    a, b, l, k = beta_w.shape
    s = config.n_gibbs
    uniforms, z0 = draw_gibbs_randoms(config, keys, b, l)  # [A, S, B, L]
    per_pos, _z, _ndk = gibbs_ops.gibbs_sweeps(
        beta_w.reshape(a * b, l, k), maskf.reshape(a * b, l),
        uniforms.transpose(0, 1).reshape(s, a * b, l),
        z0.reshape(a * b, l), alpha=config.alpha, n_sweeps=s,
        burnin=config.n_gibbs_burnin)
    return per_pos.reshape(a, b, l, k)


def estep_batch(config: LDAConfig, keys: torch.Tensor, words: torch.Tensor,
                mask: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """All awake nodes' E-steps as one fused sweep call.

    keys ``[A, 2]`` (the caller's ``fold_in(key, node_id)`` streams),
    words/mask ``[A, B, L]``, beta ``[A, K, V]``; returns per-node
    statistics ``[A, K, V]``.
    """
    beta_w = _gather_columns(beta, words)
    maskf = mask.to(beta.dtype)
    per_pos = fused_sweeps(config, keys, beta_w, maskf)
    return stats_from_per_pos_batch(words, per_pos, config.vocab_size,
                                    maskf)


def estep_batch_from_stats(config: LDAConfig, keys: torch.Tensor,
                           words: torch.Tensor, mask: torch.Tensor,
                           stats: torch.Tensor) -> torch.Tensor:
    """Fused E-steps reading the topic matrix straight from the statistic.

    Gathers only the minibatch's ``beta[:, words]`` columns from stats
    ``[A, K, V]`` (:func:`beta_w_from_stats_batch`) instead of building
    ``eta_star`` ``[A, K, V]``; the same values as :func:`estep_batch`
    with ``beta = eta_star(stats, tau)``. Returns ``[A, K, V]``.
    """
    beta_w = beta_w_from_stats_batch(stats, words, config.tau)
    maskf = mask.to(beta_w.dtype)
    per_pos = fused_sweeps(config, keys, beta_w, maskf)
    return stats_from_per_pos_batch(words, per_pos, config.vocab_size,
                                    maskf)


# ----------------------------------------------------------------------------
# Unique-token (CSR) corpus layout
# ----------------------------------------------------------------------------

def dense_to_unique(words: torch.Tensor, mask: torch.Tensor,
                    max_unique: int | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``[..., L]`` documents -> per-document (word_id, count) ``[..., U]``.

    Sorts each document's unmasked tokens (masked ones to a sentinel past
    every word id), marks where the sorted value changes and scatters
    segment lengths into U = ``max_unique`` slots (default U = L, always
    enough). Returns (uw ascending word ids, counts), both int64, with
    padding slots (0, 0). A document with more than U distinct words
    drops the overflow, as in the reference.
    """
    lead, l = words.shape[:-1], words.shape[-1]
    u_dim = l if max_unique is None else int(max_unique)
    w2 = words.reshape(-1, l).to(torch.int64)
    m2 = mask.reshape(-1, l).to(torch.bool)
    b = w2.shape[0]
    sentinel = torch.iinfo(torch.int64).max
    sw = torch.where(m2, w2, torch.full_like(w2, sentinel)).sort(-1).values
    valid = sw != sentinel
    first = valid.clone()
    first[:, 1:] &= sw[:, 1:] != sw[:, :-1]
    seg = first.cumsum(-1) - 1
    # padding and overflow tokens land in a throwaway slot u_dim
    seg = torch.where(valid & (seg < u_dim), seg, torch.full_like(seg, u_dim))
    counts = torch.zeros((b, u_dim + 1), dtype=torch.int64,
                         device=words.device)
    counts.scatter_add_(1, seg, valid.to(torch.int64))
    uw = torch.zeros_like(counts).scatter_reduce_(
        1, seg, torch.where(valid, sw, torch.zeros_like(sw)), "amax")
    return (uw[:, :u_dim].reshape(lead + (u_dim,)),
            counts[:, :u_dim].reshape(lead + (u_dim,)))


def unique_view(words: torch.Tensor, mask: torch.Tensor,
                max_unique: int | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`dense_to_unique` trimmed to the realized maximum U (one
    host read), so the sweeps do O(realized U) work, not O(L)."""
    uw, counts = dense_to_unique(words, mask, max_unique)
    u_true = max(int((counts > 0).sum(-1).max()), 1)
    return uw[..., :u_true], counts[..., :u_true]


def stats_from_unique(uw: torch.Tensor, per_unique: torch.Tensor,
                      vocab_size: int,
                      countf: torch.Tensor | None = None) -> torch.Tensor:
    """Scatter ``[B, U, K]`` per-slot stats into the per-doc-mean [K, V].

    The rows already carry their slot's token mass, so this is
    :func:`stats_from_per_pos` on the unique ids: given equal mass per
    word the two layouts give the same bits. ``countf`` sets the
    denominator to the documents with any positive count.
    """
    return stats_from_per_pos(uw, per_unique, vocab_size, countf)


class SparseEStep:
    """The E-step over unique-token documents (device-dispatched sweeps).

    Uniforms and z0 are drawn per slot (``[S, B, U]`` / ``[B, U]``) from
    the dense E-step's two-way key split.
    """

    name = "unique"

    def __call__(self, config: LDAConfig, key: torch.Tensor,
                 uw: torch.Tensor, counts: torch.Tensor,
                 beta: torch.Tensor) -> SparseGibbsResult:
        """uw/counts ``[B, U]`` (count 0 = padding), beta ``[K, V]``."""
        from repro_torch.kernels.lda_sparse import ops as sparse_ops

        b, u_dim = uw.shape
        countf = counts.to(beta.dtype)
        uniforms, z0 = draw_gibbs_randoms(config, key, b, u_dim)
        per_unique, m, ndk_mean = sparse_ops.sparse_sweeps(
            beta.T[uw], countf, uniforms, z0, alpha=config.alpha,
            n_sweeps=config.n_gibbs, burnin=config.n_gibbs_burnin)
        stats = stats_from_unique(uw, per_unique, config.vocab_size, countf)
        theta = ndk_mean + config.alpha
        return SparseGibbsResult(stats=stats, m=m, n_dk=m.sum(1),
                                 theta=theta / seq_sum(theta))


def fused_sweeps_sparse(config: LDAConfig, keys: torch.Tensor,
                        beta_w: torch.Tensor,
                        countf: torch.Tensor) -> torch.Tensor:
    """A nodes' unique-token minibatches as ONE ``[A*B, U]`` sweep call.

    keys ``[A, 2]``, beta_w ``[A, B, U, K]``, countf ``[A, B, U]``;
    returns per-slot statistics ``[A, B, U, K]`` (token mass folded in):
    one ``lda_sparse`` launch on the card.
    """
    from repro_torch.kernels.lda_sparse import ops as sparse_ops

    a, b, u_dim, k = beta_w.shape
    s = config.n_gibbs
    uniforms, z0 = draw_gibbs_randoms(config, keys, b, u_dim)
    per_unique, _m, _ndk = sparse_ops.sparse_sweeps(
        beta_w.reshape(a * b, u_dim, k), countf.reshape(a * b, u_dim),
        uniforms.transpose(0, 1).reshape(s, a * b, u_dim),
        z0.reshape(a * b, u_dim), alpha=config.alpha, n_sweeps=s,
        burnin=config.n_gibbs_burnin)
    return per_unique.reshape(a, b, u_dim, k)


def estep_batch_from_stats_unique(config: LDAConfig, keys: torch.Tensor,
                                  uw: torch.Tensor, counts: torch.Tensor,
                                  stats: torch.Tensor) -> torch.Tensor:
    """Fused unique-layout E-steps reading beta from the statistic.

    uw/counts ``[A, B, U]``, stats ``[A, K, V]``; gathers only the
    O(A*B*U*K) columns the slots hit and returns ``[A, K, V]``.
    """
    beta_w = beta_w_from_stats_batch(stats, uw, config.tau)
    countf = counts.to(beta_w.dtype)
    per_unique = fused_sweeps_sparse(config, keys, beta_w, countf)
    return stats_from_per_pos_batch(uw, per_unique, config.vocab_size,
                                    countf)
