"""Serving layer: node-local topic inference over one statistic.

The torch counterpart of ``repro.core.serving``:

* :class:`ServingState` — the staleness-aware cache of the M-step
  derivations (``eta_star_denom``, ``eta_star``, ``log_eta_star``) of one
  statistic, derived lazily and keyed by a monotonic ``stats_version``;
  ``publish()`` installs a new statistic and bumps the version.
  Vocab-sharded ``[K, S, V/S]`` statistics are served through the
  cached-denominator ``beta_w_from_stats`` gather.
* :class:`TopicServer` — continuous batching of requests into
  length-bucketed ``[C_b, L_b]`` slabs. ``"ll"`` queries run the
  left-to-right estimator (the ``lda_l2r`` kernel on the card);
  ``"mixture"`` queries run a few Gibbs sweeps (``estep.theta_slab``,
  the ``lda_gibbs`` kernel on the card).

A document's answer depends only on ``(key, doc_id, its bucket length)``:
never on arrival order, queue depth or which requests share its slab, and
an ``"ll"`` answer equals ``evaluate_heldout`` on the same documents
padded to the bucket length.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.core import estep as estep_mod
from repro_torch.core import evaluation as eval_mod
from repro_torch.core import lda as lda_mod

__all__ = [
    "QUERY_KINDS", "ServeRequest", "ServeResult", "ServingState",
    "TopicServer", "make_buckets",
]

QUERY_KINDS = ("ll", "mixture")


def make_buckets(doc_len_max: int, n_buckets: int = 3) -> tuple[int, ...]:
    """Ascending halving ladder of bucket lengths, largest = doc_len_max
    (floor of 4 positions); e.g. L=64, 3 buckets -> (16, 32, 64)."""
    if n_buckets < 1:
        raise ValueError(f"n_buckets must be >= 1, got {n_buckets}")
    if doc_len_max < 1:
        raise ValueError(f"doc_len_max must be >= 1, got {doc_len_max}")
    ladder = [int(doc_len_max)]
    while len(ladder) < n_buckets and ladder[-1] > 4:
        nxt = max(4, -(-ladder[-1] // 2))
        if nxt == ladder[-1]:
            break
        ladder.append(nxt)
    return tuple(sorted(ladder))


@dataclasses.dataclass
class ServeRequest:
    """One admitted inference request (internal queue entry)."""

    req_id: int
    doc_id: int
    kind: str                  # "ll" | "mixture"
    words: np.ndarray          # [n_tokens] int32, unpadded
    n_tokens: int
    bucket: int                # L_b the request was admitted into
    t_submit: float            # host clock at admission


@dataclasses.dataclass
class ServeResult:
    """One answered request: a float LL or a [K] numpy mixture."""

    req_id: int
    doc_id: int
    kind: str
    value: np.ndarray | float
    bucket: int
    stats_version: int         # version of the statistic that answered
    t_submit: float
    t_done: float

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit


class ServingState:
    """Staleness-aware cache of the M-step derivations over one statistic.

    stats: dense ``[K, V]`` or vocab-sharded ``[K, S, V/S]`` on the
    device that serves. Derived quantities are computed on first access
    after a ``publish`` and cached; a hit returns the bits a fresh
    recompute would.
    """

    def __init__(self, stats: torch.Tensor, *, tau: float = 1e-2,
                 version: int = 0):
        if stats.ndim not in (2, 3):
            raise ValueError(
                f"stats must be [K, V] or [K, S, V/S], got "
                f"{tuple(stats.shape)}")
        self._stats = stats
        self.tau = float(tau)
        self._version = int(version)
        self._derived_at: int | None = None
        self._denom = None
        self._beta = None
        self._log_beta = None
        self.n_derivations = 0

    @property
    def stats(self) -> torch.Tensor:
        return self._stats

    @property
    def stats_version(self) -> int:
        return self._version

    @property
    def sharded(self) -> bool:
        return self._stats.ndim == 3

    @property
    def n_topics(self) -> int:
        return self._stats.shape[0]

    @property
    def device(self) -> torch.device:
        return self._stats.device

    def publish(self, stats: torch.Tensor, *, version: int | None = None):
        """A gossip round landed: install ``stats``, bump the version."""
        if stats.shape != self._stats.shape:
            raise ValueError(
                f"published stats shape {tuple(stats.shape)} != serving "
                f"shape {tuple(self._stats.shape)}")
        new_version = self._version + 1 if version is None else int(version)
        if new_version <= self._version:
            raise ValueError(
                f"stats_version must be monotonic: got {new_version}, "
                f"currently at {self._version}")
        self._stats = stats
        self._version = new_version

    def _ensure(self):
        if self._derived_at != self._version:
            self._denom = lda_mod.eta_star_denom(self._stats, self.tau)
            self._beta = (None if self.sharded
                          else lda_mod.eta_star(self._stats, self.tau))
            self._log_beta = None
            self._derived_at = self._version
            self.n_derivations += 1

    def denom(self) -> torch.Tensor:
        """Cached [K] M-step row normaliser."""
        self._ensure()
        return self._denom

    def beta(self) -> torch.Tensor:
        """Cached dense ``eta_star(stats)`` ([K, V] statistics only)."""
        if self.sharded:
            raise ValueError(
                "no dense beta is materialized for vocab-sharded stats; "
                "serve through beta_w()/denom() instead")
        self._ensure()
        return self._beta

    def log_eta_star(self) -> torch.Tensor:
        """Cached ``log eta_star(stats)`` over the flattened vocab axis."""
        self._ensure()
        if self._log_beta is None:
            k = self._stats.shape[0]
            self._log_beta = lda_mod.log_eta_star(
                self._stats.reshape(k, -1), self.tau, denom=self._denom)
        return self._log_beta

    def beta_w(self, words: torch.Tensor) -> torch.Tensor:
        """Likelihood rows ``beta[:, words]`` via the cached normaliser."""
        self._ensure()
        return estep_mod.beta_w_from_stats(self._stats, words, self.tau,
                                           denom=self._denom)


class TopicServer:
    """Continuous batching of topic-inference requests over one node.

    ``submit()`` admits a request into the smallest length bucket that
    fits it; ``step()`` packs the deepest (bucket, kind) queue into one
    ``[C_b, L_b]`` slab (unfilled rows are empty documents) and runs it;
    ``drain()`` steps until the queue is empty. A request's stream is
    ``fold_in(key, doc_id)``. ``slabs_by_queue[(L_b, kind)]`` counts the
    slabs dispatched from each queue.
    """

    def __init__(self, state: ServingState, *, alpha: float,
                 key: torch.Tensor, doc_len_max: int,
                 n_particles: int = 10, n_buckets: int = 3,
                 slab_docs: int | None = None, max_slab_docs: int = 64,
                 mixture_sweeps: int = 8, mixture_burnin: int = 4):
        if not 0 <= mixture_burnin < mixture_sweeps:
            raise ValueError(
                f"need 0 <= mixture_burnin < mixture_sweeps, got "
                f"{mixture_burnin} / {mixture_sweeps}")
        self.state = state
        self.alpha = float(alpha)
        self.key = key.to(state.device)
        self.n_particles = int(n_particles)
        self.mixture_sweeps = int(mixture_sweeps)
        self.mixture_burnin = int(mixture_burnin)
        self.buckets = make_buckets(doc_len_max, n_buckets)
        k = state.n_topics
        self.slab_docs = {
            lb: (int(slab_docs) if slab_docs is not None else
                 min(int(max_slab_docs),
                     eval_mod.auto_chunk_docs(10 ** 9, lb,
                                              self.n_particles, k)))
            for lb in self.buckets
        }
        self._pending: dict[tuple[int, str], deque[ServeRequest]] = {
            (lb, kind): deque() for lb in self.buckets
            for kind in QUERY_KINDS
        }
        self._next_id = 0
        self.n_slabs = 0
        self.slabs_by_queue = {qk: 0 for qk in self._pending}
        self.n_served = 0
        self._occupancy_sum = 0.0

    # -- admission ---------------------------------------------------------

    def bucket_for(self, n_tokens: int) -> int:
        """Smallest bucket length >= n_tokens (admission policy)."""
        for lb in self.buckets:
            if n_tokens <= lb:
                return lb
        raise ValueError(
            f"document of {n_tokens} tokens exceeds the largest bucket "
            f"({self.buckets[-1]}); raise doc_len_max/n_buckets or split "
            f"the document")

    def submit(self, words, *, kind: str = "ll",
               doc_id: int | None = None) -> int:
        """Admit one document (1-D token ids). Returns the request id."""
        if kind not in QUERY_KINDS:
            raise ValueError(
                f"query kind must be one of {QUERY_KINDS}, got {kind!r}")
        words = np.asarray(words, np.int32).reshape(-1)
        if words.size == 0:
            raise ValueError("cannot serve an empty document")
        bucket = self.bucket_for(words.size)
        rid = self._next_id
        self._next_id += 1
        req = ServeRequest(
            req_id=rid, doc_id=int(rid if doc_id is None else doc_id),
            kind=kind, words=words, n_tokens=int(words.size),
            bucket=bucket, t_submit=time.perf_counter())
        self._pending[(bucket, kind)].append(req)
        return rid

    def pending_count(self) -> int:
        return sum(len(q) for q in self._pending.values())

    @property
    def mean_occupancy(self) -> float:
        """Mean slab fill fraction over all dispatched slabs."""
        return (self._occupancy_sum / self.n_slabs) if self.n_slabs else 0.0

    # -- dispatch ----------------------------------------------------------

    def _pack(self, reqs: list[ServeRequest], lb: int, c: int):
        words = np.zeros((c, lb), np.int64)
        mask = np.zeros((c, lb), bool)
        doc_ids = np.zeros((c,), np.int64)
        for i, r in enumerate(reqs):
            words[i, :r.n_tokens] = r.words
            mask[i, :r.n_tokens] = True
            doc_ids[i] = r.doc_id
        dev = self.state.device
        return (torch.from_numpy(doc_ids).to(dev),
                torch.from_numpy(words).to(dev),
                torch.from_numpy(mask).to(dev))

    def _run_slab(self, kind: str, doc_ids, words, mask):
        st = self.state
        if kind == "ll":
            if st.sharded:
                return eval_mod.ll_slab_from_stats(
                    self.key, doc_ids, words, mask, st.stats, st.tau,
                    self.alpha, self.n_particles, denom=st.denom())
            return eval_mod.ll_slab_from_beta(
                self.key, doc_ids, words, mask, st.beta(), self.alpha,
                self.n_particles)
        beta_w = st.beta_w(words) if st.sharded else st.beta().T[words]
        return estep_mod.theta_slab(
            self.key, doc_ids, beta_w, mask.to(beta_w.dtype),
            alpha=self.alpha, n_sweeps=self.mixture_sweeps,
            burnin=self.mixture_burnin)

    def step(self) -> list[ServeResult]:
        """Dispatch ONE slab from the deepest queue; [] if nothing waits."""
        depth, chosen = 0, None
        for qk, q in self._pending.items():     # deepest queue; ties ->
            if len(q) > depth:                  # smallest bucket first
                depth, chosen = len(q), qk
        if chosen is None:
            return []
        lb, kind = chosen
        c = self.slab_docs[lb]
        q = self._pending[chosen]
        reqs = [q.popleft() for _ in range(min(c, len(q)))]
        doc_ids, words, mask = self._pack(reqs, lb, c)
        version = self.state.stats_version    # pinned before dispatch
        out = self._run_slab(kind, doc_ids, words, mask).cpu().numpy()
        t_done = time.perf_counter()
        self.n_slabs += 1
        self.slabs_by_queue[chosen] += 1
        self._occupancy_sum += len(reqs) / c
        self.n_served += len(reqs)
        results = []
        for i, r in enumerate(reqs):
            value = float(out[i]) if kind == "ll" else out[i].copy()
            results.append(ServeResult(
                req_id=r.req_id, doc_id=r.doc_id, kind=kind, value=value,
                bucket=lb, stats_version=version, t_submit=r.t_submit,
                t_done=t_done))
        return results

    def drain(self) -> list[ServeResult]:
        """Serve until the admission queue is empty."""
        results = []
        while self.pending_count():
            results.extend(self.step())
        return results
