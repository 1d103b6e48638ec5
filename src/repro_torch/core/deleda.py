"""DELEDA — Decentralized LDA (paper Algorithm 1 and its asynchronous variant).

The torch counterpart of ``repro.core.deleda`` for simulated gossip on
one device, in the dense and the unique-token corpus layouts. n agents
sit on an undirected graph; each holds a private shard of documents and
a local statistic s_i ``[K, V]``.
Per iteration:

  1. a gossip event mixes statistics: one edge (i, j) activates (the
     paper's Algorithm 1) or a whole random maximal matching fires (the
     synchronous multi-edge round) — :class:`~repro_torch.core.comm.SimComm`,
     the ``gossip_mix`` kernel on the card;
  2. *synchronous*: every node makes a local G-OEM update (eq. 2) on a
     minibatch of its own documents; *asynchronous*: only the awake nodes
     (the activated pair; every matched node of a matching round) update.
     All updating nodes' E-steps are one fused ``[A*B, L]`` sweep call
     (``estep.estep_batch_from_stats``, one ``lda_gibbs`` launch). With
     ``corpus_layout="unique"`` the corpus is converted once to
     (word_id, count) slots and the E-step is one count-weighted
     ``[A*B, U]`` call (``estep.estep_batch_from_stats_unique``, one
     ``lda_sparse`` launch).

The asynchronous variant keeps per-node step counters and, for edge
schedules, the degree correction of Remark 1: node i's step is weighted
by mean_degree / deg(i).

The reference runs the trajectory as one compiled ``lax.scan``; here it
is a Python loop that replays the reference's random streams through
:mod:`.threefry`: the step key is ``fold_in(state.key, t_abs)``, split
into the minibatch key and the E-step key, and node i draws from
``fold_in(·, i)`` of each, by its global id. So the port runs the E-step
only on the nodes that update (the reference computes every node and
keeps the awake ones), with the same draws. Statistics are mixed and
updated in place, and the loop never waits for the card: schedules are
host data, the per-step keys and row indices are made on the device once
per segment.

Not ported yet (later slices): the vocab-sharded carry, churn and
membership (``alive``/``member``), streamed corpora, forgetting
(``decay``) and checkpoints of the :class:`TrainState`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import comm as comm_mod
from repro_torch.core import estep as estep_mod
from repro_torch.core import evaluation as eval_mod
from repro_torch.core import gossip
from repro_torch.core import threefry as tf3
from repro_torch.core.graph import Graph
from repro_torch.core.lda import LDAConfig, init_stats
from repro_torch.core.oem import make_rho_schedule

__all__ = ["DeledaConfig", "TrainState", "SegmentTrace", "DeledaTrace",
           "init_state", "train_steps", "run_deleda", "make_run_inputs",
           "consensus_report"]


@dataclasses.dataclass(frozen=True)
class DeledaConfig:
    """Run configuration for Algorithm 1 (and its async variant)."""

    lda: LDAConfig
    mode: str = "async"              # "sync" | "async"
    batch_size: int = 20             # docs per local update, per node
    rho_kind: str = "power"          # step-size schedule (oem.make_rho_schedule)
    rho_kappa: float = 0.6
    rho_t0: float = 10.0
    eval_every: int = 0              # in-loop held-out LP every this many
                                     # steps (0 = off; needs an EvalSpec and
                                     # a multiple of record_every)
    corpus_layout: str = "dense"     # "dense": per-position sweeps;
                                     # "unique": count-weighted sweeps over
                                     # (word_id, count) slots
    max_unique: int = 0              # U of the unique view (0 = L, always
                                     # enough); more distinct words than U
                                     # in a document drop the overflow

    def __post_init__(self):
        if self.mode not in ("sync", "async"):
            raise ValueError(f"mode must be sync|async, got {self.mode!r}")
        if self.eval_every < 0:
            raise ValueError(f"eval_every must be >= 0, "
                             f"got {self.eval_every}")
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, "
                             f"got {self.batch_size}")
        if self.corpus_layout not in ("dense", "unique"):
            raise ValueError(f"corpus_layout must be dense|unique, "
                             f"got {self.corpus_layout!r}")
        if self.max_unique < 0:
            raise ValueError(f"max_unique must be >= 0 (0 = use L), "
                             f"got {self.max_unique}")
        if self.max_unique and self.corpus_layout != "unique":
            raise ValueError("max_unique only applies to "
                             "corpus_layout='unique'")


@dataclasses.dataclass(frozen=True)
class TrainState:
    """The carried state of one decentralized training run.

    stats          [n, K, V] per-node sufficient statistics;
    steps          [n] int32 per-node local update counters (the async
                   variant's rho_{t_i} clocks);
    key            [2] the run key; step t draws from fold_in(key, t);
    t              the absolute step cursor (rounds consumed), a host int;
    stats_version  bumped once per round (the serving cache's token).
    """

    stats: torch.Tensor
    steps: torch.Tensor
    key: torch.Tensor
    t: int = 0
    stats_version: int = 0

    @property
    def n_nodes(self) -> int:
        return self.stats.shape[0]


class SegmentTrace(NamedTuple):
    """What one ``train_steps`` segment records."""

    history: torch.Tensor          # [R, n, K, V] recorded stats snapshots
    consensus: torch.Tensor        # [R] ||S - mean||_F at each record
    eval_lp: torch.Tensor | None = None   # [E, probe_nodes] in-loop LP


class DeledaTrace(NamedTuple):
    stats: torch.Tensor            # [n, K, V] final per-node statistics
    steps: torch.Tensor            # [n] int32 per-node update counters
    history: torch.Tensor          # [R, n, K, V] recorded snapshots
    consensus: torch.Tensor        # [R] ||S - mean||_F at each record
    eval_lp: torch.Tensor | None = None   # [E, probe_nodes] (eval_every)
    state: TrainState | None = None       # the final carried state


def init_state(config: DeledaConfig, key: torch.Tensor, n: int) -> TrainState:
    """The step-0 :class:`TrainState` of an ``n``-node network.

    ``(k_init, k_run) = split(key)``; node i starts from
    ``init_stats(split(k_init, n)[i])`` and ``k_run`` is the run key, as
    in the reference (its initial statistics are within one ulp of the
    reference's, see ``threefry.exponential``).
    """
    key = tf3.key_data(key)
    k_init, k_run = tf3.split(key)
    stats0 = init_stats(config.lda, tf3.split(k_init, n))     # [n, K, V]
    return TrainState(stats=stats0,
                      steps=torch.zeros((n,), dtype=torch.int32,
                                        device=key.device),
                      key=k_run)


def _update_rows(config, stats, steps, rows, k_sel, k_gibbs, words, mask,
                 corr_t, rho_fn):
    """Fused G-OEM updates (eq. 2) of the nodes ``rows``, in place.

    ``rows`` is a device index ``[A]`` or None for every node. Node i's
    minibatch and E-step draw from ``fold_in(k_sel, i)`` and
    ``fold_in(k_gibbs, i)``, so a node's update does not depend on which
    nodes update beside it. In the unique layout ``words``/``mask`` hold
    the slots' word ids and counts.
    """
    n, d, _l = words.shape
    ids = (torch.arange(n, device=words.device) if rows is None
           else rows)
    idx = tf3.randint(tf3.fold_in_data(k_sel, ids), (config.batch_size,),
                      0, d)                                    # [A, B]
    bw = words[ids[:, None], idx]                              # [A, B, L]
    bm = mask[ids[:, None], idx]
    keys = tf3.fold_in_data(k_gibbs, ids)                      # [A, 2]
    stats_rows = stats if rows is None else stats[rows]
    if config.corpus_layout == "unique":
        stats_hat = estep_mod.estep_batch_from_stats_unique(
            config.lda, keys, bw, bm, stats_rows)
    else:
        stats_hat = estep_mod.estep_batch_from_stats(
            config.lda, keys, bw, bm, stats_rows)             # [A, K, V]
    t = (steps if rows is None else steps[rows]) + 1
    corr_rows = corr_t if rows is None else corr_t[rows]
    rho = torch.clamp((rho_fn(t) * corr_rows).to(stats.dtype), 0.0, 1.0)
    rho = rho[:, None, None]
    # (1 - rho) * s + rho * s_hat, in place and in the reference's order
    new_rows = stats_rows.mul_(1.0 - rho).add_(stats_hat.mul_(rho))
    if rows is None:
        steps.copy_(t)
    else:
        stats[rows] = new_rows
        steps[rows] = t


def _rows_per_step(config: DeledaConfig, schedule: comm_mod.GossipSchedule,
                   device) -> tuple[list, torch.Tensor | None]:
    """Which nodes update at each step: (host counts, device rows [T, m]).

    A count of -1 means every node (sync). Made once per segment, so the
    loop never copies an index from the host.
    """
    n, data = schedule.n_nodes, schedule.data
    t_seg = len(data)
    if config.mode == "sync":
        return [-1] * t_seg, None
    if schedule.kind == comm_mod.EDGE:
        live = data[:, 0] != data[:, 1]
        counts = [2 if x else 0 for x in live]
        rows = data.astype(np.int64)
    else:
        awake = data != np.arange(n)
        counts = [int(c) for c in awake.sum(1)]
        rows = np.zeros((t_seg, n), np.int64)
        for s, a in enumerate(awake):
            rows[s, :counts[s]] = np.nonzero(a)[0]
    return counts, torch.as_tensor(rows, device=device)


def train_steps(config: DeledaConfig, state: TrainState,
                words: torch.Tensor, mask: torch.Tensor,
                schedule: comm_mod.GossipSchedule, corr: torch.Tensor, *,
                record_every: int = 10,
                eval_spec: eval_mod.EvalSpec | None = None
                ) -> tuple[TrainState, SegmentTrace]:
    """Advance ``state`` through one segment of T = len(schedule) rounds.

    words/mask ``[n, D, L]`` on the statistic's device; schedule the
    segment's host :class:`~repro_torch.core.comm.GossipSchedule`; corr
    ``[T, n]`` float32 Remark-1 weights on the device. Every per-step
    input is indexed by the absolute step ``state.t + offset``, so a run
    split into segments gives the same bits as one segment. The unique
    layout converts the corpus once here (``dense_to_unique`` with U =
    ``max_unique`` or L) and the evaluator's documents with U = L, as
    the reference does (its streams depend on that U).
    """
    t_seg = schedule.n_rounds
    if t_seg % record_every != 0:
        raise ValueError(f"segment length {t_seg} must be divisible by "
                         f"record_every={record_every}")
    n, _d, l = words.shape
    if schedule.n_nodes != n:
        raise ValueError(f"schedule has {schedule.n_nodes} nodes, the "
                         f"corpus {n}")
    dev = state.stats.device
    probe = 0
    if config.eval_every:
        if config.eval_every % record_every != 0:
            raise ValueError(
                f"eval_every={config.eval_every} must be a multiple of "
                f"record_every={record_every}")
        if t_seg % config.eval_every != 0:
            raise ValueError(f"segment length {t_seg} must be divisible "
                             f"by eval_every={config.eval_every}")
        if eval_spec is None:
            raise ValueError("config.eval_every > 0 needs an eval_spec "
                             "(repro_torch.core.evaluation.EvalSpec)")
        probe = min(eval_spec.probe_nodes, n)
        ew, em = eval_spec.words, eval_spec.mask
        if eval_spec.layout == "unique":
            ew, em = estep_mod.dense_to_unique(ew, em)
    if config.corpus_layout == "unique":
        words, mask = estep_mod.dense_to_unique(words, mask,
                                                config.max_unique or l)
    comm = comm_mod.SimComm()
    rho_fn = make_rho_schedule(config.rho_kind, kappa=config.rho_kappa,
                               t0=config.rho_t0)
    counts, rows_dev = _rows_per_step(config, schedule, dev)
    step_keys = tf3.fold_in_data(
        state.key, torch.arange(state.t, state.t + t_seg, device=dev))
    stats = state.stats.clone()
    steps = state.steps.clone()
    history = torch.empty((t_seg // record_every,) + tuple(stats.shape),
                          dtype=stats.dtype, device=dev)
    consensus, eval_lp = [], []
    for off in range(t_seg):
        ks = tf3.split(step_keys[off])
        k_sel, k_gibbs = ks[0], ks[1]
        event = schedule.data[off]
        if schedule.kind == comm_mod.EDGE:
            comm.mix_edge(stats, event[0], event[1])
        else:
            comm.mix_matching(stats, event)
        if counts[off] != 0:
            rows = (None if counts[off] < 0
                    else rows_dev[off, :counts[off]])
            _update_rows(config, stats, steps, rows, k_sel, k_gibbs, words,
                         mask, corr[off], rho_fn)
        if (off + 1) % record_every == 0:
            history[off // record_every].copy_(stats)
            consensus.append(gossip.consensus_distance(stats))
        if config.eval_every and (off + 1) % config.eval_every == 0:
            eval_lp.append(eval_mod.heldout_lp_from_stats(
                eval_spec.key, ew, em, stats[:probe], config.lda.tau,
                config.lda.alpha, eval_spec.n_particles, eval_spec.layout))
    new_state = TrainState(stats=stats, steps=steps, key=state.key,
                           t=state.t + t_seg,
                           stats_version=state.stats_version + t_seg)
    return new_state, SegmentTrace(
        history=history, consensus=torch.stack(consensus),
        eval_lp=torch.stack(eval_lp) if eval_lp else None)


def _degree_weights(config: DeledaConfig, degrees, n_steps: int, n: int,
                    kind: str, device) -> torch.Tensor:
    """``[T, n]`` Remark-1 weights: mean degree / deg(i) for async edge
    schedules, 1 otherwise (under matching rounds wake rates are near
    uniform in the degree, so the correction would skew the objective)."""
    deg = torch.as_tensor(np.asarray(degrees), dtype=torch.float32)
    if deg.shape != (n,):
        raise ValueError(f"degrees must be [n={n}], got {tuple(deg.shape)}")
    if config.mode == "async" and kind == comm_mod.EDGE:
        # the mean as XLA computes jnp.mean: the sum times float32(1/n)
        mean = deg.sum() * torch.tensor(1.0 / n, dtype=torch.float32)
        corr = mean / torch.clamp(deg, min=1.0)
    else:
        corr = torch.ones((n,), dtype=torch.float32)
    return corr.to(device).expand(n_steps, n)


def run_deleda(config: DeledaConfig, key: torch.Tensor, words: torch.Tensor,
               mask: torch.Tensor, schedule: comm_mod.GossipSchedule,
               degrees, n_steps: int, record_every: int = 10,
               eval_spec: eval_mod.EvalSpec | None = None,
               init: TrainState | None = None) -> DeledaTrace:
    """Run DELEDA for ``n_steps`` gossip iterations on words' device.

    words/mask ``[n, D, L]`` private documents per node; schedule a
    :class:`~repro_torch.core.comm.GossipSchedule` of ``n_steps`` edge
    events or matching rounds (:func:`make_run_inputs`); degrees ``[n]``
    node degrees
    (the async degree correction). ``config.eval_every = E`` records the
    held-out LP of the first ``eval_spec.probe_nodes`` nodes every E
    steps into ``trace.eval_lp`` ``[n_steps/E, probe_nodes]``. ``init``
    starts from a given state instead of ``init_state(config, key, n)``
    (the tests start from the reference's initial statistic).
    """
    if n_steps % record_every != 0:
        raise ValueError("n_steps must be divisible by record_every")
    n = words.shape[0]
    if schedule.n_rounds != n_steps:
        raise ValueError(f"schedule has {schedule.n_rounds} rounds, "
                         f"n_steps={n_steps}")
    state = (init if init is not None
             else init_state(config, tf3.key_data(key).to(words.device), n))
    corr = _degree_weights(config, degrees, n_steps, n, schedule.kind,
                           words.device)
    state, part = train_steps(config, state, words, mask, schedule, corr,
                              record_every=record_every, eval_spec=eval_spec)
    return DeledaTrace(stats=state.stats, steps=state.steps,
                       history=part.history, consensus=part.consensus,
                       eval_lp=part.eval_lp, state=state)


def make_run_inputs(graph: Graph, n_steps: int, seed: int = 0,
                    kind: str = "edge"
                    ) -> tuple[comm_mod.GossipSchedule, np.ndarray]:
    """(schedule, degrees [n] int32) for :func:`run_deleda`.

    kind="edge" draws [T, 2] single-edge activations (Algorithm 1);
    kind="matching" draws [T, n] random maximal matching rounds. The
    same seed gives the reference's schedule (``.data``).
    """
    rng = np.random.default_rng(seed)
    if kind == "edge":
        sched = comm_mod.GossipSchedule.draw_edges(graph, n_steps, rng)
    elif kind == "matching":
        sched = comm_mod.GossipSchedule.draw_matchings(graph, n_steps, rng)
    else:
        raise ValueError(f"kind must be edge|matching, got {kind!r}")
    return sched, graph.degrees.astype(np.int32)


def consensus_report(trace: DeledaTrace, graph: Graph, config: DeledaConfig,
                     n_steps: int, record_every: int) -> dict:
    """Compare the measured consensus distance with the lambda2 envelope.

    ||G|| is bounded by the largest recorded iterate norm (float64) plus
    one, over all snapshots, as in the reference.
    """
    lam2 = graph.lambda2()
    rho_fn = make_rho_schedule(config.rho_kind, kappa=config.rho_kappa,
                               t0=config.rho_t0)
    rhos = rho_fn(torch.arange(1, n_steps + 1)).numpy()
    hist = trace.history
    g_norm = max(float(torch.linalg.vector_norm(
        h.double().reshape(h.shape[0], -1), dim=-1).max()) for h in hist)
    env = gossip.consensus_envelope(lam2, rhos, g_norm + 1.0)
    env = env[record_every - 1::record_every]
    measured = trace.consensus.double().cpu().numpy()
    return {
        "lambda2": lam2,
        "spectral_gap": 1.0 - lam2,
        "measured": measured,
        "envelope": env,
        "within_envelope_frac": float((measured <= env + 1e-6).mean()),
    }
