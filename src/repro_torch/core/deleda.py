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
schedules, the degree correction of Remark 1 (``degree_correction``):
node i's step t is weighted by the mean degree over deg_t(i), with
degrees ``[n]`` for a static graph or ``[T, n]`` per step for a
time-varying one (:mod:`.scenario`).

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

The lifecycle layer: :func:`run_deleda` drives :func:`train_steps` over a
grid of segments (the gcd of the run, ``save_every``, the stream's
``refresh_every`` and a restore step), swaps a streamed corpus between
segments (``stream=``), saves the carried :class:`TrainState` every
``save_every`` rounds and resumes a killed run from its latest committed
checkpoint (``restore_from=``), bit for bit, since every per-step input
is indexed by the absolute step. Checkpoints use the JAX package's npz
layout (:func:`save_state`, :func:`restore_state`), so either package
resumes the other's. ``decay`` adds Robbins-Monro forgetting to the
blend; ``alive``/``member`` ``[T, n]`` host masks freeze nodes that are
down or not members (they neither mix nor update), folded into the
schedule on the host once per segment.

The scenario layer (:mod:`.scenario`) compiles rewiring graphs, drops,
churn and joins into the schedule, ``[T, n]`` degrees and these masks.

The Scale layer: ``vocab_shards = S`` carries the statistic as
``[n, K, S, V/S]``, a pure layout of the contiguous V axis. The loop
works on its dense ``[n, K, V]`` view (the same storage), so ``SimComm``
mixes it flattened, the E-step gathers and scatters the dense columns and
the trajectory is the ``vocab_shards = 1`` one bit for bit; the trace is
densely shaped, the carried :class:`TrainState` and its checkpoints keep
the sharded shape. :mod:`repro_torch.launch.gossip_sim` runs the same
algorithm with nodes (and vocab blocks) on separate ranks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import checkpoint as ckpt_mod
from repro_torch import convert
from repro_torch import provenance as prov_mod
from repro_torch.core import comm as comm_mod
from repro_torch.core import estep as estep_mod
from repro_torch.core import evaluation as eval_mod
from repro_torch.core import gossip
from repro_torch.core import threefry as tf3
from repro_torch.core.graph import Graph
from repro_torch.core.lda import LDAConfig, init_stats
from repro_torch.core.oem import (forgetting_rho, make_decay_schedule,
                                  make_rho_schedule)

__all__ = ["DeledaConfig", "TrainState", "SegmentTrace", "DeledaTrace",
           "init_state", "state_like", "train_steps", "run_deleda",
           "save_state", "restore_state", "make_run_inputs",
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
    degree_correction: bool = True   # Remark 1 reweighting (async edge
                                     # schedules only); False = weight 1
    eval_every: int = 0              # in-loop held-out LP every this many
                                     # steps (0 = off; needs an EvalSpec and
                                     # a multiple of record_every)
    corpus_layout: str = "dense"     # "dense": per-position sweeps;
                                     # "unique": count-weighted sweeps over
                                     # (word_id, count) slots
    max_unique: int = 0              # U of the unique view (0 = L, always
                                     # enough); more distinct words than U
                                     # in a document drop the overflow
    decay: tuple[float, float] | None = None
                                     # Robbins-Monro forgetting (tau0,
                                     # kappa): the carried statistic is
                                     # discounted by (tau0 + t)^-kappa at
                                     # each local update (oem.forgetting_rho);
                                     # None = the paper's plain eq. (2)
    vocab_shards: int = 1            # Scale layer: the carry is
                                     # [n, K, S, V/S], a layout of V

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
        if self.vocab_shards < 1:
            raise ValueError(f"vocab_shards must be >= 1, "
                             f"got {self.vocab_shards}")
        if self.lda.vocab_size % self.vocab_shards:
            raise ValueError(
                f"vocab_shards={self.vocab_shards} must divide "
                f"vocab_size={self.lda.vocab_size}")
        if self.max_unique < 0:
            raise ValueError(f"max_unique must be >= 0 (0 = use L), "
                             f"got {self.max_unique}")
        if self.max_unique and self.corpus_layout != "unique":
            raise ValueError("max_unique only applies to "
                             "corpus_layout='unique'")
        if self.decay is not None:
            if len(self.decay) != 2:
                raise ValueError(f"decay must be (tau0, kappa), "
                                 f"got {self.decay!r}")
            object.__setattr__(self, "decay",
                               (float(self.decay[0]), float(self.decay[1])))
            make_decay_schedule(*self.decay)   # validates the ranges


@dataclasses.dataclass(frozen=True)
class TrainState:
    """The carried state of one decentralized training run.

    stats          [n, K, V] per-node sufficient statistics, or
                   [n, K, S, V/S] under ``vocab_shards = S``;
    steps          [n] int32 per-node local update counters (the async
                   variant's rho_{t_i} clocks);
    key            [2] the run key; step t draws from fold_in(key, t);
    t              the absolute step cursor (rounds consumed), a host int;
    stats_version  bumped once per round (the serving cache's token);
    member         [n] bool permanent membership at step t, on the stats'
                   device (None: every node);
    cursor         the streamed corpus' segment the last rounds drew
                   from, a host int.
    """

    stats: torch.Tensor
    steps: torch.Tensor
    key: torch.Tensor
    t: int = 0
    stats_version: int = 0
    member: torch.Tensor | None = None
    cursor: int = 0

    def __post_init__(self):
        if self.member is None:
            object.__setattr__(self, "member", torch.ones(
                (self.stats.shape[0],), dtype=torch.bool,
                device=self.stats.device))

    @property
    def n_nodes(self) -> int:
        return self.stats.shape[0]

    def dense_stats(self) -> torch.Tensor:
        """The statistics in the dense [n, K, V] layout."""
        if self.stats.dim() == 4:
            n, k, s, vs = self.stats.shape
            return self.stats.reshape(n, k, s * vs)
        return self.stats


class SegmentTrace(NamedTuple):
    """What one ``train_steps`` segment records."""

    history: torch.Tensor          # [R, n, K, V] recorded stats snapshots
    consensus: torch.Tensor        # [R] member-masked ||S - mean||_F
    eval_lp: torch.Tensor | None = None   # [E, probe_nodes] in-loop LP


class DeledaTrace(NamedTuple):
    stats: torch.Tensor            # [n, K, V] final per-node statistics
                                   # (dense under vocab_shards too)
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
    reference's, see ``threefry.exponential``). Under ``vocab_shards = S``
    the statistic is reshaped to ``[n, K, S, V/S]`` after the draws, as
    in the reference: the same floats.
    """
    key = tf3.key_data(key)
    k_init, k_run = tf3.split(key)
    stats0 = init_stats(config.lda, tf3.split(k_init, n))     # [n, K, V]
    if config.vocab_shards > 1:
        k, v = config.lda.n_topics, config.lda.vocab_size
        stats0 = stats0.reshape(n, k, config.vocab_shards,
                                v // config.vocab_shards)
    return TrainState(stats=stats0,
                      steps=torch.zeros((n,), dtype=torch.int32,
                                        device=key.device),
                      key=k_run)


def state_like(config: DeledaConfig, n: int, device,
               vocab_shards: int = 1) -> TrainState:
    """A :class:`TrainState` of an ``n``-node network that only carries
    shapes and a device: what :func:`restore_state` restores into,
    without the init draws. The statistic is a stride-0 view (no memory);
    ``vocab_shards = S > 1`` shapes it as the reference's vocab-sharded
    carry ``[n, K, S, V/S]``."""
    k, v = config.lda.n_topics, config.lda.vocab_size
    if vocab_shards < 1 or v % vocab_shards:
        raise ValueError(f"vocab_shards={vocab_shards} must divide "
                         f"vocab_size={v}")
    shape = ((n, k, v) if vocab_shards == 1
             else (n, k, vocab_shards, v // vocab_shards))
    return TrainState(
        stats=torch.zeros((), dtype=torch.float32,
                          device=device).expand(shape),
        steps=torch.zeros((n,), dtype=torch.int32, device=device),
        key=torch.zeros((2,), dtype=torch.int64, device=device))


def _update_rows(config, stats, steps, rows, k_sel, k_gibbs, words, mask,
                 corr_t, rho_fn, decay_fn):
    """Fused G-OEM updates (eq. 2) of the nodes ``rows``, in place.

    ``rows`` is a device index ``[A]`` or None for every node. Node i's
    minibatch and E-step draw from ``fold_in(k_sel, i)`` and
    ``fold_in(k_gibbs, i)``, so a node's update does not depend on which
    nodes update beside it. In the unique layout ``words``/``mask`` hold
    the slots' word ids and counts. ``decay_fn`` (or None) folds
    forgetting into the blend weight.
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
    if decay_fn is not None:
        # forgetting, in the reference's order: the carried statistic is
        # discounted by d_t before the blend (oem.forgetting_rho)
        decay = torch.clamp(decay_fn(t), 0.0, 1.0).to(stats.dtype)
        rho = forgetting_rho(rho, decay)
    rho = rho[:, None, None]
    # (1 - rho) * s + rho * s_hat, in place and in the reference's order
    new_rows = stats_rows.mul_(1.0 - rho).add_(stats_hat.mul_(rho))
    if rows is None:
        steps.copy_(t)
    else:
        stats[rows] = new_rows
        steps[rows] = t


def _plan_segment(config: DeledaConfig, schedule: comm_mod.GossipSchedule,
                  live: np.ndarray | None, device
                  ) -> tuple[np.ndarray, list, torch.Tensor | None]:
    """A segment's gossip events and updates, planned on the host once:
    (events, host counts, device rows [T, m]).

    ``live`` [T, n] bool (alive and member) or None for every node. An
    edge event (i, j) is live iff i != j and both ends are live; a dead
    one mixes (i, i), the identity. A matching keeps the pair (i, p[i])
    iff both are live; otherwise i is its own partner. Async updates the
    live event's two ends or the matched nodes, sync every live node. A
    count of -1 means every node (sync with every node live), so the loop
    never copies an index from the host.
    """
    n, data = schedule.n_nodes, schedule.data
    t_seg = len(data)
    ids = np.arange(n)
    if schedule.kind == comm_mod.EDGE:
        src, dst = data[:, 0], data[:, 1]
        ev_live = src != dst
        if live is not None:
            t_idx = np.arange(t_seg)
            ev_live &= live[t_idx, src] & live[t_idx, dst]
        events = np.stack([src, np.where(ev_live, dst, src)], axis=1)
        if config.mode == "async":
            return (events, [2 if x else 0 for x in ev_live],
                    torch.as_tensor(data.astype(np.int64), device=device))
    else:
        events = data
        if live is not None:
            events = np.where(live & np.take_along_axis(live, data, 1), data,
                              ids).astype(np.int32)
    if config.mode == "sync":
        if live is None:
            return events, [-1] * t_seg, None
        upd = live
        counts = [-1 if u.all() else int(u.sum()) for u in upd]
    else:
        upd = events != ids
        counts = [int(u.sum()) for u in upd]
    rows = np.zeros((t_seg, n), np.int64)
    for s, u in enumerate(upd):
        nz = np.nonzero(u)[0]
        rows[s, :len(nz)] = nz
    return events, counts, torch.as_tensor(rows, device=device)


def _check_mask(name: str, x, shape) -> np.ndarray | None:
    if x is None:
        return None
    x = np.asarray(x, dtype=bool)
    if x.shape != shape:
        raise ValueError(f"{name} must be {list(shape)}, got shape "
                         f"{x.shape}")
    return x


def train_steps(config: DeledaConfig, state: TrainState,
                words: torch.Tensor, mask: torch.Tensor,
                schedule: comm_mod.GossipSchedule, corr: torch.Tensor, *,
                record_every: int = 10,
                eval_spec: eval_mod.EvalSpec | None = None,
                live: np.ndarray | None = None,
                member_rec: np.ndarray | None = None
                ) -> tuple[TrainState, SegmentTrace]:
    """Advance ``state`` through one segment of T = len(schedule) rounds.

    words/mask ``[n, D, L]`` on the statistic's device; schedule the
    segment's host :class:`~repro_torch.core.comm.GossipSchedule`; corr
    ``[T, n]`` float32 Remark-1 weights on the device; live ``[T, n]``
    host bool, alive and member (a False node neither mixes nor updates,
    its counter frozen; None = every node); member_rec ``[T/record_every,
    n]`` host bool, membership at each record (the consensus is taken
    over members; None = every node, today's computation). Every
    per-step input is indexed by the absolute step ``state.t + offset``,
    so a run split into segments gives the same bits as one segment. The
    unique layout converts the corpus once here (``dense_to_unique``
    with U = ``max_unique`` or L) and the evaluator's documents with U =
    L, as the reference does (its streams depend on that U). A
    vocab-sharded ``[n, K, S, V/S]`` statistic is trained through its
    dense view; the history is dense, the returned state keeps the shape.
    """
    t_seg = schedule.n_rounds
    if t_seg % record_every != 0:
        raise ValueError(f"segment length {t_seg} must be divisible by "
                         f"record_every={record_every}")
    n, _d, l = words.shape
    if schedule.n_nodes != n:
        raise ValueError(f"schedule has {schedule.n_nodes} nodes, the "
                         f"corpus {n}")
    live = _check_mask("live", live, (t_seg, n))
    member_rec = _check_mask("member_rec", member_rec,
                             (t_seg // record_every, n))
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
    decay_fn = (make_decay_schedule(*config.decay)
                if config.decay is not None else None)
    events, counts, rows_dev = _plan_segment(config, schedule, live, dev)
    members = (None if member_rec is None
               else torch.as_tensor(member_rec, device=dev))
    step_keys = tf3.fold_in_data(
        state.key, torch.arange(state.t, state.t + t_seg, device=dev))
    carry = state.stats.clone(memory_format=torch.contiguous_format)
    stats = carry.view(n, carry.shape[1], -1)        # the dense view
    steps = state.steps.clone()
    history = torch.empty((t_seg // record_every,) + tuple(stats.shape),
                          dtype=stats.dtype, device=dev)
    consensus, eval_lp = [], []
    for off in range(t_seg):
        ks = tf3.split(step_keys[off])
        k_sel, k_gibbs = ks[0], ks[1]
        event = events[off]
        if schedule.kind == comm_mod.EDGE:
            comm.mix_edge(stats, event[0], event[1])
        else:
            comm.mix_matching(stats, event)
        if counts[off] != 0:
            rows = (None if counts[off] < 0
                    else rows_dev[off, :counts[off]])
            _update_rows(config, stats, steps, rows, k_sel, k_gibbs, words,
                         mask, corr[off], rho_fn, decay_fn)
        if (off + 1) % record_every == 0:
            rec = off // record_every
            history[rec].copy_(stats)
            consensus.append(gossip.consensus_distance(
                stats, None if members is None else members[rec]))
        if config.eval_every and (off + 1) % config.eval_every == 0:
            eval_lp.append(eval_mod.heldout_lp_from_stats(
                eval_spec.key, ew, em, stats[:probe], config.lda.tau,
                config.lda.alpha, eval_spec.n_particles, eval_spec.layout))
    new_state = TrainState(
        stats=carry, steps=steps, key=state.key, t=state.t + t_seg,
        stats_version=state.stats_version + t_seg,
        member=state.member if members is None else members[-1].clone(),
        cursor=state.cursor)
    return new_state, SegmentTrace(
        history=history, consensus=torch.stack(consensus),
        eval_lp=torch.stack(eval_lp) if eval_lp else None)


def _degree_weights(config: DeledaConfig, degrees, n_steps: int, n: int,
                    kind: str, device) -> torch.Tensor:
    """``[T, n]`` Remark-1 weights: for async edge schedules with
    ``degree_correction``, step t's mean degree over max(deg[t, i], 1);
    1 otherwise (under matching rounds wake rates are near uniform in the
    degree, so the correction would skew the objective). ``degrees`` is
    ``[n]`` (a static graph) or ``[n_steps, n]`` (per step)."""
    deg = torch.as_tensor(np.asarray(degrees), dtype=torch.float32)
    if deg.shape == (n,):
        deg = deg[None, :]                                  # one row for all
    elif deg.shape != (n_steps, n):
        raise ValueError(f"degrees must be [n={n}] or [{n_steps}, {n}], "
                         f"got shape {tuple(deg.shape)}")
    if config.degree_correction and config.mode == "async" and kind == (
            comm_mod.EDGE):
        # each row's mean as XLA computes jnp.mean: the sum times
        # float32(1/n); a [T, n] that repeats the [n] row gives its bits
        mean = deg.sum(dim=1, keepdim=True) * torch.tensor(
            1.0 / n, dtype=torch.float32)
        corr = mean / torch.clamp(deg, min=1.0)
    else:
        corr = torch.ones((1, n), dtype=torch.float32)
    return corr.to(device).expand(n_steps, n)


def _segment_grid(n_steps: int, record_every: int, eval_every: int,
                  save_every: int, refresh_every: int, t0: int) -> int:
    """The coarsest equal split on which every save, corpus refresh and
    the restore step fall on a boundary (the reference's grid)."""
    seg = n_steps
    for every in (save_every, refresh_every, t0):
        if every:
            seg = math.gcd(seg, every)
    what = (f"the segment grid gcd(n_steps, save_every, refresh_every, "
            f"restore step) = {seg}")
    if seg % record_every != 0:
        raise ValueError(f"{what} must be a multiple of "
                         f"record_every={record_every}")
    if eval_every and seg % eval_every != 0:
        raise ValueError(f"{what} must be a multiple of eval_every="
                         f"{eval_every} (in-loop eval points must fall "
                         f"inside segments)")
    return seg


def run_deleda(config: DeledaConfig, key: torch.Tensor,
               words: torch.Tensor | None, mask: torch.Tensor | None,
               schedule: comm_mod.GossipSchedule, degrees, n_steps: int,
               record_every: int = 10,
               eval_spec: eval_mod.EvalSpec | None = None,
               init: TrainState | None = None, *,
               alive: np.ndarray | None = None,
               member: np.ndarray | None = None, stream=None,
               save_every: int = 0, checkpoint_dir: str | None = None,
               restore_from: str | None = None) -> DeledaTrace:
    """Run DELEDA for ``n_steps`` gossip iterations on the corpus' device.

    words/mask ``[n, D, L]`` private documents per node; schedule a
    :class:`~repro_torch.core.comm.GossipSchedule` of ``n_steps`` edge
    events or matching rounds (:func:`make_run_inputs`, or a compiled
    scenario's ``run_inputs``); degrees ``[n]`` node degrees or
    ``[n_steps, n]`` per-step degrees of a time-varying graph (Remark 1's
    correction, ``config.degree_correction``). ``config.eval_every = E``
    records the held-out LP of the first ``eval_spec.probe_nodes`` nodes
    every E steps into ``trace.eval_lp`` ``[n_steps/E, probe_nodes]``.
    ``init`` starts from a given state instead of ``init_state(config,
    key, n)`` (the tests start from the reference's initial statistic).

    The lifecycle, as in the reference: ``alive``/``member`` ``[n_steps,
    n]`` host bool masks (a node down or not a member neither mixes nor
    updates and keeps its counter; the consensus is over members; None =
    every node, today's bits). ``stream``
    (:func:`repro_torch.data.lda_synthetic.make_corpus_stream`) swaps the
    training corpus every ``stream.refresh_every`` rounds (words/mask may
    then be None; segment 0 is the base corpus). ``save_every`` with
    ``checkpoint_dir`` saves the state at every multiple of
    ``save_every``; ``restore_from`` resumes from the latest committed
    checkpoint there (this package's or the reference's), the stored key
    superseding ``key``, with the bits of the uninterrupted run when the
    same full-horizon schedule, degrees and masks are passed.
    """
    if n_steps % record_every != 0:
        raise ValueError("n_steps must be divisible by record_every")
    if config.eval_every:
        if eval_spec is None:
            raise ValueError("config.eval_every > 0 needs an eval_spec "
                             "(repro_torch.core.evaluation.EvalSpec)")
        if config.eval_every % record_every != 0:
            raise ValueError(
                f"eval_every={config.eval_every} must be a multiple of "
                f"record_every={record_every}")
        if n_steps % config.eval_every != 0:
            raise ValueError(f"n_steps={n_steps} must be divisible by "
                             f"eval_every={config.eval_every}")
    if save_every:
        if checkpoint_dir is None:
            raise ValueError("save_every > 0 needs a checkpoint_dir")
        if save_every % record_every != 0:
            raise ValueError(f"save_every={save_every} must be a multiple "
                             f"of record_every={record_every}")
    if stream is not None:
        if stream.refresh_every % record_every != 0:
            raise ValueError(
                f"stream.refresh_every={stream.refresh_every} must be a "
                f"multiple of record_every={record_every}")
        n, dev = stream.n_nodes, stream.base.words.device
    elif words is not None:
        n, dev = words.shape[0], words.device
    else:
        raise ValueError("pass words/mask or a corpus stream")
    if init is not None and restore_from is not None:
        raise ValueError("pass init or restore_from, not both")
    if schedule.n_rounds != n_steps:
        raise ValueError(f"schedule has {schedule.n_rounds} rounds, "
                         f"n_steps={n_steps}")
    corr = _degree_weights(config, degrees, n_steps, n, schedule.kind, dev)
    alive = _check_mask("alive", alive, (n_steps, n))
    member = _check_mask("member", member, (n_steps, n))
    live = (alive if member is None
            else member if alive is None else alive & member)
    member_rec = (None if member is None
                  else member[record_every - 1::record_every])

    if restore_from is not None:
        state = restore_state(
            restore_from,
            state_like(config, n, dev, vocab_shards=config.vocab_shards),
            config=config)
        t0 = state.t
        if t0 >= n_steps:
            raise ValueError(f"checkpoint at step {t0} has nothing left "
                             f"to run (n_steps={n_steps})")
        if t0 % record_every != 0:
            raise ValueError(f"checkpoint step {t0} is not a multiple of "
                             f"record_every={record_every}")
    else:
        state = (init if init is not None
                 else init_state(config, tf3.key_data(key).to(dev), n))
        t0 = 0
    seg = _segment_grid(n_steps, record_every, config.eval_every,
                        save_every,
                        0 if stream is None else stream.refresh_every, t0)

    parts = []
    cur_words, cur_mask, cur_sidx = words, mask, None
    for t_start in range(t0, n_steps, seg):
        if stream is not None:
            s_idx = t_start // stream.refresh_every
            if s_idx != cur_sidx:
                cur_words, cur_mask = stream.segment(s_idx)
                cur_sidx = s_idx
            state = dataclasses.replace(state, cursor=s_idx)
        sl = slice(t_start, t_start + seg)
        rec = slice(t_start // record_every, (t_start + seg) // record_every)
        state, part = train_steps(
            config, state, cur_words, cur_mask,
            comm_mod.GossipSchedule(
                schedule.kind, schedule.data[sl], n,
                segments=(None if schedule.segments is None
                          else schedule.segments[sl])),
            corr[sl], record_every=record_every, eval_spec=eval_spec,
            live=None if live is None else live[sl],
            member_rec=None if member_rec is None else member_rec[rec])
        parts.append(part)
        if save_every and (t_start + seg) % save_every == 0:
            save_state(checkpoint_dir, state, config=config)

    if len(parts) == 1:
        history, consensus, eval_lp = parts[0]
    else:
        history = torch.cat([p.history for p in parts])
        consensus = torch.cat([p.consensus for p in parts])
        eval_lp = (torch.cat([p.eval_lp for p in parts])
                   if parts[0].eval_lp is not None else None)
    return DeledaTrace(stats=state.dense_stats(), steps=state.steps,
                       history=history, consensus=consensus,
                       eval_lp=eval_lp, state=state)


def save_state(directory: str, state: TrainState,
               config: DeledaConfig | None = None) -> str:
    """Save ``state`` as ``<directory>/step_<t>/state.npz`` in the
    reference's layout (``convert.train_state_to_numpy``). The sidecar
    records ``kind``, ``typed_key`` (true: the port's key mirrors
    ``jax.random.key``) and, given ``config``, its digest. Returns the
    committed npz path."""
    meta = {"typed_key": True, "kind": "deleda_train_state",
            "device": str(state.stats.device)}
    if config is not None:
        meta["config_digest"] = prov_mod.config_digest(config)
    return ckpt_mod.save_checkpoint(
        directory, convert.train_state_to_numpy(state), state.t, meta=meta)


def restore_state(directory: str, like: TrainState,
                  config: DeledaConfig | None = None,
                  step: int | None = None) -> TrainState:
    """Restore a :class:`TrainState` saved by either package.

    ``like`` gives the shapes (a dense or a vocab-sharded statistic: a
    mismatch names the key and both shapes) and the device the arrays
    are placed on (:func:`state_like` builds one without the init
    draws). Either key flavour restores: both store the same bits.
    ``config`` warns when the stored config digest differs.
    """
    shapes = {"stats": like.stats.shape, "steps": like.steps.shape,
              "key": (2,), "t": (), "stats_version": (),
              "member": like.member.shape, "cursor": ()}
    arrays = ckpt_mod.restore_checkpoint(
        directory, shapes, step=step,
        expect_config_digest=(None if config is None
                              else prov_mod.config_digest(config)))
    return convert.train_state_from_numpy(arrays, like.stats.device)


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
