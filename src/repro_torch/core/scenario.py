"""Scenario layer: time-varying graphs, node churn and message drops.

The port's own copy of ``repro.core.scenario`` (plain numpy; the port
imports nothing of the JAX package). Given the same
``np.random.Generator`` it draws the reference's arrays bit for bit: the
schedule (with its ``segments``), alive, degrees, member and every event
count, because it makes the same draws in the same order (the schedule
per segment, the churn chains, the cold-join sponsors, the drop coins).

Every dynamic effect compiles on the host into plain schedule data:

* :class:`GraphSequence`, a piecewise-constant topology: ``graphs[s]``
  is live for ``segment_steps[s]`` rounds; each segment's rounds are
  drawn from its own graph, and ``degrees()`` gives the per-round
  ``[T, n]`` degrees that drive Remark 1 under async edge events.
* Unreliable communication: per-event Bernoulli message drops and
  per-node churn (a two-state Markov chain with a stationary down
  fraction and a mean down spell). A dropped or churned matching pair
  becomes self-partners and a dropped edge event the ``(i, i)``
  sentinel; churn also gives the ``alive [T, n]`` mask.
* Non-IID shards: ``topic_skew`` is carried here and handed to
  ``data.lda_synthetic.CorpusSpec.topic_skew``.
* Permanent membership: ``joins`` / ``leaves`` (node, step) events give
  the ``member [T, n]`` mask; at a join the compiler re-pairs the joiner
  with a live member neighbour (its sponsor), so its first mix is the
  handoff, exempt from drops.

Typical use::

    seq = GraphSequence.rewiring(
        lambda s: watts_strogatz_graph(50, 4, 0.3, seed=s),
        n_segments=5, steps_per_segment=60)
    sc = Scenario(topology=seq, drop_prob=0.1, churn=0.2,
                  joins=((49, 150),))
    sched, degs, alive, member = sc.compile(
        np.random.default_rng(0)).run_inputs()
    trace = run_deleda(cfg, key, words, mask, sched, degs, seq.n_steps,
                       alive=alive, member=member)

Unlike the reference, :meth:`CompiledScenario.run_inputs` returns host
arrays: the port's ``run_deleda`` plans the masks on the host once per
segment.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np

from repro_torch.core.comm import EDGE, MATCHING, GossipSchedule
from repro_torch.core.graph import Graph, watts_strogatz_graph

__all__ = ["GraphSequence", "CompiledScenario", "Scenario",
           "SCENARIO_NAMES", "paper_scenario"]


# ----------------------------------------------------------------------------
# Time-varying topologies
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GraphSequence:
    """A piecewise-constant time-varying communication graph.

    ``graphs[s]`` is the live topology for ``segment_steps[s]`` consecutive
    gossip rounds; total horizon ``n_steps = sum(segment_steps)``.
    """

    graphs: tuple
    segment_steps: tuple
    name: str = "sequence"

    def __post_init__(self):
        graphs = tuple(self.graphs)
        steps = tuple(int(t) for t in self.segment_steps)
        if not graphs or len(graphs) != len(steps):
            raise ValueError(
                f"need equally many graphs and segment_steps, got "
                f"{len(graphs)} graphs / {len(steps)} segments")
        if any(t <= 0 for t in steps):
            raise ValueError(f"segment_steps must be positive, got {steps}")
        n = graphs[0].n_nodes
        if any(g.n_nodes != n for g in graphs):
            raise ValueError("all graphs must share n_nodes")
        object.__setattr__(self, "graphs", graphs)
        object.__setattr__(self, "segment_steps", steps)

    @property
    def n_nodes(self) -> int:
        return self.graphs[0].n_nodes

    @property
    def n_segments(self) -> int:
        return len(self.graphs)

    @property
    def n_steps(self) -> int:
        return sum(self.segment_steps)

    def segment_ids(self) -> np.ndarray:
        """[T] int32: which segment each round belongs to."""
        return np.repeat(np.arange(self.n_segments, dtype=np.int32),
                         self.segment_steps)

    def degrees(self) -> np.ndarray:
        """[T, n] int32 per-round node degrees (piecewise constant)."""
        per_seg = np.stack([g.degrees.astype(np.int32)
                            for g in self.graphs])          # [S, n]
        return np.repeat(per_seg, self.segment_steps, axis=0)

    def graph_at(self, t: int) -> Graph:
        return self.graphs[int(self.segment_ids()[t])]

    # -- constructors --------------------------------------------------------

    @staticmethod
    def static(graph: Graph, n_steps: int) -> "GraphSequence":
        """The degenerate single-segment sequence (a static graph)."""
        return GraphSequence((graph,), (n_steps,), name=f"static:{graph.name}")

    @staticmethod
    def rewiring(factory: Callable[[int], Graph], n_segments: int,
                 steps_per_segment: int, seed: int = 0) -> "GraphSequence":
        """Independent re-draws of a random topology, one per segment.

        ``factory(seed_s)`` builds segment s's graph; e.g.
        ``lambda s: watts_strogatz_graph(50, 4, 0.3, seed=s)``.
        """
        graphs = tuple(factory(seed + s) for s in range(n_segments))
        return GraphSequence(graphs, (steps_per_segment,) * n_segments,
                             name=f"rewiring:{graphs[0].name}x{n_segments}")

    # -- schedule drawing ----------------------------------------------------

    def draw_schedule(self, kind: str, rng: np.random.Generator
                      ) -> GossipSchedule:
        """Pre-draw one schedule for the whole horizon, per-segment.

        Each segment's rounds are drawn from *that segment's* graph, in
        segment order from one generator, then concatenated into one
        [T, ...] array with a ``segments`` axis.
        """
        parts = []
        for g, t in zip(self.graphs, self.segment_steps):
            if kind == EDGE:
                parts.append(GossipSchedule.draw_edges(g, t, rng).data)
            elif kind == MATCHING:
                parts.append(GossipSchedule.draw_matchings(g, t, rng).data)
            else:
                raise ValueError(f"kind must be edge|matching, got {kind!r}")
        return GossipSchedule(kind, np.concatenate(parts, axis=0),
                              self.n_nodes, segments=self.segment_ids())


# ----------------------------------------------------------------------------
# Scenario = topology sequence + unreliability knobs + data skew
# ----------------------------------------------------------------------------

class CompiledScenario(NamedTuple):
    """Host-side artifacts of Scenario.compile — plain schedule data."""

    schedule: GossipSchedule   # drops/churn already applied (no-op encoded)
    alive: np.ndarray          # [T, n] bool; False = node down that round
    degrees: np.ndarray        # [T, n] int32 per-round degrees
    n_events: int              # gossip events drawn before masking
    n_dropped: int             # events removed by Bernoulli message drops
    n_churned: int             # events removed because an endpoint was down
    member: np.ndarray | None = None   # [T, n] bool permanent membership
                                       # (None = no join/leave events —
                                       # run_deleda's original path)
    n_excluded: int = 0        # events removed because an endpoint was
                               # not (yet / anymore) a member
    n_sponsored: int = 0       # cold joins that got a planted handoff pair

    def run_inputs(self):
        """(schedule, degrees, alive, member) for the port's
        ``run_deleda``: the host :class:`GossipSchedule` with its
        ``segments``, numpy ``degrees`` [T, n] and numpy ``alive`` /
        ``member`` [T, n] (member None when the scenario has no join or
        leave). They stay on the host: ``run_deleda`` folds the masks into
        the schedule there, once per segment."""
        return self.schedule, self.degrees, self.alive, self.member


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named dynamic-network regime for DELEDA runs.

    drop_prob:        per-event Bernoulli probability a gossip exchange is
                      lost (the pair neither mixes nor — async — wakes).
    churn:            stationary fraction of nodes that are down at any
                      round (two-state Markov process per node).
    churn_mean_down:  mean length of a down spell, in rounds.
    topic_skew:       Dirichlet concentration of the per-node topic-weight
                      draw in data/lda_synthetic (None = IID shards);
                      carried here so one object describes the whole regime.
    joins:            ((node, step), ...) PERMANENT cold joins: the node is
                      not a member before ``step`` (frozen, excluded from
                      consensus); at ``step`` the compiler plants a
                      sponsor pairing so its first gossip round is the
                      state handoff.
    leaves:           ((node, step), ...) permanent departures: the node's
                      last member round is ``step - 1`` and it never
                      returns.
    """

    topology: GraphSequence
    kind: str = MATCHING           # schedule granularity: "matching" | "edge"
    drop_prob: float = 0.0
    churn: float = 0.0
    churn_mean_down: float = 10.0
    topic_skew: float | None = None
    joins: tuple = ()
    leaves: tuple = ()
    name: str = "scenario"

    def __post_init__(self):
        if self.kind not in (EDGE, MATCHING):
            raise ValueError(f"kind must be edge|matching, got {self.kind!r}")
        if not 0.0 <= self.drop_prob < 1.0:
            raise ValueError(f"drop_prob must be in [0, 1), {self.drop_prob}")
        if not 0.0 <= self.churn < 1.0:
            raise ValueError(f"churn must be in [0, 1), got {self.churn}")
        if self.churn_mean_down < 1.0:
            raise ValueError("churn_mean_down must be >= 1 round")
        if self.churn > 0:
            q = self.churn / ((1.0 - self.churn) * self.churn_mean_down)
            if q > 1.0:
                raise ValueError(
                    f"churn={self.churn} with mean down spell "
                    f"{self.churn_mean_down} needs P(up->down)={q:.2f} > 1; "
                    f"lower churn or raise churn_mean_down")
        n, t = self.topology.n_nodes, self.topology.n_steps
        joins = tuple((int(i), int(s)) for i, s in self.joins)
        leaves = tuple((int(i), int(s)) for i, s in self.leaves)
        object.__setattr__(self, "joins", joins)
        object.__setattr__(self, "leaves", leaves)
        for label, events, lo, hi in (("join", joins, 0, t - 1),
                                      ("leave", leaves, 1, t)):
            nodes = [i for i, _ in events]
            if len(nodes) != len(set(nodes)):
                raise ValueError(f"at most one {label} event per node, "
                                 f"got {events}")
            for i, s in events:
                if not 0 <= i < n:
                    raise ValueError(f"{label} node {i} outside [0, {n})")
                if not lo <= s <= hi:
                    raise ValueError(f"{label} step {s} outside "
                                     f"[{lo}, {hi}] for horizon {t}")
        join_at = dict(joins)
        for i, s in leaves:
            if i in join_at and join_at[i] >= s:
                raise ValueError(f"node {i} joins at {join_at[i]} but "
                                 f"leaves at {s}; join must come first")

    @property
    def n_steps(self) -> int:
        return self.topology.n_steps

    # -- permanent membership ------------------------------------------------

    def member_mask(self) -> np.ndarray:
        """[T, n] bool: membership per round (monotone per node).

        A joiner at (i, s) is a member FROM round s inclusive — its join
        round is its handoff mix; a leaver at (i, s) is a member UP TO
        round s - 1.
        """
        t, n = self.n_steps, self.topology.n_nodes
        member = np.ones((t, n), bool)
        for i, s in self.joins:
            member[:s, i] = False
        for i, s in self.leaves:
            member[s:, i] = False
        return member

    # -- churn process -------------------------------------------------------

    def draw_alive(self, rng: np.random.Generator) -> np.ndarray:
        """[T, n] bool up/down trajectories of the per-node Markov chain.

        P(down->up) = 1/churn_mean_down; P(up->down) is set so the
        stationary down fraction equals ``churn``; the chain starts in its
        stationary distribution.
        """
        t, n = self.n_steps, self.topology.n_nodes
        if self.churn <= 0.0:
            return np.ones((t, n), bool)
        r = 1.0 / self.churn_mean_down                 # down -> up
        q = self.churn * r / (1.0 - self.churn)        # up -> down
        alive = np.empty((t, n), bool)
        state = rng.random(n) >= self.churn            # stationary init
        for step in range(t):
            alive[step] = state
            u = rng.random(n)
            state = np.where(state, u >= q, u < r)
        return alive

    # -- compilation ---------------------------------------------------------

    def _plant_sponsors(self, data: np.ndarray, alive: np.ndarray,
                        member: np.ndarray, rng: np.random.Generator
                        ) -> tuple[np.ndarray, int]:
        """Re-pair each joiner with a live member neighbor at its join round.

        The handoff is an ORDINARY gossip event — the joiner's first mix
        averages its init statistics with the sponsor's blended ones, so
        it inherits the network's state through the existing comm path.
        Returns (protected mask, n_sponsored); protected events are exempt
        from Bernoulli drops (the join is deliberate, not best-effort).
        No sponsor is planted when the joiner is down or has no eligible
        neighbor that round — the node still joins, just colder.
        """
        n = self.topology.n_nodes
        same_step_joiners = {}
        for i, s in self.joins:
            same_step_joiners.setdefault(s, set()).add(i)
        if self.kind == MATCHING:
            protected = np.zeros(data.shape, bool)
        else:
            protected = np.zeros(len(data), bool)
        n_sponsored = 0
        for i, s in self.joins:
            if not alive[s, i]:
                continue
            adj = self.topology.graph_at(s).adjacency()
            eligible = (adj[i].astype(bool) & alive[s] & member[s])
            for other in same_step_joiners[s]:
                eligible[other] = False        # a fellow cold node has
            eligible[i] = False                # nothing to hand off
            cand = np.nonzero(eligible)[0]
            if cand.size == 0:
                continue
            j = int(rng.choice(cand))
            if self.kind == MATCHING:
                # splice (i, j) into the round's involution: detach both
                # nodes' existing partners, then pair them
                pi, pj = data[s, i], data[s, j]
                data[s, pi], data[s, pj] = pi, pj
                data[s, i], data[s, j] = j, i
                protected[s, i] = protected[s, j] = True
            else:
                data[s] = (i, j)
                protected[s] = True
            n_sponsored += 1
        return protected, n_sponsored

    def compile(self, rng: np.random.Generator | int = 0) -> CompiledScenario:
        """Pre-draw + mask the whole trajectory into plain schedule data.

        Order of operations per round: (1) draw the gossip event(s) from the
        segment's graph, (2) plant the cold-join sponsor pairings, (3)
        cancel events touching a down endpoint (churn), (4) cancel events
        touching a non-member endpoint (permanent join/leave), (5) drop
        each surviving unprotected event with probability ``drop_prob``.
        Cancelled events become the Communicator layer's existing no-op
        encoding (self-partner / ``(i, i)`` edge sentinel), so every comm
        backend applies them unchanged.
        """
        if not isinstance(rng, np.random.Generator):
            rng = np.random.default_rng(rng)
        sched = self.topology.draw_schedule(self.kind, rng)
        alive = self.draw_alive(rng)
        data = sched.data.copy()
        t = len(data)
        has_membership = bool(self.joins or self.leaves)
        member = self.member_mask() if has_membership else None
        if has_membership:
            protected, n_sponsored = self._plant_sponsors(
                data, alive, member, rng)
        else:
            # a real ndarray, not Python False: `~False` is the int -1,
            # which would silently promote the drop masks to int 0/1
            # arrays and turn the boolean row indexing below into fancy
            # indexing of rows 0/1
            protected = np.zeros(
                data.shape if self.kind == MATCHING else t, bool)
            n_sponsored = 0

        if self.kind == MATCHING:
            ids = np.arange(self.topology.n_nodes, dtype=np.int32)
            matched = data != ids                               # [T, n]
            n_events = int(matched.sum()) // 2
            # churn: cancel any pair with a down endpoint (both directions)
            rows = np.arange(t)[:, None]
            pair_down = ~alive | ~alive[rows, data]             # [T, n]
            churned = matched & pair_down
            data = np.where(churned, ids, data)
            n_churned = int(churned.sum()) // 2
            # membership: a pair with a non-member endpoint cancels the
            # same way (the planted handoff pairs survive by construction:
            # the joiner IS a member from its join round, the sponsor was
            # chosen live-and-member)
            if has_membership:
                still = data != ids
                pair_out = ~member | ~member[rows, data]
                excluded = still & pair_out
                data = np.where(excluded, ids, data)
                n_excluded = int(excluded.sum()) // 2
            else:
                n_excluded = 0
            # drops: one coin per PAIR — draw on the (i < p[i]) side and
            # mirror, so both endpoints see the same coin; planted
            # handoff pairs are exempt
            still = data != ids
            coin = rng.random(data.shape) < self.drop_prob
            low = still & (ids < data)                          # pair owners
            drop_low = low & coin & ~protected
            dropped = drop_low | drop_low[rows, data]
            data = np.where(dropped, ids, data)
            n_dropped = int(dropped.sum()) // 2
        else:
            i, j = data[:, 0], data[:, 1]
            n_events = t
            steps_idx = np.arange(t)
            churned = ~alive[steps_idx, i] | ~alive[steps_idx, j]
            n_churned = int(churned.sum())
            if has_membership:
                out = ~member[steps_idx, i] | ~member[steps_idx, j]
                excluded = ~churned & out
                n_excluded = int(excluded.sum())
            else:
                excluded = np.zeros(t, bool)
                n_excluded = 0
            coin = (rng.random(t) < self.drop_prob) & ~protected
            dropped = ~churned & ~excluded & coin
            n_dropped = int(dropped.sum())
            dead = churned | excluded | dropped
            # the (i, i) sentinel: mix is identity, run_deleda wakes no one
            data[dead, 1] = data[dead, 0]

        sched = GossipSchedule(self.kind, data, self.topology.n_nodes,
                               segments=sched.segments)
        return CompiledScenario(schedule=sched, alive=alive,
                                degrees=self.topology.degrees(),
                                n_events=n_events, n_dropped=n_dropped,
                                n_churned=n_churned, member=member,
                                n_excluded=n_excluded,
                                n_sponsored=n_sponsored)


# ----------------------------------------------------------------------------
# The named regimes of launch/scenario_bench.py
# ----------------------------------------------------------------------------

SCENARIO_NAMES = ("static", "rewiring", "drop10", "churn20", "noniid",
                  "coldjoin")


def paper_scenario(name: str, n: int = 50, n_steps: int = 300,
                   seed: int = 0, ws_k: int = 4, ws_p: float = 0.3,
                   n_segments: int = 5) -> Scenario:
    """The named paper-scale regimes on Watts-Strogatz graphs.

    static   — the paper's fixed WS graph (the baseline);
    rewiring — the WS graph re-drawn every n_steps/n_segments rounds;
    drop10   — static topology, 10% of gossip exchanges lost;
    churn20  — static topology, 20% of nodes down at any time;
    noniid   — static topology, Dirichlet(0.5)-skewed topic shards;
    coldjoin — static topology, the last node cold-joins at T/2 (its
               sponsor handoff rides that round's gossip; gate: the
               member-masked consensus re-enters the eq. (3) envelope).
    """
    if name not in SCENARIO_NAMES:
        raise ValueError(f"unknown scenario {name!r}; want one of "
                         f"{SCENARIO_NAMES}")
    if name == "rewiring":
        if n_steps % n_segments:
            raise ValueError(f"n_steps={n_steps} must divide into "
                             f"{n_segments} segments")
        seq = GraphSequence.rewiring(
            lambda s: watts_strogatz_graph(n, ws_k, ws_p, seed=s),
            n_segments, n_steps // n_segments, seed=seed)
    else:
        seq = GraphSequence.static(
            watts_strogatz_graph(n, ws_k, ws_p, seed=seed), n_steps)
    knobs = {
        "static": {},
        "rewiring": {},
        "drop10": {"drop_prob": 0.1},
        "churn20": {"churn": 0.2},
        "noniid": {"topic_skew": 0.5},
        "coldjoin": {"joins": ((n - 1, n_steps // 2),)},
    }[name]
    return Scenario(topology=seq, name=name, **knobs)
