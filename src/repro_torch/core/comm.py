"""Gossip communication in simulation: one schedule object, one communicator.

The torch counterpart of the simulation half of ``repro.core.comm``.

* :class:`GossipSchedule` — a pre-drawn sequence of gossip events,
  either single activated edges (the paper's asynchronous Algorithm 1,
  ``[T, 2]``) or maximal matchings (synchronous multi-edge rounds,
  ``[T, n]`` partner vectors), with an optional ``segments`` axis for a
  time-varying topology (:mod:`.scenario`). Drawn host-side with numpy,
  so a schedule equals the reference's for the same generator state.
* :class:`SimComm` — the node axis is a real array axis on one device.
  It stands for both of the reference's simulation backends
  (``DenseSimComm``, the jnp oracle, and ``PallasSimComm``, the
  ``gossip_mix`` kernel): it mixes through
  ``kernels.gossip_mix.ops.mix_pairs_``, which launches the CUDA kernel
  for a statistic on the card and runs the plain torch version for one
  on the CPU. Unlike the reference it mixes **in place** and touches only
  the matched rows; an edge event mixes its two rows (the reference's
  kernel backend rewrites all n), with the same bits.

The mesh communicator waits for the multi-device slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import gossip
from repro_torch.core.graph import Graph

__all__ = ["GossipSchedule", "SimComm", "EDGE", "MATCHING"]

EDGE = "edge"
MATCHING = "matching"


@dataclasses.dataclass(frozen=True)
class GossipSchedule:
    """A pre-drawn gossip trajectory.

    ``kind == "edge"``:     data is [T, 2] int32 activated edges (``(i, i)``
                            is the dropped-event sentinel).
    ``kind == "matching"``: data is [T, n] int32 partner vectors
                            (involutions: p[p[i]] == i, self-partner = idle).

    ``segments`` ([T] int32 or None) records which segment of a
    :class:`~repro_torch.core.scenario.GraphSequence` each round was drawn
    from; metadata only, the loop reads ``data`` alone.
    """

    kind: str
    data: np.ndarray
    n_nodes: int
    segments: np.ndarray | None = None

    def __post_init__(self):
        d = np.asarray(self.data, np.int32)
        if self.kind == EDGE:
            if d.ndim != 2 or d.shape[1] != 2:
                raise ValueError(f"edge schedule must be [T, 2], {d.shape}")
        elif self.kind == MATCHING:
            if d.ndim != 2 or d.shape[1] != self.n_nodes:
                raise ValueError(
                    f"matching schedule must be [T, {self.n_nodes}], "
                    f"got {d.shape}")
            if not (d[np.arange(len(d))[:, None], d]
                    == np.arange(self.n_nodes)).all():
                raise ValueError("matching rows must be involutions")
        else:
            raise ValueError(f"kind must be edge|matching, {self.kind!r}")
        if len(d) and (d.min() < 0 or d.max() >= self.n_nodes):
            raise ValueError("schedule references node out of range")
        object.__setattr__(self, "data", d)
        if self.segments is not None:
            seg = np.asarray(self.segments, np.int32)
            if seg.shape != (len(d),):
                raise ValueError(f"segments must be [T={len(d)}], "
                                 f"got {seg.shape}")
            object.__setattr__(self, "segments", seg)

    @property
    def n_rounds(self) -> int:
        return len(self.data)

    @property
    def n_segments(self) -> int:
        return 1 if self.segments is None else int(self.segments.max()) + 1

    @staticmethod
    def draw_edges(graph: Graph, n_rounds: int,
                   rng: np.random.Generator) -> "GossipSchedule":
        """One uniformly-random activated edge per round (Algorithm 1)."""
        return GossipSchedule(
            EDGE, gossip.draw_edge_schedule(graph, n_rounds, rng),
            graph.n_nodes)

    @staticmethod
    def draw_matchings(graph: Graph, n_rounds: int,
                       rng: np.random.Generator) -> "GossipSchedule":
        """One random maximal matching per round (synchronous rounds)."""
        return GossipSchedule(
            MATCHING, gossip.draw_matching_schedule(graph, n_rounds, rng),
            graph.n_nodes)

    @staticmethod
    def hypercube(n: int) -> "GossipSchedule":
        """log2(n) XOR-partner rounds: exact consensus when run in full."""
        return GossipSchedule(MATCHING, gossip.hypercube_partners(n), n)

    @staticmethod
    def ring(n: int, n_rounds: int = 2) -> "GossipSchedule":
        """Alternating even/odd ring matchings, tiled to n_rounds."""
        base = gossip.ring_matchings(n)
        return GossipSchedule(MATCHING, base[np.arange(n_rounds) % len(base)],
                              n)

    def as_matchings(self) -> "GossipSchedule":
        """An edge schedule as one-pair-per-round matchings (the same
        averaging matrix W_e each round); a matching schedule as it is."""
        if self.kind == MATCHING:
            return self
        t = self.n_rounds
        p = np.broadcast_to(np.arange(self.n_nodes, dtype=np.int32),
                            (t, self.n_nodes)).copy()
        rows = np.arange(t)
        p[rows, self.data[:, 0]] = self.data[:, 1]
        p[rows, self.data[:, 1]] = self.data[:, 0]
        return GossipSchedule(MATCHING, p, self.n_nodes,
                              segments=self.segments)

    def partners(self) -> np.ndarray:
        """[T, n] partner matrix (an edge schedule converted)."""
        return self.as_matchings().data


def _n_matched(partners) -> int:
    partners = np.asarray(partners)
    return int((partners != np.arange(len(partners))).sum())


class SimComm:
    """Gossip averaging of node-stacked statistics ``[n, ...]``, in place."""

    def mix_matching(self, stats: torch.Tensor, partners) -> torch.Tensor:
        """s_i <- (s_i + s_{p[i]})/2 for a whole matching; ``partners`` a
        host ``[n]`` involution. Mixes ``stats`` in place and returns it."""
        from repro_torch.kernels.gossip_mix import ops as gossip_ops

        return gossip_ops.mix_pairs_(stats, gossip_ops.pairs_of(partners))

    def mix_edge(self, stats: torch.Tensor, i: int, j: int) -> torch.Tensor:
        """s_i, s_j <- (s_i + s_j)/2 for one activated edge, in place; the
        ``(i, i)`` sentinel leaves ``stats`` as it is."""
        from repro_torch.kernels.gossip_mix import ops as gossip_ops

        i, j = int(i), int(j)
        if i == j:
            return stats
        return gossip_ops.mix_pairs_(stats, np.array([[i, j]], np.int32))

    def bytes_per_round(self, stats_shape, itemsize: int,
                        partners) -> int:
        """Wire bytes of one matching round in a deployment: each matched
        node sends its block once (the reference's cost model)."""
        return _n_matched(partners) * int(np.prod(stats_shape[1:])) * itemsize
