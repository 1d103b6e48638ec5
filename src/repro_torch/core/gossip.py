"""Gossip averaging in simulation: schedules, mixing and consensus.

The torch counterpart of the simulation half of ``repro.core.gossip``.
The n agents' iterates are stacked on a leading axis, ``S`` of shape
``[n, ...]``; a gossip event applies the averaging matrix
``W_e = I - (1/2)(e_i - e_j)(e_i - e_j)^T`` to the node axis.

* **schedules** — :func:`draw_edge_schedule`, :func:`draw_matching_schedule`,
  :func:`hypercube_partners` and :func:`ring_matchings` are host-side
  numpy, the reference's code line for line, so the same generator
  state gives the same schedule bit for bit;
* **mixing** — :func:`mix_edge` and :func:`mix_matching` are the plain
  torch versions (out of place, as the reference's); the training path
  mixes in place through :mod:`repro_torch.core.comm`, which launches
  the ``gossip_mix`` kernel on the card;
* **consensus** — :func:`consensus_distance` (the left side of paper
  eq. (3)) and :func:`consensus_envelope` (its right side).

The mesh half (``gossip_round_mesh``) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import Graph

__all__ = [
    "draw_edge_schedule", "draw_matching_schedule", "hypercube_partners",
    "ring_matchings", "mix_edge", "mix_matching", "mixing_matrix_edge",
    "mixing_matrix_matching", "consensus_distance", "consensus_envelope",
]


# ----------------------------------------------------------------------------
# Host-side schedule generation
# ----------------------------------------------------------------------------

def draw_edge_schedule(graph: Graph, n_steps: int,
                       rng: np.random.Generator) -> np.ndarray:
    """[T, 2] int32: one uniformly-random edge per iteration (Algorithm 1 l.3)."""
    idx = rng.integers(0, graph.n_edges, size=n_steps)
    return graph.edges[idx].astype(np.int32)


def draw_matching_schedule(graph: Graph, n_rounds: int,
                           rng: np.random.Generator) -> np.ndarray:
    """[T, n] int32 partner vectors: p[t, i] = j if (i, j) matched else i.

    Each round is a random maximal matching: every round draws a random
    edge priority order, and an edge joins the matching iff it holds the
    minimum priority among the still-alive edges at both endpoints (the
    matching the sequential greedy builds in priority order), settled
    for all rounds at once in O(log E) passes.
    """
    n, m = graph.n_nodes, graph.n_edges
    ei, ej = graph.edges[:, 0], graph.edges[:, 1]
    pri = rng.permuted(
        np.broadcast_to(np.arange(m, dtype=np.float64), (n_rounds, m)),
        axis=1)
    alive = np.ones((n_rounds, m), bool)
    used = np.zeros((n_rounds, n), bool)
    partners = np.broadcast_to(np.arange(n, dtype=np.int32),
                               (n_rounds, n)).copy()
    rows = np.arange(n_rounds)[:, None]
    while alive.any():
        p = np.where(alive, pri, np.inf)
        node_min = np.full((n_rounds, n), np.inf)
        np.minimum.at(node_min, (rows, np.broadcast_to(ei, (n_rounds, m))),
                      p)
        np.minimum.at(node_min, (rows, np.broadcast_to(ej, (n_rounds, m))),
                      p)
        sel = alive & (p <= node_min[rows, ei]) & (p <= node_min[rows, ej])
        t_idx, e_idx = np.nonzero(sel)
        partners[t_idx, ei[e_idx]] = ej[e_idx]
        partners[t_idx, ej[e_idx]] = ei[e_idx]
        used[t_idx, ei[e_idx]] = True
        used[t_idx, ej[e_idx]] = True
        alive &= ~(used[rows, ei] | used[rows, ej])
    return partners


def hypercube_partners(n: int) -> np.ndarray:
    """[log2(n), n] partner vectors p[r, i] = i XOR 2^r (exact consensus)."""
    if n & (n - 1):
        raise ValueError(f"hypercube gossip needs power-of-two n, got {n}")
    log2n = n.bit_length() - 1
    ranks = np.arange(n, dtype=np.int32)
    return np.stack([ranks ^ (1 << r) for r in range(log2n)], axis=0)


def ring_matchings(n: int) -> np.ndarray:
    """[2, n] even/odd ring matchings: round 0 pairs (0,1)(2,3)..., round 1
    pairs (1,2)(3,4)... and closes the ring with (n-1, 0) for even n; for
    odd n the leftover node self-pairs. For n == 2 both rounds pair (0, 1).
    """
    p_even = np.arange(n, dtype=np.int32)
    p_odd = np.arange(n, dtype=np.int32)
    for i in range(0, n - 1, 2):
        p_even[i], p_even[i + 1] = i + 1, i
    for i in range(1, n - 1, 2):
        p_odd[i], p_odd[i + 1] = i + 1, i
    if n % 2 == 0 and n >= 2:
        p_odd[n - 1], p_odd[0] = 0, n - 1
    return np.stack([p_even, p_odd], axis=0)


# ----------------------------------------------------------------------------
# Simulation-substrate mixing (node axis is a real array axis)
# ----------------------------------------------------------------------------

def mix_edge(stats: torch.Tensor, i: int, j: int) -> torch.Tensor:
    """Apply W_(i,j) to the node axis: s_i, s_j <- (s_i + s_j)/2 (a copy)."""
    avg = 0.5 * (stats[i] + stats[j])
    out = stats.clone()
    out[i] = avg
    out[j] = avg
    return out


def mix_matching(stats: torch.Tensor, partners) -> torch.Tensor:
    """Apply a whole matching at once: s_i <- (s_i + s_{p[i]})/2 (a copy).

    partners: [n] with p[p[i]] == i (self-partner = no-op).
    """
    p = torch.as_tensor(np.asarray(partners), dtype=torch.int64,
                        device=stats.device)
    return 0.5 * (stats + stats[p])


def mixing_matrix_edge(n: int, i: int, j: int) -> np.ndarray:
    """Dense W_e = I - (1/2)(e_i - e_j)(e_i - e_j)^T (for tests/analysis)."""
    v = np.zeros(n)
    v[i], v[j] = 1.0, -1.0
    return np.eye(n) - 0.5 * np.outer(v, v)


def mixing_matrix_matching(partners: np.ndarray) -> np.ndarray:
    """Dense doubly-stochastic W of a matching partner vector."""
    n = len(partners)
    w = np.zeros((n, n))
    for i, p in enumerate(partners):
        if p == i:
            w[i, i] = 1.0
        else:
            w[i, i] = w[i, p] = 0.5
    return w


def consensus_distance(stats: torch.Tensor,
                       member: torch.Tensor | None = None) -> torch.Tensor:
    """||S - mean(S) 1^T||_F — the left side of paper eq. (3), float32.

    ``member`` ([n] bool) restricts the mean and the norm to the member
    nodes, as the reference does (a node not yet joined, or gone, holds
    statistics that say nothing of the network's agreement); None is the
    unmasked computation, bit for bit.
    """
    if member is None:
        mean = stats.mean(dim=0, keepdim=True)
        return torch.linalg.vector_norm((stats - mean).reshape(-1))
    w = member.to(stats.dtype).reshape((-1,) + (1,) * (stats.dim() - 1))
    count = torch.clamp(member.sum(), min=1).to(stats.dtype)
    mean = (stats * w).sum(dim=0, keepdim=True) / count
    return torch.linalg.vector_norm(((stats - mean) * w).reshape(-1))


def consensus_envelope(lambda2: float, rhos: np.ndarray,
                       g_norm: float) -> np.ndarray:
    """Paper eq. (3) upper envelope: sum_r rho_r lam2^{(t-r)/2} ||G||.

    rhos: [T] step sizes. Returns [T] envelope values.
    """
    t_max = len(rhos)
    env = np.zeros(t_max)
    lam_sqrt = np.sqrt(max(lambda2, 0.0))
    acc = 0.0
    for t in range(t_max):
        acc = acc * lam_sqrt + rhos[t] * g_norm
        env[t] = acc
    return env
