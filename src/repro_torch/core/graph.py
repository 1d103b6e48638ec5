"""Communication graphs for decentralized optimization.

The port's own copy of ``repro.core.graph`` (pure numpy; the port
imports nothing of the JAX package). Edges and matchings come from
numpy's generator, so for the same seed they equal the reference's.
One difference: :func:`erdos_renyi_graph` builds an empty edge list as
shape ``[0, 2]``, so a draw with no edges reaches the retry loop instead
of raising in :class:`Graph` (the reference raises there).

Static (host-side, numpy) descriptions of the agent network: edge lists,
degrees, expected averaging matrices and their spectral properties. The
spectral quantity that drives DELEDA's consensus rate (paper eq. (3)) is
lambda_2, the second-largest eigenvalue of E[W] where

    W_e = I - (1/2)(e_i - e_j)(e_i - e_j)^T,   e = (i, j) ~ Uniform(E).

The graph must be connected and non-bipartite for 0 < lambda_2 < 1.
"""

from __future__ import annotations

import dataclasses
import numpy as np


@dataclasses.dataclass(frozen=True)
class Graph:
    """An undirected communication graph over n agents."""

    n_nodes: int
    edges: np.ndarray          # [E, 2] int32, i < j, unique
    name: str = "graph"

    def __post_init__(self):
        e = np.asarray(self.edges, np.int32)
        if e.ndim != 2 or e.shape[1] != 2:
            raise ValueError(f"edges must be [E,2], got {e.shape}")
        if (e[:, 0] == e[:, 1]).any():
            raise ValueError("self-loops not allowed")
        if len(e) and (e.min() < 0 or e.max() >= self.n_nodes):
            raise ValueError("edge endpoint out of range")
        canon = np.sort(e, axis=1)
        if len({(int(a), int(b)) for a, b in canon}) != len(canon):
            raise ValueError("duplicate edges")
        object.__setattr__(self, "edges", canon)

    @property
    def n_edges(self) -> int:
        return len(self.edges)

    @property
    def degrees(self) -> np.ndarray:
        deg = np.zeros(self.n_nodes, np.int64)
        np.add.at(deg, self.edges[:, 0], 1)
        np.add.at(deg, self.edges[:, 1], 1)
        return deg

    def adjacency(self) -> np.ndarray:
        a = np.zeros((self.n_nodes, self.n_nodes), np.float64)
        a[self.edges[:, 0], self.edges[:, 1]] = 1.0
        a[self.edges[:, 1], self.edges[:, 0]] = 1.0
        return a

    def is_connected(self) -> bool:
        """BFS frontier propagation over the edge list.

        O(diameter) vectorized passes of O(E) work — replaces the old
        ``matrix_power(A + I, n)`` reachability, which was O(n^3 log n)
        *and* overflowed float64 around n≈500 (2^n-ish path counts), so
        large graphs could silently misreport connectivity.
        """
        n = self.n_nodes
        if n <= 1:
            return True
        if self.n_edges == 0:
            return False
        ei, ej = self.edges[:, 0], self.edges[:, 1]
        reached = np.zeros(n, bool)
        reached[0] = True
        while True:
            hit = reached[ei] | reached[ej]      # edges touching the set
            new = reached.copy()
            new[ei[hit]] = True
            new[ej[hit]] = True
            if new.all():
                return True
            if (new == reached).all():
                return False
            reached = new

    def expected_w(self) -> np.ndarray:
        """E[W] under uniform random edge activation."""
        n, es = self.n_nodes, self.edges
        ew = np.eye(n)
        for i, j in es:
            v = np.zeros(n)
            v[i], v[j] = 1.0, -1.0
            ew -= np.outer(v, v) / (2.0 * len(es))
        return ew

    def lambda2(self) -> float:
        """Second-largest eigenvalue of E[W] (consensus contraction rate)."""
        eig = np.sort(np.linalg.eigvalsh(self.expected_w()))
        return float(eig[-2])

    def spectral_gap(self) -> float:
        return 1.0 - self.lambda2()


# ----------------------------------------------------------------------------
# Topology constructors
# ----------------------------------------------------------------------------

def complete_graph(n: int) -> Graph:
    edges = np.array([(i, j) for i in range(n) for j in range(i + 1, n)],
                     np.int32)
    return Graph(n, edges, name=f"complete-{n}")


def ring_graph(n: int) -> Graph:
    edges = np.array([(i, (i + 1) % n) for i in range(n)], np.int32)
    return Graph(n, edges, name=f"ring-{n}")


def star_graph(n: int) -> Graph:
    edges = np.array([(0, i) for i in range(1, n)], np.int32)
    return Graph(n, edges, name=f"star-{n}")


def grid_graph(rows: int, cols: int) -> Graph:
    edges = []
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            if c + 1 < cols:
                edges.append((i, i + 1))
            if r + 1 < rows:
                edges.append((i, i + cols))
    return Graph(rows * cols, np.array(edges, np.int32),
                 name=f"grid-{rows}x{cols}")


def hypercube_graph(log2_n: int) -> Graph:
    n = 1 << log2_n
    edges = [(i, i ^ (1 << b)) for i in range(n) for b in range(log2_n)
             if i < (i ^ (1 << b))]
    return Graph(n, np.array(edges, np.int32), name=f"hypercube-{n}")


def watts_strogatz_graph(n: int, k: int, p: float, seed: int = 0) -> Graph:
    """Watts-Strogatz small world: ring lattice of degree k, rewiring prob p.

    The paper uses n=50 with 100 edges (k=4) and p=0.3. Rewiring preserves
    the edge count; we reject rewires that would duplicate or self-loop and
    retry until the graph is connected (standard `connected_watts_strogatz`).
    """
    if k % 2 or k >= n:
        raise ValueError("k must be even and < n")
    rng = np.random.default_rng(seed)
    for _attempt in range(100):
        edge_set = {(i, (i + d) % n) for i in range(n)
                    for d in range(1, k // 2 + 1)}
        edge_set = {(min(a, b), max(a, b)) for a, b in edge_set}
        edges = sorted(edge_set)
        for idx, (a, b) in enumerate(list(edges)):
            if rng.random() < p:
                for _retry in range(50):
                    new_b = int(rng.integers(0, n))
                    cand = (min(a, new_b), max(a, new_b))
                    if new_b != a and cand not in edge_set:
                        edge_set.discard((a, b))
                        edge_set.add(cand)
                        edges[idx] = cand
                        break
        g = Graph(n, np.array(sorted(edge_set), np.int32),
                  name=f"ws-{n}-k{k}-p{p}")
        if g.is_connected():
            return g
    raise RuntimeError("failed to build a connected Watts-Strogatz graph")


def erdos_renyi_graph(n: int, p: float, seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    for _attempt in range(100):
        mask = rng.random((n, n)) < p
        edges = [(i, j) for i in range(n) for j in range(i + 1, n)
                 if mask[i, j]]
        g = Graph(n, np.array(edges, np.int32).reshape(-1, 2),
                  name=f"er-{n}-p{p}")
        if g.n_edges and g.is_connected():
            return g
    raise RuntimeError("failed to build a connected Erdos-Renyi graph")


def paper_graphs(n: int = 50, seed: int = 0) -> dict[str, Graph]:
    """The two graphs of the paper's experimental section."""
    return {
        "complete": complete_graph(n),
        "watts_strogatz": watts_strogatz_graph(n, k=4, p=0.3, seed=seed),
    }


# ----------------------------------------------------------------------------
# Matchings (for synchronous multi-edge gossip rounds / the Pallas mix kernel)
# ----------------------------------------------------------------------------

def random_matching(graph: Graph, rng: np.random.Generator) -> np.ndarray:
    """Greedy random maximal matching: [M, 2] disjoint edges."""
    order = rng.permutation(graph.n_edges)
    used = np.zeros(graph.n_nodes, bool)
    out = []
    for e in order:
        i, j = graph.edges[e]
        if not used[i] and not used[j]:
            used[i] = used[j] = True
            out.append((i, j))
    return np.array(out, np.int32).reshape(-1, 2)
