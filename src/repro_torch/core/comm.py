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

* :class:`MeshComm` — the node axis is spread over the ranks of a
  ``torch.distributed`` world laid out as a :class:`Mesh` (1-D "data", or
  the node x vocab grid of :func:`make_grid_mesh`). Node i lives on
  node-device ``i // n_local``; documents never leave it. A matching is
  routed (:func:`_route_matching`, the reference's greedy, line for line)
  into an intra-rank mix, the ``gossip_mix`` kernel on the local block,
  and one-hop passes: each pass is one ``batch_isend_irecv`` pair per
  rank of the local block (``gossip.exchange``) and the masked blend
  ``0.5 * (s + other[src])`` in eager torch, as the reference's blend is
  plain jnp outside any kernel. On a grid every vocab shard exchanges its
  own ``[K, V/S]`` block with the same vocab shard of its partner.

With ``backend="gloo"`` a block on the card goes through pinned host
memory (gloo moves CPU tensors only): that is the caller's choice of
backend, not a fallback; the kernels still run on the card.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import gossip
from repro_torch.core.graph import Graph

__all__ = ["GossipSchedule", "SimComm", "EDGE", "MATCHING", "Mesh",
           "MeshComm", "make_grid_mesh"]

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


def _pair_payload_bytes(stats_shape, itemsize: int) -> int:
    return int(np.prod(stats_shape[1:])) * itemsize


# ----------------------------------------------------------------------------
# Mesh backend: one-hop pair exchanges between ranks
# ----------------------------------------------------------------------------

class Mesh:
    """The ranks of the running ``torch.distributed`` world as a named grid.

    Rank r sits at the row-major coordinates of r in ``sizes`` (a jax
    mesh's device order). Along each axis the ranks that differ only in
    that coordinate form one process group; every rank creates every
    group in the same order (``new_group`` is collective) and keeps its
    own. ``shape`` maps axis names to sizes, as a jax mesh's does.
    """

    def __init__(self, sizes: tuple[int, ...], axis_names: tuple[str, ...]):
        if not dist.is_initialized():
            raise RuntimeError("Mesh needs an initialised torch.distributed "
                               "process group (init_process_group)")
        sizes, axis_names = tuple(int(x) for x in sizes), tuple(axis_names)
        if len(sizes) != len(axis_names):
            raise ValueError(f"{len(sizes)} sizes for axes {axis_names}")
        world = dist.get_world_size()
        if math.prod(sizes) != world:
            raise ValueError(f"a {'x'.join(map(str, sizes))} mesh needs "
                             f"{math.prod(sizes)} ranks, the world has "
                             f"{world}")
        self.sizes, self.axis_names = sizes, axis_names
        self.shape = dict(zip(axis_names, sizes))
        self.rank = dist.get_rank()
        self.coords = tuple(int(c) for c in np.unravel_index(self.rank,
                                                             sizes))
        grid = np.arange(world).reshape(sizes)
        self._groups = {}
        for ax, name in enumerate(axis_names):
            lines = np.moveaxis(grid, ax, -1).reshape(-1, sizes[ax])
            for line in lines:
                ranks = [int(r) for r in line]
                group = (dist.group.WORLD if len(ranks) == world
                         else dist.new_group(ranks))
                if self.rank in ranks:
                    self._groups[name] = (group, ranks)

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        return self._groups[axis][0]

    def line(self, axis: str) -> list[int]:
        """The global ranks of this rank's line along ``axis``, in order."""
        return list(self._groups[axis][1])


def make_grid_mesh(n_node_devices: int, n_vocab_devices: int,
                   axis_names: tuple[str, str] = ("data", "vocab")) -> Mesh:
    """A 2-D node x vocab grid of the world's ranks."""
    return Mesh((n_node_devices, n_vocab_devices), axis_names)


def _route_matching(partners: np.ndarray, n_dev: int):
    """Decompose one matching into intra-device mixing + exchange passes.

    Nodes are block-contiguous over the axis: device d owns rows
    [d*n_local, (d+1)*n_local). Cross-device pairs are greedily colored into
    *device-level matchings* ("passes"); each pass is one bidirectional
    exchange of the full local block plus a per-node row-gather from the
    received block. With one node per device every matching is a single
    pass — one [K, V] block per device per round.

    Returns ((intra_src, intra_active), [(perm, remote_src, active), ...])
    where intra_src/remote_src are [n] local-row gather indices and perm is
    the (src, dst) device permutation of the pass.
    """
    partners = np.asarray(partners)
    n = len(partners)
    if n % n_dev:
        raise ValueError(f"n={n} not divisible by n_dev={n_dev}")
    n_local = n // n_dev

    intra_src = (np.arange(n, dtype=np.int32) % n_local)
    intra_active = np.zeros(n, bool)
    cross: list[tuple[int, int]] = []
    for i in range(n):
        j = int(partners[i])
        if j <= i:
            continue
        if i // n_local == j // n_local:
            intra_src[i] = j % n_local
            intra_src[j] = i % n_local
            intra_active[i] = intra_active[j] = True
        else:
            cross.append((i, j))

    passes = []      # [{devmap: {a: b}, nodes: [(i, j)]}]
    for i, j in cross:
        a, b = i // n_local, j // n_local
        for ps in passes:
            pa, pb = ps["devmap"].get(a), ps["devmap"].get(b)
            if (pa is None and pb is None) or (pa == b and pb == a):
                ps["devmap"][a] = b
                ps["devmap"][b] = a
                ps["nodes"].append((i, j))
                break
        else:
            passes.append({"devmap": {a: b, b: a}, "nodes": [(i, j)]})

    routed = []
    for ps in passes:
        perm = tuple(sorted(ps["devmap"].items()))
        remote_src = (np.arange(n, dtype=np.int32) % n_local)
        active = np.zeros(n, bool)
        for i, j in ps["nodes"]:
            remote_src[i] = j % n_local
            remote_src[j] = i % n_local
            active[i] = active[j] = True
        routed.append((perm, remote_src, active))
    return (intra_src, intra_active), routed


class MeshComm:
    """Gossip over a mesh axis of ranks by pairwise block exchanges.

    Each rank holds its local block ``[n_local, ...]`` of node-stacked
    statistics: ``[n_local, K, V]``, or on a grid (``vocab_axis`` set)
    ``[n_local, K, V/vd]`` of dense stats and ``[n_local, K, S/vd, V/S]``
    of vocab-sharded ones (:meth:`shard` cuts a global tensor so).
    ``mix_matching`` takes the global ``[n]`` partner vector (the same on
    every rank), mixes the local block in place and returns it.
    """

    name = "mesh"

    def __init__(self, mesh: Mesh | None = None, axis_name: str = "data",
                 vocab_axis: str | None = None):
        if mesh is None:
            mesh = Mesh((dist.get_world_size(),), (axis_name,))
        self.mesh = mesh
        self.axis_name = axis_name
        self.vocab_axis = vocab_axis
        self.n_devices = int(mesh.shape[axis_name])
        self.n_vocab_shards = (1 if vocab_axis is None
                               else int(mesh.shape[vocab_axis]))
        self.stage = dist.get_backend() == "gloo"

    # -- layout ---------------------------------------------------------------

    @property
    def node_index(self) -> int:
        """This rank's node-device index (its block of node rows)."""
        return self.mesh.index(self.axis_name)

    @property
    def vocab_index(self) -> int:
        return 0 if self.vocab_axis is None else self.mesh.index(
            self.vocab_axis)

    def node_rows(self, n: int) -> slice:
        """The global node rows this rank owns."""
        if n % self.n_devices:
            raise ValueError(f"n={n} not divisible by n_dev="
                             f"{self.n_devices}")
        n_local = n // self.n_devices
        return slice(self.node_index * n_local,
                     (self.node_index + 1) * n_local)

    def _vocab_dim(self, ndim: int) -> int:
        if ndim < 3:
            raise ValueError(f"vocab-sharded MeshComm needs [n, K, V] or "
                             f"[n, K, S, V/S] stats, got ndim={ndim}")
        return 2 if ndim >= 4 else ndim - 1

    def shard(self, stats: torch.Tensor) -> torch.Tensor:
        """This rank's block of a global ``[n, ...]`` tensor (a view)."""
        return self.vocab_block(stats[self.node_rows(stats.shape[0])])

    def vocab_block(self, rows: torch.Tensor) -> torch.Tensor:
        """This rank's vocab shard of node rows ``[m, K, V]`` or ``[m, K, S,
        V/S]`` (a view; the rows themselves on a 1-D mesh)."""
        if self.vocab_axis is None:
            return rows
        dim = self._vocab_dim(rows.dim())
        size = rows.shape[dim]
        if size % self.n_vocab_shards:
            raise ValueError(f"vocab axis {self.n_vocab_shards} must divide "
                             f"{size}")
        step = size // self.n_vocab_shards
        return rows.narrow(dim, self.vocab_index * step, step)

    def all_gather(self, x: torch.Tensor, axis: str,
                   dim: int = -1) -> torch.Tensor:
        """Every rank's ``x`` along this rank's line of ``axis``,
        concatenated on ``dim`` in the line's order."""
        src = self._wire(x.contiguous())
        parts = [torch.empty_like(src)
                 for _ in range(self.mesh.shape[axis])]
        dist.all_gather(parts, src, group=self.mesh.group(axis))
        return torch.cat([p.to(x.device) for p in parts], dim=dim)

    def gather(self, local: torch.Tensor, dst: int = 0,
               per_node: bool = False):
        """The global tensor of every rank's block, on rank ``dst`` (on the
        block's device; None elsewhere): one gather over the world.
        ``per_node``: ``local`` is one value per node row (``[n_local]``),
        the same on every vocab shard; the first shard's is kept."""
        world = dist.get_world_size()
        src = self._wire(local.contiguous())
        bufs = ([torch.empty_like(src) for _ in range(world)]
                if self.mesh.rank == dst else None)
        dist.gather(src, bufs, dst=dst)
        if bufs is None:
            return None
        bufs = [b.to(local.device) for b in bufs]
        nd, vd = self.n_devices, self.n_vocab_shards
        rows = []
        for a in range(nd):
            row = bufs[a * vd:(a + 1) * vd]
            rows.append(row[0] if vd == 1 or per_node else torch.cat(
                row, dim=self._vocab_dim(local.dim())))
        return torch.cat(rows, dim=0)

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the backend can move it: pinned host memory for a
        card tensor under gloo, ``t`` itself otherwise."""
        if self.stage and t.is_cuda:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            return host.copy_(t)
        return t

    def all_reduce(self, x: torch.Tensor, axis: str | None = None
                   ) -> torch.Tensor:
        """The sum of ``x`` over this rank's line along ``axis`` (None: the
        world), in place where the backend can take ``x`` as it is."""
        group = None if axis is None else self.mesh.group(axis)
        if self.stage and x.is_cuda:
            host = x.cpu()
            dist.all_reduce(host, group=group)
            return x.copy_(host)
        dist.all_reduce(x, group=group)
        return x

    def peer_rank(self, node_device: int) -> int:
        """The global rank of node-device ``node_device`` on this rank's
        vocab shard."""
        return self.mesh.line(self.axis_name)[node_device]

    # -- Communicator interface ---------------------------------------------

    def mix_matching(self, stats: torch.Tensor, partners) -> torch.Tensor:
        """s_i <- (s_i + s_{p[i]})/2 for the local rows of a matching, in
        place: the intra-rank pairs through ``gossip_mix``, then one
        exchange per pass this rank's node-device takes part in."""
        from repro_torch.kernels.gossip_mix import ops as gossip_ops

        partners = np.asarray(partners, np.int32)
        n = len(partners)
        rows = self.node_rows(n)
        n_local = rows.stop - rows.start
        if stats.shape[0] != n_local:
            raise ValueError(f"local block has {stats.shape[0]} rows, the "
                             f"matching {n} nodes over {self.n_devices} "
                             f"devices")
        (intra_src, intra_active), passes = _route_matching(
            partners, self.n_devices)
        act = intra_active[rows]
        if act.any():
            i = np.nonzero(act)[0]
            j = intra_src[rows][i]
            keep = i < j
            pairs = np.stack([i[keep], j[keep]], 1).astype(np.int32)
            gossip_ops.mix_pairs_(stats, pairs)
        me = self.node_index
        for perm, remote_src, active in passes:
            devmap = dict(perm)
            if me not in devmap:
                continue
            other = gossip.exchange(stats, self.peer_rank(devmap[me]),
                                    stage=self.stage)
            loc = np.nonzero(active[rows])[0]
            idx = torch.as_tensor(loc, device=stats.device)
            src = torch.as_tensor(remote_src[rows][loc].astype(np.int64),
                                  device=stats.device)
            stats[idx] = 0.5 * (stats[idx] + other[src])
        return stats

    def mix_edge(self, stats: torch.Tensor, i: int, j: int) -> torch.Tensor:
        """One activated edge (global node ids), as a one-pair matching."""
        p = np.arange(stats.shape[0] * self.n_devices, dtype=np.int32)
        p[int(i)], p[int(j)] = int(j), int(i)
        return self.mix_matching(stats, p)

    def bytes_per_round(self, stats_shape, itemsize: int, partners) -> int:
        """Wire bytes of one round for global ``stats_shape``: each pass
        moves one per-shard local block per involved node-device, every
        vocab shard in parallel (per-link payload 1/S, the round's total
        the same on every grid), the reference's accounting."""
        _, passes = _route_matching(np.asarray(partners), self.n_devices)
        n_local = stats_shape[0] // self.n_devices
        shard_block = (n_local * _pair_payload_bytes(stats_shape, itemsize)
                       // self.n_vocab_shards)
        return sum(len(perm) * self.n_vocab_shards * shard_block
                   for perm, _, _ in passes)
