"""Decentralized (gossip) synchronization for arbitrary training state.

The port's copy of ``repro.core.decentralized``: the paper's transferable
core, *replace global aggregation of a linearly-entering statistic with
pairwise averaging*, as a trainer knob for the LM scaffold:

    sync = "allreduce"               exact mean (baseline)
    sync = "gossip-hypercube[k]"     k XOR-partner rounds; k = log2(n) exact
    sync = "gossip-ring[k]"          k even/odd ring-matching rounds

Both substrates reuse the port's communication layer (``core.comm``) and
mix **in place**:

  * :func:`sync_tree_sim`  — every leaf stacked on a leading node axis
    ``[n, ...]`` on one device; a gossip round mixes each leaf through
    ``SimComm``, i.e. the ``gossip_mix`` kernel (K1) on the card, in
    float32 or bfloat16, and its plain version on the CPU.
  * :func:`sync_tree_mesh` — one node a rank of a ``comm.Mesh`` axis, each
    rank holding its own tree; a round is ``MeshComm.mix_matching`` of
    each leaf (one block exchange with the partner rank, the blend
    ``0.5 * (x + partner)``; pairs inside a rank would launch K1), and
    "allreduce" is ``MeshComm.all_reduce`` divided by the ranks.

"allreduce" sums in float32 and rounds once to the leaf's dtype (gloo
takes no bfloat16, and a float32 sum of a few bfloat16 values is exact):
the reference's ``x.mean(0)``, which sums a bfloat16 leaf in float32 too.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core import comm as comm_mod

__all__ = ["SyncSpec", "parse_sync", "rounds_per_axis", "is_exact",
           "collective_bytes_per_sync", "sync_tree_sim", "sync_tree_mesh",
           "spread_mesh", "scalar_all_reduce", "bytes_per_sync",
           "LocalStepsConfig", "make_sync_fn", "tree_bytes", "SYNC_CHUNK"]


@dataclasses.dataclass(frozen=True)
class SyncSpec:
    """Parsed synchronization strategy."""

    kind: str                 # "allreduce" | "hypercube" | "ring"
    rounds: int | None = None  # None => exact (log2 n for hypercube)

    def __post_init__(self):
        if self.kind not in ("allreduce", "hypercube", "ring"):
            raise ValueError(f"unknown sync kind {self.kind!r}")


_SPEC_RE = re.compile(r"^(allreduce|gossip-hypercube|gossip-ring)"
                      r"(?:\[(\d+)\])?$")


def parse_sync(spec: str) -> SyncSpec:
    """Parse 'allreduce' | 'gossip-hypercube[k]' | 'gossip-ring[k]'."""
    m = _SPEC_RE.match(spec)
    if not m:
        raise ValueError(
            f"bad sync spec {spec!r}; want allreduce | gossip-hypercube[k] "
            f"| gossip-ring[k]")
    kind = m.group(1).replace("gossip-", "")
    rounds = int(m.group(2)) if m.group(2) else None
    return SyncSpec(kind=kind, rounds=rounds)


def rounds_per_axis(spec: SyncSpec, axis_sizes: Sequence[int]) -> list[int]:
    """How many gossip rounds each axis runs under the spec's TOTAL budget.

    ``spec.rounds`` is a budget over ALL axes, spent in axis order:
    hypercube axes take up to their exact count (log2 size), ring axes take
    the whole remaining budget (or the nominal 2 even/odd rounds when the
    budget is unlimited). The one source of truth of sync_tree_mesh,
    sync_tree_sim and collective_bytes_per_sync.
    """
    out: list[int] = []
    budget = spec.rounds
    for size in axis_sizes:
        if spec.kind == "allreduce" or int(size) <= 1 or budget == 0:
            out.append(0)
            continue
        if spec.kind == "hypercube":
            exact = int(size).bit_length() - 1
            k = exact if budget is None else min(budget, exact)
        else:  # ring
            k = 2 if budget is None else budget
        out.append(k)
        if budget is not None:
            budget -= k
    return out


def is_exact(spec: SyncSpec, axis_sizes: Sequence[int]) -> bool:
    """Whether the spec reaches exact consensus on the given axes."""
    if spec.kind == "allreduce":
        return True
    if spec.kind == "hypercube":
        need = sum(int(s).bit_length() - 1 for s in axis_sizes if s > 1)
        return spec.rounds is None or spec.rounds >= need
    return False


def collective_bytes_per_sync(spec: SyncSpec, payload_bytes: int,
                              axis_sizes: Sequence[int]) -> int:
    """Napkin model of the bytes each device sends for one synchronization.

    ring all-reduce: 2 * B * (n-1)/n; each gossip round: B (one exchange).
    """
    n = int(np.prod(axis_sizes))
    if spec.kind == "allreduce":
        return int(2 * payload_bytes * (n - 1) / n)
    return payload_bytes * sum(rounds_per_axis(spec, axis_sizes))


def tree_bytes(tree) -> int:
    """The bytes of every tensor leaf of ``tree``."""
    return sum(x.numel() * x.element_size() for x in pytree.tree_leaves(tree))


def _schedule(spec: SyncSpec, size: int, k: int):
    return (comm_mod.GossipSchedule.hypercube(size)
            if spec.kind == "hypercube"
            else comm_mod.GossipSchedule.ring(size, max(k, 1)))


# ----------------------------------------------------------------------------
# Mesh substrate (one node a rank)
# ----------------------------------------------------------------------------

SYNC_CHUNK = 1 << 26     # elements of one float32 all-reduce (256 MB)


def _chunks(x: torch.Tensor):
    """Contiguous views of ``SYNC_CHUNK`` elements covering ``x``."""
    flat = x.view(-1)
    for a in range(0, flat.numel(), SYNC_CHUNK):
        yield flat[a:a + SYNC_CHUNK]


def _mean_(x: torch.Tensor, comm: comm_mod.MeshComm,
           axis_names: Sequence[str], n: int) -> torch.Tensor:
    """x <- the mean of x over the ranks of ``axis_names``, summed in
    float32 and rounded once to x's dtype, ``SYNC_CHUNK`` elements at a
    time (the float32 copy of a 590M-element embedding would be 2.4 GB)."""
    for part in _chunks(x):
        acc = part if part.dtype == torch.float32 else part.float()
        for name in axis_names:
            comm.all_reduce(acc, name)
        if acc is part:
            part.div_(n)
        else:
            part.copy_(acc.div_(n))
    return x


def spread_mesh(tree, mesh: comm_mod.Mesh,
                axis_names: Sequence[str] = ("data",)) -> float:
    """max |x - mean over the ranks of x| over every leaf of this rank's
    tree: each leaf's mean by float32 all-reduces (``SYNC_CHUNK`` at a
    time), the maximum over the ranks by one scalar all-reduce. Every
    rank gets the value; 0 means every rank holds the same tree."""
    import torch.distributed as dist

    comm = comm_mod.MeshComm(mesh, axis_names[0])
    n = math.prod(int(mesh.shape[a]) for a in axis_names)
    local = 0.0
    for x in pytree.tree_leaves(tree):
        for part in _chunks(x):
            acc = part.to(torch.float32, copy=True)
            for name in axis_names:
                comm.all_reduce(acc, name)
            local = max(local, float(acc.div_(n).sub_(part).abs_().max()))
    return scalar_all_reduce(local, dist.ReduceOp.MAX)


def scalar_all_reduce(value: float, op=None) -> float:
    """One float reduced over the world (default: summed), in float64 on
    the backend's device; every rank gets it."""
    import torch.distributed as dist

    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    t = torch.tensor([value], dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op)
    return float(t[0])


def bytes_per_sync(spec: SyncSpec, tree, n: int, rank: int) -> int:
    """Bytes rank ``rank`` of ``n`` hands to torch.distributed in one
    ``sync_tree_mesh``: the float32 copy of every leaf once (allreduce),
    or every leaf once a round it has a partner (gossip)."""
    if spec.kind == "allreduce":
        return sum(x.numel() * 4 for x in pytree.tree_leaves(tree))
    (k,) = rounds_per_axis(spec, (n,))
    sched = _schedule(spec, n, k)
    live = sum(int(sched.data[r % sched.n_rounds][rank] != rank)
               for r in range(k))
    return live * tree_bytes(tree)


def sync_tree_mesh(tree, spec: SyncSpec, mesh: comm_mod.Mesh,
                   axis_names: Sequence[str] = ("data",)):
    """Synchronize this rank's tree with the other ranks of ``axis_names``
    of ``mesh`` (one node a rank), in place; returns the tree.

    With several axes the gossip rounds run axis by axis in sequence — a
    hypercube over the product graph, itself a hypercube, so exactness
    composes. Every rank calls it with the same spec.
    """
    sizes = [int(mesh.shape[a]) for a in axis_names]
    leaves = pytree.tree_leaves(tree)
    if spec.kind == "allreduce":
        comm = comm_mod.MeshComm(mesh, axis_names[0])
        for x in leaves:
            _mean_(x, comm, axis_names, math.prod(sizes))
        return tree
    for name, size, k in zip(axis_names, sizes,
                             rounds_per_axis(spec, sizes)):
        if k == 0:
            continue
        comm = comm_mod.MeshComm(mesh, name)
        schedule = _schedule(spec, size, k)
        for r in range(k):
            partners = schedule.data[r % schedule.n_rounds]
            for x in leaves:
                comm.mix_matching(x.unsqueeze(0), partners)
    return tree


# ----------------------------------------------------------------------------
# Simulation substrate (stacked node axis; tests and one-device runs)
# ----------------------------------------------------------------------------

def sync_tree_sim(tree, spec: SyncSpec, n_nodes: int,
                  comm: comm_mod.SimComm | None = None):
    """Synchronize a tree whose every leaf is ``[n_nodes, ...]``, in place;
    returns the tree.

    Semantics match sync_tree_mesh with one axis of size n_nodes. A
    gossip round mixes each leaf through ``comm`` (default ``SimComm``:
    the ``gossip_mix`` kernel for a leaf on the card).
    """
    leaves = pytree.tree_leaves(tree)
    if spec.kind == "allreduce":
        for x in leaves:
            x.copy_(x.float().mean(0, keepdim=True).expand_as(x))
        return tree
    comm = comm or comm_mod.SimComm()
    (k,) = rounds_per_axis(spec, (n_nodes,))
    schedule = _schedule(spec, n_nodes, k)
    for r in range(k):
        partners = schedule.data[r % schedule.n_rounds]
        for x in leaves:
            comm.mix_matching(x, partners)
    return tree


# ----------------------------------------------------------------------------
# Local-steps (DiLoCo-style) wrapper: H local optimizer steps, then one
# parameter synchronization — the paper's sync/async trade-off for LMs.
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LocalStepsConfig:
    sync: str = "gossip-hypercube"   # parse_sync spec
    local_steps: int = 1             # H: optimizer steps between syncs
    sync_params: bool = True         # average params (vs. gradients)


def make_sync_fn(cfg: LocalStepsConfig, mesh: comm_mod.Mesh,
                 axis_names: Sequence[str] = ("data",)):
    """Return sync(tree) over the ranks of ``axis_names`` of ``mesh``."""
    spec = parse_sync(cfg.sync)

    def sync(tree):
        return sync_tree_mesh(tree, spec, mesh, axis_names)

    return sync
