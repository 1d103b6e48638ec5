"""DTensor helpers for code that runs one rank's shard by hand.

Model code stays written for plain tensors; where an op has no DTensor
sharding rule (the hand-written attention kernel, a cache written in
place) it runs on each rank's local shard. These helpers say where that
shard sits in the global tensor. Nothing here imports
``torch.distributed.tensor`` until it is called with a DTensor.
"""

from __future__ import annotations

import torch

__all__ = ["is_dtensor", "local_offset", "placed", "like", "data_parallel"]


def is_dtensor(x) -> bool:
    if not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def local_offset(x, placements=None, shape=None, mesh=None
                 ) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """``(local_shape, global_offset)`` of this rank's shard of the
    DTensor ``x`` under ``placements`` (default its own); or of a tensor
    of ``shape`` on ``mesh``. Pure Python over the rank's mesh
    coordinate (DTensor's own helper runs tensor ops, which a
    ``FakeTensorMode`` refuses): per mesh dim in order, a sharded dim is
    cut in chunks of ``ceil(size / n)``, as ``Shard`` cuts it."""
    mesh = x.device_mesh if mesh is None else mesh
    placements = x.placements if placements is None else placements
    size = list(x.shape if shape is None else shape)
    offset = [0] * len(size)
    coord = mesh.get_coordinate()
    for i, pl in enumerate(placements):
        if not pl.is_shard():
            continue
        d = pl.dim
        chunk = -(-size[d] // mesh.size(i))
        lo = min(coord[i] * chunk, size[d])
        size[d] = min(size[d], lo + chunk) - lo
        offset[d] += lo
    return tuple(size), tuple(offset)


def placed(t: torch.Tensor, placements) -> torch.Tensor:
    """The DTensor ``t`` under ``placements``: ``t`` itself where it is
    placed so already. (A redistribution to the same placements would
    still reduce a partial gradient in its backward: a parameter that
    two blocks use, the tied embedding table, would be reduced once a
    use instead of once.)"""
    if tuple(t.placements) == tuple(placements):
        return t
    return t.redistribute(t.device_mesh, placements)


def like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t`` placed like ``ref`` when both are DTensors: a sublayer's
    output (a partial sum after a head- or expert-sharded product) put
    back in the residual stream's layout, batch-sharded and whole along
    the sequence, so the next product sees the same layout at every
    layer. Plain tensors pass through."""
    if not (is_dtensor(t) and is_dtensor(ref)) \
            or t.placements == ref.placements:
        return t
    return t.redistribute(ref.device_mesh, ref.placements)


def data_parallel(fn, params, *acts):
    """``fn(params, *acts)`` on each rank's batch shard, with whole
    parameters: for a block with no DTensor rule for its ops (a Mamba2 or
    xLSTM recurrence). The activations (and caches) stay split over the
    mesh dims that split the first DTensor activation's batch dim, and
    are gathered over the others; the parameters are gathered, and their
    gradient is each rank's partial sum over its batch shard. Outputs are
    placed like the activations. Plain tensors run ``fn`` as it is."""
    from torch.utils import _pytree as pytree
    lead = next((t for t in pytree.tree_leaves(acts) if is_dtensor(t)),
                None)
    if lead is None:
        return fn(params, *acts)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = lead.device_mesh
    batch = [pl == Shard(0) for pl in lead.placements]
    pa = tuple(Shard(0) if b else Replicate() for b in batch)
    pr = (Replicate(),) * mesh.ndim
    grad = tuple(Partial() if b else Replicate() for b in batch)

    def local(pl, gpl):
        def one(t):
            if not is_dtensor(t):
                return t
            return placed(t, pl).to_local(grad_placements=gpl)
        return one

    out = fn(pytree.tree_map(local(pr, grad), params),
             *pytree.tree_map(local(pa, pa), acts))
    return pytree.tree_map(
        lambda t: DTensor.from_local(t, mesh, pa, run_check=False)
        if isinstance(t, torch.Tensor) else t, out)
