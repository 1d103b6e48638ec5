"""Logical axis names -> mesh axes (MaxText-style sharding rules).

The port's copy of ``repro.sharding.axes``. Every parameter and
activation carries a tuple of *logical* axis names, one per dim. Rules
translate those to mesh axes; unlisted names are replicated. The same
model code then runs on any mesh (single-pod ``(data, model)``,
multi-pod ``(pod, data, model)``, or one rank, where everything maps to
``None``) by swapping the rule set.

Rule sets (the reference's, verbatim):
  LOGICAL_RULES  megatron-style tensor parallelism: weights with a
                 "wide" axis (vocab/heads/mlp/experts) shard over
                 "model"; batch shards over ("pod", "data"); everything
                 else replicated.
  FSDP_RULES     additionally shards the embed axis over ("pod",
                 "data"): ZeRO-3-style parameter sharding for the large
                 dense archs.
  DP_ONLY_RULES  the batch absorbs every mesh axis and parameters
                 replicate (small archs such as xlstm-125m).

A *spec* is a tuple with one entry per tensor dim: ``None``, a mesh axis
name, or a tuple of names (the value of the reference's
``PartitionSpec``, which compares equal to it). A mesh is anything with
named axes and sizes: a ``torch.distributed.device_mesh.DeviceMesh``
with ``mesh_dim_names``, or an :class:`AbstractMesh` (names and sizes
only, the counterpart of ``jax.sharding.AbstractMesh``).
:func:`placements` turns a spec on a ``DeviceMesh`` into DTensor
placements: a tensor dim over two mesh axes becomes ``Shard(d)`` on each
of those mesh dims, in spec order (which is the mesh's order under every
rule set here).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
from torch.utils import _pytree as pytree

__all__ = ["Rules", "LOGICAL_RULES", "FSDP_RULES", "DP_ONLY_RULES",
           "AbstractMesh", "mesh_shape", "logical_to_spec",
           "spec_for_shape", "placements", "logical_sharding",
           "tree_shardings", "tree_shardings_for", "shard_constraint",
           "is_axes_leaf", "zip_axes"]

Rules = Sequence[tuple[str, Optional[object]]]

LOGICAL_RULES: Rules = (
    ("batch", ("pod", "data")),
    ("seq", None),
    ("cache_seq", "model"),    # decode KV cache: context-parallel fallback
    ("tokens", ("pod", "data")),  # flattened B*S activation rows
    ("qseq", "model"),         # query-chunk rows (context parallelism)
    ("vocab", "model"),
    ("heads", "model"),
    ("kv_heads", "model"),
    ("mlp", "model"),
    ("experts", "model"),
    ("embed", None),
    ("embed2", None),          # second embed-sized dim (square projections)
    ("layers", None),
    ("head_dim", None),
    ("state", None),
    ("conv", None),
    ("expert_mlp", None),
    ("mlp2", None),            # square d_inner x d_inner projections (xlstm)
    ("frames", None),
    ("act_embed", None),       # activation feature dim (replicated)
)

FSDP_RULES: Rules = tuple(
    [("embed", ("pod", "data")), ("layers", None)]
    + [r for r in LOGICAL_RULES if r[0] not in ("embed",)])

DP_ONLY_RULES: Rules = tuple(
    [("batch", ("pod", "data", "model"))]
    + [(k, None if v == "model" else v)
       for k, v in LOGICAL_RULES if k != "batch"])


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh as axis sizes and names only: no ranks, no process group."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis name: size}`` of an :class:`AbstractMesh` or a
    ``DeviceMesh`` (whose dims must be named)."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DeviceMesh for logical sharding needs "
                         "mesh_dim_names")
    return dict(zip(names, mesh.shape))


def _names(target) -> tuple[str, ...]:
    return (target,) if isinstance(target, str) else tuple(target)


def logical_to_spec(axes: tuple[str, ...], mesh,
                    rules: Rules = LOGICAL_RULES) -> tuple:
    """Translate a tuple of logical names to a spec on ``mesh``.

    Mesh axes missing from the mesh (e.g. "pod" on a single-pod mesh) are
    dropped; a mesh axis may be consumed at most once per spec.
    """
    table = dict(rules)
    present = set(mesh_shape(mesh))
    used: set[str] = set()
    out = []
    for name in axes:
        target = table.get(name)
        if target is None:
            out.append(None)
            continue
        picked = tuple(a for a in _names(target)
                       if a in present and a not in used)
        used.update(picked)
        if not picked:
            out.append(None)
        elif len(picked) == 1:
            out.append(picked[0])
        else:
            out.append(picked)
    return tuple(out)


# logical names processed LAST in spec_for_shape: they pick up whatever
# mesh axes remain (the KV-cache sequence axis absorbs "model" only when
# the kv_heads axis could not use it: context-parallel decode fallback).
_FALLBACK_NAMES = ("cache_seq",)


def spec_for_shape(shape: tuple[int, ...], axes: tuple[str, ...], mesh,
                   rules: Rules = LOGICAL_RULES) -> tuple:
    """Shape-aware spec: greedy allocation honouring even divisibility.

    E.g. kv_heads=8 on a model=16 mesh falls back to replication instead
    of an uneven sharding; the "cache_seq" axis then absorbs the freed
    "model" axis. One entry per dim of ``shape``.
    """
    table = dict(rules)
    sizes = mesh_shape(mesh)
    used: set[str] = set()
    out: list = [None] * len(shape)

    def name_of(i: int):
        return axes[i] if i < len(axes) else None

    def alloc(i: int):
        name = name_of(i)
        target = table.get(name) if name else None
        if target is None:
            return
        kept, size_so_far = [], 1
        for n in _names(target):
            if n not in sizes or n in used:
                continue
            ax = sizes[n]
            if ax > 1 and shape[i] % (size_so_far * ax) == 0:
                kept.append(n)
                used.add(n)
                size_so_far *= ax
        if kept:
            out[i] = kept[0] if len(kept) == 1 else tuple(kept)

    order = ([i for i in range(len(shape))
              if name_of(i) not in _FALLBACK_NAMES]
             + [i for i in range(len(shape))
                if name_of(i) in _FALLBACK_NAMES])
    for i in order:
        alloc(i)
    return tuple(out)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``: one
    per mesh dim, ``Shard(d)`` where tensor dim ``d`` names that mesh
    axis, else ``Replicate()``. A dim over several mesh axes must name
    them in the mesh's order (DTensor splits over mesh dims in order)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_shape(mesh))
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        idx = [names.index(n) for n in _names(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {d} takes mesh axes "
                             f"{entry} out of the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def logical_sharding(axes: tuple[str, ...], mesh,
                     rules: Rules = LOGICAL_RULES) -> tuple:
    """The placements of ``logical_to_spec(axes)`` on ``mesh``."""
    return placements(logical_to_spec(axes, mesh, rules), mesh)


def is_axes_leaf(x) -> bool:
    """A tuple of logical names (or the empty tuple): a leaf of an axes
    tree, not a container. Named tuples (caches) are containers."""
    return (type(x) is tuple
            and all(isinstance(a, (str, type(None))) for a in x))


def tree_shardings(axes_tree, mesh, rules: Rules = LOGICAL_RULES):
    """Map a tree of logical-axes tuples to placements on ``mesh``."""
    return pytree.tree_map(lambda axes: logical_sharding(axes, mesh, rules),
                           axes_tree, is_leaf=is_axes_leaf)


def zip_axes(fn, tree, axes_tree):
    """``fn(leaf, axes)`` over a tree and its axes tree, matched by dict
    key, named-tuple field and list position (not by flattening order,
    so the two trees' dicts need not list their keys alike)."""
    if is_axes_leaf(axes_tree):
        return fn(tree, axes_tree)
    if isinstance(axes_tree, dict):
        if set(tree) != set(axes_tree):
            raise ValueError(f"keys {sorted(tree)} against axes "
                             f"{sorted(axes_tree)}")
        return {k: zip_axes(fn, tree[k], axes_tree[k]) for k in tree}
    if isinstance(axes_tree, (list, tuple)):
        if len(tree) != len(axes_tree):
            raise ValueError(f"{len(tree)} children against "
                             f"{len(axes_tree)} axes")
        out = [zip_axes(fn, t, a) for t, a in zip(tree, axes_tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    raise TypeError(f"axes tree node {type(axes_tree).__name__}")


def tree_shardings_for(shapes_tree, axes_tree, mesh,
                       rules: Rules = LOGICAL_RULES, as_specs: bool = False):
    """Shape-aware :func:`tree_shardings`: ``shapes_tree`` holds tensors
    (real, meta or fake) with the structure of ``axes_tree``; a leaf
    that is not a tensor (a cache's int index) gets ``None``. Placements
    on a ``DeviceMesh``; specs with ``as_specs`` (any mesh)."""
    def one(x, axes):
        if not isinstance(x, torch.Tensor):
            return None
        spec = spec_for_shape(tuple(x.shape), axes, mesh, rules)
        return spec if as_specs else placements(spec, mesh)
    return zip_axes(one, shapes_tree, axes_tree)


def shard_constraint(x: torch.Tensor, axes: tuple[str, ...], mesh,
                     rules: Rules = LOGICAL_RULES) -> torch.Tensor:
    """Redistribute a DTensor activation to its logical sharding (no-op
    off-mesh or for a plain tensor)."""
    from torch.distributed.tensor import DTensor
    if mesh is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, logical_sharding(axes, mesh, rules))
