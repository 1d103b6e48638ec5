"""What the port hands to ``torch.distributed``, recorded call by call.

The torch counterpart of ``repro.analysis.hlo``. The reference parses
the collectives out of post-partitioning HLO text, which an eager torch
program does not have: here a :class:`Recorder` wraps the module-level
``torch.distributed`` calls for the length of a ``with`` block and keeps
one :class:`CollectiveOp` a call, under the reference's HLO kind name
(:data:`KIND_OF`), so specs and the golden inventory read the same in
both packages:

* ``batch_isend_irecv`` -> ``collective-permute`` (the one-hop
  ``ppermute`` of the gossip);
* ``all_reduce`` / ``reduce`` -> ``all-reduce``;
* ``all_gather`` / ``all_gather_into_tensor`` / ``all_gather_object`` /
  ``gather`` -> ``all-gather``;
* ``reduce_scatter_tensor`` -> ``reduce-scatter``; ``all_to_all`` /
  ``scatter`` -> ``all-to-all``; ``broadcast`` -> ``collective-broadcast``.

An op's ``shapes`` are the tensors this rank hands over to be sent (for
a ``batch_isend_irecv``, its ``isend`` tensors), with the reference's
dtype names (``f32``, ``bf16``, ``s64``, ``pred``, ...) for display;
whether a tensor is floating point or integer is taken from the tensor
itself, so a dtype without a name here (``uint32``, say) is still
judged by what it is. ``group`` is
the ranks of the call's process group (for a point-to-point pair, this
rank and its peers). ``barrier`` and ``init_process_group`` move no
payload and are not recorded.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

import torch
import torch.distributed as dist

__all__ = ["KIND_OF", "Shape", "CollectiveOp", "Recorder", "summarize",
           "collective_bytes"]

KIND_OF = {
    "batch_isend_irecv": "collective-permute",
    "all_reduce": "all-reduce",
    "reduce": "all-reduce",
    "all_gather": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_object": "all-gather",
    "gather": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all": "all-to-all",
    "scatter": "all-to-all",
    "broadcast": "collective-broadcast",
}

_DTYPE_NAMES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.int32: "s32", torch.int64: "s64",
    torch.float16: "f16", torch.bfloat16: "bf16", torch.float32: "f32",
    torch.float64: "f64", torch.complex64: "c64", torch.complex128: "c128",
}


@dataclasses.dataclass(frozen=True)
class Shape:
    """One tensor of a call: the reference's dtype name, dims and bytes,
    and whether the tensor is floating point (``is_floating``) or of an
    integer or boolean dtype (``is_integer``), as the tensor says."""

    dtype: str
    dims: tuple[int, ...]
    nbytes: int
    is_floating: bool
    is_integer: bool

    @staticmethod
    def of(t: torch.Tensor) -> "Shape":
        return Shape(_DTYPE_NAMES.get(t.dtype, str(t.dtype)),
                     tuple(int(d) for d in t.shape),
                     t.numel() * t.element_size(), t.is_floating_point(),
                     not (t.is_floating_point() or t.is_complex()))


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    """One ``torch.distributed`` call of one rank.

    ``kind`` the reference's HLO name, ``name`` the torch function,
    ``shapes`` what this rank sends, ``group`` the ranks of the call's
    group, ``phase`` the recorder's label when the call was made,
    ``rank`` the caller's global rank (0 without a process group) and
    ``objects`` the type names of an object collective's payload.
    """

    kind: str
    name: str
    shapes: tuple[Shape, ...]
    group: tuple[int, ...]
    phase: str = ""
    rank: int = 0
    objects: tuple[str, ...] = ()

    @property
    def nbytes(self) -> int:
        return sum(s.nbytes for s in self.shapes)

    @property
    def crosses_ranks(self) -> bool:
        """Whether the call's group holds another rank than the caller."""
        return len(set(self.group) - {self.rank}) > 0


def _ranks(group) -> tuple[int, ...]:
    if group is None:
        return tuple(range(dist.get_world_size()))
    return tuple(dist.get_process_group_ranks(group))


def _sent(name: str, args, kwargs) -> list[torch.Tensor]:
    """The tensors a call hands over to be sent."""
    if name == "batch_isend_irecv":
        return [op.tensor for op in args[0] if op.op is dist.isend]
    if name in ("all_gather", "all_gather_into_tensor"):
        return [args[1] if len(args) > 1 else kwargs["tensor"]]
    if name == "all_to_all":
        return list(args[1] if len(args) > 1 else kwargs["input_tensor_list"])
    if name == "all_gather_object":
        return []
    return [args[0] if args else kwargs["tensor"]]


class Recorder:
    """Records every payload call the port makes to ``torch.distributed``.

    ``with Recorder() as rec:`` replaces the module-level functions named
    in :data:`KIND_OF` by recording wrappers and puts them back on exit;
    ``rec.ops`` holds the calls in order. ``rec.phase`` labels the calls
    made while it is set (a caller marks its own regions).
    ``rec.records`` gives one tuple ``(phase, name, dtype, is_float,
    shape, group)`` a tensor sent and ``rec.objects`` the payload type of
    each object collective.
    """

    NAMES = tuple(KIND_OF)

    def __init__(self):
        self.ops: list[CollectiveOp] = []
        self.phase = "loop"
        self._orig = {}

    @property
    def records(self) -> list[tuple]:
        return [(op.phase, op.name, s.dtype, s.is_floating, s.dims,
                 op.group) for op in self.ops for s in op.shapes]

    @property
    def objects(self) -> list[str]:
        return [o for op in self.ops for o in op.objects]

    def _wrap(self, name, fn):
        def recorded(*args, **kwargs):
            rank = dist.get_rank() if dist.is_initialized() else 0
            if name == "batch_isend_irecv":
                group = tuple(sorted({rank} | {int(op.peer)
                                               for op in args[0]}))
            else:
                group = _ranks(kwargs.get("group"))
            objects = ()
            if name == "all_gather_object":
                obj = args[1] if len(args) > 1 else kwargs["obj"]
                objects = (type(obj).__name__,)
            self.ops.append(CollectiveOp(
                KIND_OF[name], name,
                tuple(Shape.of(t) for t in _sent(name, args, kwargs)),
                group, self.phase, rank, objects))
            return fn(*args, **kwargs)
        return recorded

    def __enter__(self):
        for name in self.NAMES:
            self._orig[name] = getattr(dist, name)
            setattr(dist, name, self._wrap(name, self._orig[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(dist, name, fn)
        self._orig.clear()
        return False


def summarize(ops) -> dict[str, dict[str, int]]:
    """Per collective kind: call count and bytes sent (the reference's
    ``parse_collectives``, over recorded calls)."""
    out: dict[str, dict[str, int]] = defaultdict(
        lambda: {"count": 0, "bytes": 0})
    for op in ops:
        out[op.kind]["count"] += 1
        out[op.kind]["bytes"] += op.nbytes
    return dict(out)


def collective_bytes(ops) -> int:
    """Total bytes the recorded calls sent."""
    return int(sum(v["bytes"] for v in summarize(ops).values()))
