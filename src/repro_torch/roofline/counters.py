"""Per-device counts of one step, from the ops it dispatches.

The counterpart of the reference's compiled-module readings
(``cost_analysis()`` and the HLO text walk of ``roofline/hlo.py``).
PyTorch compiles nothing here, so :class:`StepCounter`, a
``TorchDispatchMode``, counts the ops one rank runs as they run:

- **FLOPs**: ``torch.utils.flop_counter``'s formulas (those of
  ``FlopCounterMode``) on each op's local tensors;
- **bytes**: each op's tensor inputs and outputs (XLA's "bytes
  accessed"); a view and a collective move none here;
- **collectives**: ``torch.distributed``'s collective ops, under the
  reference's HLO kind names (all-reduce, all-gather, reduce-scatter,
  all-to-all, collective-permute), each with its count and its bytes: a
  functional collective's result, as the reference counts the result
  shapes of the HLO op, and a point-to-point send's tensor;
- **temp**: the peak bytes of the storages the step's ops make, alive at
  once (the analysis layer's storage meter, here also over fake
  tensors).

Over DTensors the mode yields to DTensor's own dispatch (it returns
``NotImplemented`` for a DTensor argument), so it sees what DTensor runs
on each rank: the local ops on the local shards and the collectives of
every redistribution. DTensor also runs each op once on tensors of the
global shape to learn its output's shape; those calls (inside
``ShardingPropagator._fake_mode_lock``) are not counted.

Attention is priced one way on every device. On a CPU tensor (the dry
run) its plain version and, on every device, its backward are each one
custom op (``kernels.flash_attention.ops``): the mode counts its inputs
and outputs as its bytes, not the [S, S] scores the kernel never holds,
and its FLOPs by the formulas registered here, those of the plain ops
inside. On the card the kernel is a ``ctypes`` launch that dispatches no
op: :func:`attention_flops` and :func:`attention_bytes` count it from
its launches by shape, by the same rules.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from collections import defaultdict

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import register_flop_formula

import repro_torch.kernels.flash_attention.ops  # noqa: F401  (its ops)

__all__ = ["StepCounter", "collective_kind", "attention_flops",
           "attention_bytes", "COLLECTIVE_KINDS"]

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

# op name (namespace-free) -> HLO kind
_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_":
    "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}
_NO_DATA = ("wait_tensor", "barrier", "monitored_barrier")

_STATE = threading.local()


def collective_kind(func) -> str | None:
    """The HLO kind of a collective op, ``None`` for any other op."""
    ns = func.namespace
    if ns not in ("_c10d_functional", "c10d_functional", "c10d"):
        return None
    return _KINDS.get(func._overloadpacket.__name__)


class _Propagating:
    """Marks DTensor's global-shape runs (its ``_fake_mode_lock``)."""

    def __init__(self, inner):
        self.inner = inner

    def __enter__(self):
        _STATE.depth = getattr(_STATE, "depth", 0) + 1
        return self.inner.__enter__()

    def __exit__(self, *exc):
        _STATE.depth -= 1
        return self.inner.__exit__(*exc)


@contextlib.contextmanager
def _mark_propagation():
    """DTensor's global-shape runs marked for the counters: through its
    ``_fake_mode_lock`` where this torch has one, else around
    ``_propagate_tensor_meta_non_cached``; neither, and it raises."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    if hasattr(ShardingPropagator, "_fake_mode_lock"):
        prev = ShardingPropagator._fake_mode_lock
        ShardingPropagator._fake_mode_lock = _Propagating(prev)
        try:
            yield
        finally:
            ShardingPropagator._fake_mode_lock = prev
        return
    name = "_propagate_tensor_meta_non_cached"
    inner = getattr(ShardingPropagator, name, None)
    if inner is None:
        raise RuntimeError(
            "this torch's DTensor has neither ShardingPropagator."
            "_fake_mode_lock nor _propagate_tensor_meta_non_cached: the "
            "counters cannot tell its shape runs from the step's ops")

    def marked(*args, **kwargs):
        with _Propagating(contextlib.nullcontext()):
            return inner(*args, **kwargs)

    setattr(ShardingPropagator, name, marked)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, inner)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class StepCounter(TorchDispatchMode):
    """``with StepCounter() as c: step(...)``; then ``c.flops``,
    ``c.bytes``, ``c.collectives`` (``{kind: {"count", "bytes"}}``),
    ``c.collective_bytes`` and ``c.temp_peak``, all for this rank."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.collectives: dict = defaultdict(lambda: {"count": 0,
                                                      "bytes": 0})
        self._live: dict[int, int] = {}
        self._current = 0
        self.temp_peak = 0
        self._marks = None

    @property
    def collective_bytes(self) -> int:
        return sum(v["bytes"] for v in self.collectives.values())

    def __enter__(self):
        self._marks = _mark_propagation()
        self._marks.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._marks.__exit__(*exc)
        self.collectives = {k: dict(v) for k, v in self.collectives.items()}
        return out

    def _free(self, key: int) -> None:
        self._current -= self._live.pop(key, 0)

    def _track(self, inputs, outputs) -> None:
        seen = {t.untyped_storage()._cdata for t in inputs}
        for t in outputs:
            st = t.untyped_storage()
            key, n = st._cdata, st.nbytes()
            if n == 0 or key in seen or key in self._live:
                continue            # a view, an in-place result, or known
            self._live[key] = n
            self._current += n
            self.temp_peak = max(self.temp_peak, self._current)
            weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        leaves = pytree.tree_leaves((args, kwargs))
        if any(isinstance(t, DTensor) for t in leaves):
            return NotImplemented
        out = func(*args, **kwargs)
        if getattr(_STATE, "depth", 0):
            return out
        ins = [t for t in leaves if isinstance(t, torch.Tensor)]
        outs = [t for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        name = func._overloadpacket.__name__
        kind = collective_kind(func)
        if kind is not None:
            rec = self.collectives[kind]
            rec["count"] += 1
            sent = outs if func.namespace != "c10d" else ins[:1]
            rec["bytes"] += sum(_nbytes(t) for t in sent)
            return out
        if name in _NO_DATA or _is_view(func):
            return out
        formula = self._flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        self.bytes += sum(_nbytes(t) for t in ins + outs)
        self._track(ins, outs)
        return out


def _scores(b: int, sq: int, sk: int, h: int, d: int) -> int:
    """One ``Sq x Sk x D`` product of every head: ``2 B H Sq Sk D``."""
    return 2 * b * h * sq * sk * d


@register_flop_formula(torch.ops.repro_torch.flash_attention_plain)
def _plain_flops(q, k, *args, out_shape=None, **kwargs) -> int:
    """The plain forward: the scores and the weighted sum."""
    b, sq, h, d = q
    return 2 * _scores(b, sq, k[1], h, d)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _bwd_flops(q, k, *args, out_shape=None, **kwargs) -> int:
    """The backward: the recomputed scores, dV, dP, dQ and dK."""
    b, sq, h, d = q
    return 5 * _scores(b, sq, k[1], h, d)


def attention_flops(launches_by_shape: dict) -> int:
    """FLOPs of the attention kernel's launches, counted as the dry run
    counts its plain version (and the reference its einsums): the full
    ``Sq x Sk`` scores and the weighted sum of every head, ``4 B H Sq Sk
    D``, whatever the mask. Keys are ``ops.shape_key``'s ``(B, Sq, Sk,
    H, Hkv, D, dtype, ...)``."""
    return sum(n * 2 * _scores(b, sq, sk, h, d)
               for (b, sq, sk, h, _hkv, d, *_), n in
               launches_by_shape.items())


def attention_bytes(launches_by_shape: dict) -> int:
    """Bytes of the attention kernel's launches, counted as the dry run
    counts its plain version: q, k and v read and the output written
    once, ``2 (B Sq H + B Sk Hkv) D`` elements of the launch's dtype."""
    size = {"bf16": 2, "f32": 4}
    return sum(n * 2 * (b * sq * h + b * sk * hkv) * d * size[dt]
               for (b, sq, sk, h, hkv, d, dt, *_), n in
               launches_by_shape.items())
