"""PRNG-stream check: key reuse and batch-position streams, at run time.

The torch counterpart of ``repro.analysis.prng_lint``. The reference
walks the key-derivation graph of a jaxpr, and says its bit-exact
threefry replica "is invisible here by design"; the port's streams run
through exactly such a replica (``repro_torch.core.threefry``), with no
graph to walk. So the check is a tracer: :class:`KeyTracer` wraps the
replica's key consumers for the length of a ``with`` block and records
each key value they consume, row by row of a batched key:

* ``key-reuse``: the same key value drawn from twice (``random_bits``,
  ``split``, ``split2_data`` and the column draws), drawn from and also
  folded, or folded twice with the same data. ``fold_in`` with distinct
  data derives distinct keys and is the idiom (per item, per step, per
  position).
* ``batch-split``: ``split(key, n)`` with n equal to the audited call's
  batch size: item i's stream then depends on its position in the batch
  (the reference's eval bug). A pair split is never one.

:func:`check_fn` keeps the reference's contract (reuse never allowed, up
to ``allow_batch_splits`` batch splits). Draws made inside a kernel on
the card (``lda_l2r``'s stream) are invisible to a Python tracer;
:func:`chunk_invariant` covers them by running a slab whole and in two
chunks and comparing the results bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["KEY_CONSUMERS", "KeyFinding", "KeyTracer", "lint_fn",
           "check_fn", "chunk_invariant"]

# the replica's functions that consume a key operand; the draws built on
# them (uniform, randint, exponential, uniform_halves, uniform_column)
# consume through these
KEY_CONSUMERS = ("random_bits", "split", "split2_data", "fold_in_data",
                 "_halves_bits")


@dataclasses.dataclass(frozen=True)
class KeyFinding:
    kind: str           # "key-reuse" | "batch-split" | "chunk-variant"
    primitive: str
    message: str

    def __str__(self):
        return f"{self.kind}: {self.message}"


def _rows(kd: torch.Tensor) -> list[tuple[int, int]]:
    return [tuple(r) for r in kd.detach().reshape(-1, 2).cpu().tolist()]


class KeyTracer:
    """Records the key values the threefry replica consumes.

    Only the outermost consumer of a call chain records (``split`` draws
    through ``random_bits``: one consumption). ``findings(batch)`` turns
    the record into :class:`KeyFinding` s.
    """

    def __init__(self):
        self.draws: dict[tuple[int, int], list[str]] = {}
        self.folds: dict[tuple[int, int, int], int] = {}
        self.splits: list[int] = []
        self._depth = 0
        self._orig = {}

    def _record(self, name, kd, args, kwargs):
        if name == "fold_in_data":
            data = torch.as_tensor(args[0] if args else kwargs["data"],
                                   dtype=torch.int64,
                                   device=kd.device) & 0xFFFFFFFF
            k0, k1, d = torch.broadcast_tensors(kd[..., 0], kd[..., 1], data)
            for t in zip(*(x.reshape(-1).cpu().tolist()
                           for x in (k0, k1, d))):
                self.folds[t] = self.folds.get(t, 0) + 1
            return
        for row in _rows(kd):
            self.draws.setdefault(row, []).append(name)
        if name == "split":
            self.splits.append(int(args[0] if args else kwargs.get("n", 2)))

    def _wrap(self, name, fn):
        def traced(kd, *args, **kwargs):
            if self._depth == 0:
                self._record(name, kd, args, kwargs)
            self._depth += 1
            try:
                return fn(kd, *args, **kwargs)
            finally:
                self._depth -= 1
        return traced

    def __enter__(self):
        from repro_torch.core import threefry as tf3
        for name in KEY_CONSUMERS:
            self._orig[name] = getattr(tf3, name)
            setattr(tf3, name, self._wrap(name, self._orig[name]))
        return self

    def __exit__(self, *exc):
        from repro_torch.core import threefry as tf3
        for name, fn in self._orig.items():
            setattr(tf3, name, fn)
        self._orig.clear()
        return False

    def findings(self, batch: int | None = None) -> list[KeyFinding]:
        out = []
        folded = {(k0, k1) for k0, k1, _d in self.folds}
        for key, prims in self.draws.items():
            uses = prims + (["fold_in_data"] if key in folded else [])
            if len(uses) > 1:
                out.append(KeyFinding(
                    "key-reuse", uses[0],
                    f"key {list(key)} consumed {len(uses)} times "
                    f"({', '.join(uses)}): every consumption after the "
                    f"first reuses the same stream"))
        for (k0, k1, d), n in self.folds.items():
            if n > 1:
                out.append(KeyFinding(
                    "key-reuse", "fold_in_data",
                    f"key {[k0, k1]} folded with {d} {n} times: the "
                    f"derived key is the same each time"))
        for n in self.splits:
            if batch is not None and n == batch and n > 2:
                out.append(KeyFinding(
                    "batch-split", "split",
                    f"split(key, {n}) over a batch of {batch} creates "
                    f"batch-position-dependent streams; per-item "
                    f"fold_in(key, item_id) keeps results invariant to "
                    f"batching"))
        return out


def _batch_of(args) -> int | None:
    """The audited call's batch: the leading dim of its first integer
    tensor of two or more dims (its documents)."""
    for a in args:
        if (isinstance(a, torch.Tensor) and a.dim() >= 2
                and not a.is_floating_point() and a.dtype != torch.bool):
            return int(a.shape[0])
    return None


def lint_fn(fn, *args, **kwargs) -> list[KeyFinding]:
    """Run ``fn(*args, **kwargs)`` under a :class:`KeyTracer`; every
    finding, the batch being the leading dim of the first integer tensor
    argument of two or more dims (the documents)."""
    with KeyTracer() as tracer:
        fn(*args, **kwargs)
    return tracer.findings(_batch_of(args))


def check_fn(fn, *args, allow_batch_splits: int = 0,
             **kwargs) -> list[KeyFinding]:
    """Run and filter: key reuse is never allowed; up to
    ``allow_batch_splits`` batch splits are (the training segment's
    per-node init split is its semantics; eval and serving must be
    chunk-invariant and allow 0)."""
    findings = lint_fn(fn, *args, **kwargs)
    reuse = [f for f in findings if f.kind == "key-reuse"]
    splits = [f for f in findings if f.kind == "batch-split"]
    return reuse + splits[allow_batch_splits:]


def chunk_invariant(fn, *args, batched=(1, 2, 3),
                    **kwargs) -> list[KeyFinding]:
    """Run a slab whole and in two chunks (the arguments at positions
    ``batched`` cut along dim 0; by default the doc ids, words and mask
    after the key) and report any difference, bit for bit."""
    c = int(args[batched[0]].shape[0])
    h = c // 2

    def part(sl):
        return fn(*(a[sl] if i in batched else a
                    for i, a in enumerate(args)), **kwargs)

    whole = fn(*args, **kwargs)
    chunked = torch.cat([part(slice(0, h)), part(slice(h, c))])
    if torch.equal(whole, chunked):
        return []
    name = getattr(fn, "__name__", None) or getattr(
        getattr(fn, "func", None), "__name__", repr(fn))
    rows = (whole != chunked).reshape(c, -1).any(1).nonzero().reshape(-1)
    return [KeyFinding(
        "chunk-variant", name,
        f"{name}: rows {rows.tolist()} of {c} differ when the slab is "
        f"run as chunks of {h} and {c - h}")]
