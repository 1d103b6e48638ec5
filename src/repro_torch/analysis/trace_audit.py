"""Declarative invariant audits over the port's entry points.

The torch counterpart of ``repro.analysis.trace_audit``, under the same
public names. The paper's guarantee is structural (raw documents never
leave a node, only sufficient statistics move), and the Scale, Eval and
Serving layers add two more: no dense topic-matrix temporary on the
blocked paths, and one build per kernel. The reference checks them on
the compiled module of each entry point; the port runs eagerly, so each
entry point is *run* at the reference's audit sizes and checked on what
it did:

- :class:`InvariantSpec` (the reference's fields) and :func:`audit_ops`
  in place of ``audit_hlo_text``: the five rules ``collective-allowlist``,
  ``privacy-doc-buffer``, ``replica-groups``, ``collective-count`` and
  ``temp-budget`` over the calls a
  :class:`~repro_torch.analysis.collectives.Recorder` saw.
- :class:`TempMeter`: the bytes of tensors alive at the call's peak above
  what was allocated when it started. On the card the caching
  allocator's peak; on the CPU a ``TorchDispatchMode`` that adds each new
  output storage's bytes and takes them off when the storage is freed.
- :class:`CompileCounter`: "one trace per entry point" becomes "one
  library load per kernel per process, and at most one ``nvcc`` run per
  library", counted at ``kernels.common``'s ``ctypes.CDLL`` and
  ``subprocess.Popen`` calls.
- :data:`ENTRY_POINTS`: the reference's ten rows under its names and
  specs, each built on its port counterpart. The mesh rows run in a world
  of :data:`MESH_WORLD` gloo ranks (the grid is 2 x 2; no golden count
  depends on its size). :data:`PLANTED` holds rows that must fail.
- :func:`check_against_golden`: the inventories held against the
  reference's own ``tests/golden_collectives.json``, read-only.

A mesh row's inventory is the busiest rank's count of each kind (every
rank of the audited rows makes the same calls); the count budget holds
on every rank.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import re
import weakref
from typing import Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.analysis.collectives import CollectiveOp, Recorder

__all__ = ["GOSSIP_ALLOWED", "InvariantSpec", "Violation", "AuditReport",
           "audit_ops", "TempMeter", "CompileCounter", "EntryPoint",
           "ENTRY_POINTS", "PLANTED", "MESH_WORLD", "GOLDEN",
           "run_audits", "mesh_rank_ops", "reports_from_ranks",
           "collect_inventories", "check_against_golden", "load_golden"]

GOSSIP_ALLOWED = frozenset({"collective-permute"})
GOLDEN = (pathlib.Path(__file__).resolve().parents[3] / "tests"
          / "golden_collectives.json")
MESH_WORLD = 4
LAUNCH_TIMEOUT_S = 300          # a hung rank fails the audit, not the run


@dataclasses.dataclass(frozen=True)
class InvariantSpec:
    """What one entry point may do (the reference's fields and meaning).

    ``allowed_collectives`` the kinds that may appear at all;
    ``max_counts`` per-kind ceilings on one rank; ``doc_len`` the privacy
    boundary: no call may send an integer tensor whose trailing dim is
    the document length (``forbidden_dims`` adds exact shapes);
    ``replica_groups`` with ``grouped_kinds``: every call of those kinds
    must run over one of these groups of ranks (a node-axis reduce on the
    grid groups otherwise); ``max_temp_bytes`` the peak-temp budget,
    pinned below a dense topic-matrix temporary.
    """

    name: str
    allowed_collectives: frozenset[str] = frozenset()
    max_counts: tuple[tuple[str, int], ...] = ()
    doc_len: int | None = None
    forbidden_dims: tuple[tuple[int, ...], ...] = ()
    replica_groups: tuple[tuple[int, ...], ...] | None = None
    grouped_kinds: frozenset[str] = frozenset()
    max_temp_bytes: int | None = None


@dataclasses.dataclass(frozen=True)
class Violation:
    spec: str
    rule: str
    message: str

    def __str__(self):
        return f"[{self.spec}] {self.rule}: {self.message}"


@dataclasses.dataclass
class AuditReport:
    spec: InvariantSpec
    ops: list[CollectiveOp]
    violations: list[Violation]
    temp_bytes: int | None = None

    @property
    def ok(self) -> bool:
        return not self.violations

    @property
    def inventory(self) -> dict[str, int]:
        return _inventory(self.ops)

    def summary(self) -> str:
        inv = ", ".join(f"{k}={v}" for k, v in sorted(self.inventory.items()))
        head = (f"{self.spec.name}: collectives {{{inv or 'none'}}}"
                + (f", temp={self.temp_bytes}B"
                   if self.temp_bytes is not None else ""))
        if self.ok:
            return head + " — OK"
        return head + "\n" + "\n".join(f"  FAIL {v}" for v in self.violations)


def _inventory(ops) -> dict[str, int]:
    """Per kind, the most calls any one rank made."""
    per_rank: dict[int, dict[str, int]] = {}
    for op in ops:
        counts = per_rank.setdefault(op.rank, {})
        counts[op.kind] = counts.get(op.kind, 0) + 1
    inv: dict[str, int] = {}
    for counts in per_rank.values():
        for kind, n in counts.items():
            inv[kind] = max(inv.get(kind, 0), n)
    return inv


def _where(op: CollectiveOp) -> str:
    return f"rank {op.rank} {op.name} over {list(op.group)}"


def _doc_shaped(op: CollectiveOp, spec: InvariantSpec) -> list[str]:
    bad = []
    for s in op.shapes:
        if s.dims in spec.forbidden_dims:
            bad.append(f"forbidden shape {s.dtype}{list(s.dims)}")
        elif (spec.doc_len is not None and s.is_integer and len(s.dims) >= 1
              and s.dims[-1] == spec.doc_len):
            bad.append(f"doc-shaped token buffer {s.dtype}{list(s.dims)} "
                       f"(trailing dim == L={spec.doc_len})")
    return bad


def audit_ops(ops, spec: InvariantSpec,
              temp_bytes: int | None = None) -> AuditReport:
    """Audit the recorded calls of one entry point (every rank's) and its
    metered temp bytes against one spec."""
    ops = list(ops)
    violations: list[Violation] = []
    for op in ops:
        if op.kind not in spec.allowed_collectives:
            violations.append(Violation(
                spec.name, "collective-allowlist",
                f"{op.kind} not in allow-list "
                f"{sorted(spec.allowed_collectives)}: {_where(op)}"))
        for msg in _doc_shaped(op, spec):
            violations.append(Violation(
                spec.name, "privacy-doc-buffer",
                f"{op.kind} moves a {msg}: {_where(op)}"))
        if spec.replica_groups is not None and op.kind in spec.grouped_kinds:
            want = {frozenset(g) for g in spec.replica_groups}
            if frozenset(op.group) not in want:
                violations.append(Violation(
                    spec.name, "replica-groups",
                    f"{op.kind} groups {list(op.group)} not one of "
                    f"{spec.replica_groups}: {_where(op)}"))
    busiest = _inventory(ops)
    for kind, cap in spec.max_counts:
        worst = busiest.get(kind, 0)
        if worst > cap:
            violations.append(Violation(
                spec.name, "collective-count",
                f"{worst} {kind} ops on one rank > budget {cap}"))
    if spec.max_temp_bytes is not None and temp_bytes is not None:
        if temp_bytes > spec.max_temp_bytes:
            violations.append(Violation(
                spec.name, "temp-budget",
                f"peak temp {temp_bytes}B > budget "
                f"{spec.max_temp_bytes}B (dense-beta regression?)"))
    return AuditReport(spec, ops, violations, temp_bytes)


# ---------------------------------------------------------------------------
# The temp meter
# ---------------------------------------------------------------------------

class _StorageMeter(TorchDispatchMode):
    """Bytes of the storages the ops inside the mode allocate, alive."""

    def __init__(self):
        super().__init__()
        self.live: dict[int, int] = {}
        self.current = 0
        self.peak = 0

    def _free(self, ptr: int) -> None:
        self.current -= self.live.pop(ptr, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        inputs = {t.untyped_storage().data_ptr()
                  for t in tree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor)}
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            ptr, n = st.data_ptr(), st.nbytes()
            if n == 0 or ptr in inputs or ptr in self.live:
                continue            # a view, an in-place result, or known
            self.live[ptr] = n
            self.current += n
            self.peak = max(self.peak, self.current)
            weakref.finalize(st, self._free, ptr)
        return out


class TempMeter:
    """``with TempMeter(device) as m: ...``; then ``m.bytes`` is the peak
    bytes of tensors alive during the block above what was allocated
    when it started (outputs still alive included)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.bytes: int | None = None

    def __enter__(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
            self._base = torch.cuda.memory_allocated(self.device)
        else:
            self._mode = _StorageMeter()
            self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.bytes = (torch.cuda.max_memory_allocated(self.device)
                          - self._base)
        else:
            self._mode.__exit__(*exc)
            self.bytes = self._mode.peak
        return False


# ---------------------------------------------------------------------------
# Compile counter: one library load per kernel, at most one nvcc run
# ---------------------------------------------------------------------------

class _Counting:
    """Stands in for a module inside ``kernels.common``: every attribute
    is the module's, but calls of ``attr`` are counted by kernel (the
    ``lib<name>-<hash>`` stem of the library path they name) first."""

    def __init__(self, module, attr, counts, path_of):
        self._module, self._attr = module, attr
        self._counts, self._path_of = counts, path_of

    def __getattr__(self, name):
        fn = getattr(self._module, name)
        if name != self._attr:
            return fn

        def counted(*args, **kwargs):
            m = _LIB_STEM.match(pathlib.Path(self._path_of(args)).name)
            if m and m.group(1) in self._counts:
                self._counts[m.group(1)] += 1
            return fn(*args, **kwargs)
        return counted


_LIB_STEM = re.compile(r"lib(.+)-[0-9a-f]{16}\.")


class CompileCounter:
    """Counts kernel library loads and ``nvcc`` runs across a ``with``
    block, for the named kernels (``kernels.common.KERNEL_NAMES``):

        with CompileCounter(*common.KERNEL_NAMES) as cc:
            ... drive the main path ...
        assert all(n == 1 for n in cc.counts.values()), cc.counts

    ``counts`` the ``ctypes.CDLL`` calls ``kernels.common`` makes on each
    kernel's library, ``builds`` the ``nvcc`` processes it starts for
    each: the calls themselves, so a path around ``common.load``'s cache
    or ``build_all``'s up-to-date check reads more than one.
    """

    def __init__(self, *names):
        from repro_torch.kernels import common
        if not names:
            raise ValueError("CompileCounter needs at least one kernel name")
        unknown = sorted(set(names) - set(common.KERNEL_NAMES))
        if unknown:
            raise ValueError(f"unknown kernels {unknown}; known: "
                             f"{list(common.KERNEL_NAMES)}")
        self.names = names
        self.counts: dict[str, int] = {}
        self.builds: dict[str, int] = {}

    def __enter__(self):
        from repro_torch.kernels import common
        self.counts = dict.fromkeys(self.names, 0)
        self.builds = dict.fromkeys(self.names, 0)
        self._saved = common.ctypes, common.subprocess
        common.ctypes = _Counting(common.ctypes, "CDLL", self.counts,
                                  lambda args: args[0])
        common.subprocess = _Counting(
            common.subprocess, "Popen", self.builds,
            lambda args: args[0][args[0].index("-o") + 1])
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import common
        common.ctypes, common.subprocess = self._saved
        return False

    @property
    def total(self) -> int:
        return sum(self.counts.values())


# ---------------------------------------------------------------------------
# Entry-point registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EntryPoint:
    """One audited entry point: ``build(device)`` makes its inputs and
    returns the call to audit; ``world`` is the ranks it runs on (1: this
    process; more: every rank of a gloo world builds and calls it)."""

    spec: InvariantSpec
    build: Callable[[torch.device], Callable[[], object]]
    world: int = 1


_L = 8          # audit doc length; shared so privacy specs can name it
_BIG_V = 50_000  # vocab size for the no-dense-beta budget rows
_BIG_K = 8
_SLAB = dict(c=8, el=64, k=_BIG_K, v=_BIG_V)
# the PRNG checks' slabs, at the reference prng lint's sizes
PRNG_SLAB = dict(c=4, el=8, k=3, v=32)
_TAU, _ALPHA = 0.01, 0.5


def _tiny_lda():
    from repro_torch.core.lda import LDAConfig
    return LDAConfig(n_topics=3, vocab_size=32, alpha=0.5, doc_len_max=_L,
                     n_gibbs=4, n_gibbs_burnin=2)


def _bound(call):
    """A registry ``build`` from a ``call(dev) -> (fn, args)``."""
    def build(dev):
        fn, args = call(dev)
        return lambda: fn(*args)
    return build


def _segment(cfg, key, words, mask, schedule, corr):
    """One DELEDA segment from the step-0 state: the per-node init split,
    then ``train_steps``."""
    from repro_torch.core import deleda
    state = deleda.init_state(cfg, key, words.shape[0])
    return deleda.train_steps(cfg, state, words, mask, schedule, corr,
                              record_every=2)


def _deleda_call(vocab_shards: int = 1):
    """``call(dev) -> (_segment, args)`` on seeded tokens: 4 nodes of 6
    docs, 4 async steps."""
    def call(dev):
        from repro_torch.core import deleda
        from repro_torch.core import threefry as tf3
        from repro_torch.core.graph import complete_graph
        n, d, t = 4, 6, 4
        lda = _tiny_lda()
        cfg = deleda.DeledaConfig(lda=lda, mode="async", batch_size=3,
                                  vocab_shards=vocab_shards)
        schedule, _degs = deleda.make_run_inputs(complete_graph(n), t, seed=0)
        words = torch.as_tensor(np.random.default_rng(0).integers(
            0, lda.vocab_size, (n, d, _L)), device=dev)
        mask = torch.ones((n, d, _L), dtype=torch.bool, device=dev)
        corr = torch.ones((t, n), dtype=torch.float32, device=dev)
        return _segment, (cfg, tf3.key(0, dev), words, mask, schedule, corr)
    return call


def _slab_inputs(dev, size):
    """A slab's seeded inputs at ``size`` (``c`` docs of ``el`` tokens,
    ``k`` x ``v``): key, doc ids, tokens, a ragged mask and a ``[K, V]``
    statistic."""
    from repro_torch.core import threefry as tf3
    g = np.random.default_rng(0)
    c, el = size["c"], size["el"]
    ids = torch.arange(c, device=dev)
    words = torch.as_tensor(g.integers(0, size["v"], (c, el)), device=dev)
    mask = torch.as_tensor(np.arange(el)[None, :]
                           < g.integers(1, el + 1, (c, 1)), device=dev)
    stats = torch.as_tensor(g.gamma(1.0, 1.0, (size["k"], size["v"])),
                            dtype=torch.float32, device=dev)
    return tf3.key(0, dev), ids, words, mask, stats


def _eval_call(dev, size=_SLAB):
    """``(eval_chunk, (key, ids, words, mask))`` of the fused eval chunk."""
    from repro_torch.core import evaluation
    key, ids, words, mask, stats = _slab_inputs(dev, size)

    def eval_chunk(key, ids, words, mask):
        return evaluation.ll_slab_from_stats(
            key, ids, words, mask, stats, _TAU, _ALPHA, n_particles=2)
    return eval_chunk, (key, ids, words, mask)


def _slab_server(dev, size=_SLAB):
    """A server of the audit statistic with its denominator cached: the
    statistic is held as [K, S, V/S], so a slab gathers its columns from
    the statistic through the cached denominator (no dense beta)."""
    from repro_torch.core import serving
    key, ids, words, mask, stats = _slab_inputs(dev, size)
    k, v = size["k"], size["v"]
    state = serving.ServingState(stats.view(k, 4, v // 4), tau=_TAU)
    state.denom()
    server = serving.TopicServer(state, alpha=_ALPHA, key=key,
                                 doc_len_max=size["el"], n_particles=2,
                                 mixture_sweeps=4, mixture_burnin=2)
    return server, ids, words, mask


def _serve_call(kind: str):
    """``call(dev, size) -> (slab, (ids, words, mask))`` of one serving
    slab."""
    def call(dev, size=_SLAB):
        server, ids, words, mask = _slab_server(dev, size)

        def slab(ids, words, mask):
            return server._run_slab(kind, ids, words, mask)
        slab.__name__ = f"serve_slab_{kind}"
        return slab, (ids, words, mask)
    return call


def _build_dense_slab(dev):
    """Planted: a mixture slab that materializes the dense ``[K, V]``
    beta inside the call (what the cached-denominator path avoids)."""
    from repro_torch.core import estep
    from repro_torch.core import lda as lda_mod
    server, ids, words, mask = _slab_server(dev)
    stats = server.state.stats.reshape(_BIG_K, _BIG_V)

    def run():
        beta = lda_mod.eta_star(stats, _TAU)
        return estep.theta_slab(server.key, ids, beta.T[words],
                                mask.to(beta.dtype), alpha=_ALPHA,
                                n_sweeps=4, burnin=2)
    return run


def _mesh_comm(grid):
    from repro_torch.core import comm as comm_mod
    if grid is None:
        return comm_mod.MeshComm()
    return comm_mod.MeshComm(comm_mod.make_grid_mesh(*grid),
                             vocab_axis="vocab")


def _mesh_stats(comm, dev):
    n, k, v = 8, 3, 32
    return comm.shard(torch.zeros((n, k, v), dtype=torch.float32,
                                  device=dev)).contiguous()


def _build_mesh_pass(grid):
    """One gossip pass: every node matched to the node one node-device
    over (``i ^ n_local``), so each rank makes one exchange."""
    def build(dev):
        comm = _mesh_comm(grid)
        stats = _mesh_stats(comm, dev)
        n_local = stats.shape[0]
        partners = np.arange(8, dtype=np.int32) ^ n_local
        return lambda: comm.mix_matching(stats, partners)
    return build


def _build_mesh_local(dev):
    """The intra-rank mix: every pair inside one rank's block."""
    comm = _mesh_comm(None)
    stats = _mesh_stats(comm, dev)
    partners = np.arange(8, dtype=np.int32) ^ 1
    return lambda: comm.mix_matching(stats, partners)


def _build_update_step(grid):
    def build(dev):
        from repro_torch.core import threefry as tf3
        from repro_torch.launch.gossip_sim import build_update_step
        lda = _tiny_lda()
        comm = _mesh_comm(grid)
        step = build_update_step(lda, 3, comm)
        stats = _mesh_stats(comm, dev)
        n_local, d = stats.shape[0], 6
        steps = torch.zeros((n_local,), dtype=torch.int32, device=dev)
        words = torch.zeros((n_local, d, _L), dtype=torch.int64, device=dev)
        mask = torch.ones((n_local, d, _L), dtype=torch.bool, device=dev)
        alive = np.ones((n_local,), bool)
        return lambda: step(stats, steps, tf3.key(0, dev), words, mask, alive)
    return build


def _build_doc_gather(dev):
    """Planted: every rank's raw ``[B, L]`` token block gathered to all."""
    import torch.distributed as dist
    docs = torch.zeros((4, _L), dtype=torch.int64)
    parts = [torch.empty_like(docs) for _ in range(dist.get_world_size())]
    return lambda: dist.all_gather(parts, docs)


def _build_node_reduce(dev):
    """Planted: a statistic all-reduced over the grid's node axis."""
    comm = _mesh_comm(_GRID)
    stats = _mesh_stats(comm, dev)
    return lambda: comm.all_reduce(stats.sum(0), comm.axis_name)


def _vocab_groups(grid: tuple[int, int]) -> tuple[tuple[int, ...], ...]:
    """Vocab-axis groups of a node x vocab grid of ranks (row-major)."""
    nd, vd = grid
    return tuple(tuple(range(r * vd, (r + 1) * vd)) for r in range(nd))


_GRID = (2, 2)
_GRID_SPEC = InvariantSpec(
    "grid_estep_2d", allowed_collectives=frozenset({"all-reduce"}),
    max_counts=(("all-reduce", 2),), doc_len=_L,
    replica_groups=_vocab_groups(_GRID),
    grouped_kinds=frozenset({"all-reduce"}))
_SLAB_BUDGET = 1 << 20

ENTRY_POINTS: dict[str, EntryPoint] = {
    # one process: the simulation segment, the fused eval chunk, the
    # serving slabs make no collective; the big-V rows stay under the
    # dense-beta budget. eval_chunk derives the row normaliser itself,
    # one [K, V] add-temporary (1.6 MB); the budget allows that but not a
    # second dense [K, V]. The serving slabs get the cached denominator
    # and must stay column gathers: 1 MiB sits below ONE dense [K, V].
    "deleda_scan": EntryPoint(
        InvariantSpec("deleda_scan", doc_len=_L), _bound(_deleda_call(1))),
    "deleda_scan_sharded": EntryPoint(
        InvariantSpec("deleda_scan_sharded", doc_len=_L),
        _bound(_deleda_call(4))),
    "eval_chunk": EntryPoint(
        InvariantSpec("eval_chunk", doc_len=_SLAB["el"],
                      max_temp_bytes=int(2.5 * (1 << 20))),
        _bound(_eval_call)),
    "serve_slab_ll": EntryPoint(
        InvariantSpec("serve_slab_ll", doc_len=_SLAB["el"],
                      max_temp_bytes=_SLAB_BUDGET),
        _bound(_serve_call("ll"))),
    "serve_slab_mixture": EntryPoint(
        InvariantSpec("serve_slab_mixture", doc_len=_SLAB["el"],
                      max_temp_bytes=_SLAB_BUDGET),
        _bound(_serve_call("mixture"))),
    # mesh rows (4 gloo ranks): the gossip is point-to-point only, the
    # local mix and the 1-D update make no collective, and the grid's
    # only collectives are the two vocab-group all-reduces of the beta
    # assembly, never over the node axis, never a doc-shaped tensor
    "mesh_local_1d": EntryPoint(
        InvariantSpec("mesh_local_1d", doc_len=_L), _build_mesh_local,
        world=MESH_WORLD),
    "mesh_pass_1d": EntryPoint(
        InvariantSpec("mesh_pass_1d", allowed_collectives=GOSSIP_ALLOWED,
                      max_counts=(("collective-permute", 1),), doc_len=_L),
        _build_mesh_pass(None), world=MESH_WORLD),
    "mesh_pass_2d": EntryPoint(
        InvariantSpec("mesh_pass_2d", allowed_collectives=GOSSIP_ALLOWED,
                      max_counts=(("collective-permute", 1),), doc_len=_L),
        _build_mesh_pass(_GRID), world=MESH_WORLD),
    "update_step_1d": EntryPoint(
        InvariantSpec("update_step_1d", doc_len=_L),
        _build_update_step(None), world=MESH_WORLD),
    "grid_estep_2d": EntryPoint(_GRID_SPEC, _build_update_step(_GRID),
                                world=MESH_WORLD),
}

# rows that must fail, each under a real row's spec: the auditor's own
# negative checks (raw documents gathered across ranks; a node-axis
# reduce on the grid; a dense [K, V] beta inside a serving slab)
PLANTED: dict[str, EntryPoint] = {
    "planted_doc_gather": EntryPoint(
        dataclasses.replace(ENTRY_POINTS["mesh_pass_1d"].spec,
                            name="planted_doc_gather"),
        _build_doc_gather, world=MESH_WORLD),
    "planted_node_reduce": EntryPoint(
        dataclasses.replace(_GRID_SPEC, name="planted_node_reduce"),
        _build_node_reduce, world=MESH_WORLD),
    "planted_dense_temp": EntryPoint(
        dataclasses.replace(ENTRY_POINTS["serve_slab_mixture"].spec,
                            name="planted_dense_temp"), _build_dense_slab),
}


def _lookup(name: str) -> EntryPoint:
    if name in ENTRY_POINTS:
        return ENTRY_POINTS[name]
    if name in PLANTED:
        return PLANTED[name]
    raise KeyError(f"unknown entry point {name!r}")


def _run_one(ep: EntryPoint, device, meter: bool):
    """Build one entry point, then call it under the recorder (and the
    temp meter): its calls and temp bytes."""
    run = ep.build(torch.device(device))
    with Recorder() as rec:
        if meter:
            with TempMeter(device) as m:
                run()
            return rec.ops, m.bytes
        run()
    return rec.ops, None


def mesh_rank_ops(names, device="cuda") -> dict[str, list[CollectiveOp]]:
    """Call on every rank of a world of :data:`MESH_WORLD` ranks: this
    rank's recorded calls for each named mesh row, in order."""
    out = {}
    for name in names:
        ep = _lookup(name)
        if ep.world != MESH_WORLD:
            raise ValueError(f"{name} is not a mesh row")
        out[name], _ = _run_one(ep, device, meter=False)
    return out


def _mesh_world(names, device):
    """What the spawned ranks run: every rank's calls, on rank 0."""
    import torch.distributed as dist
    mine = mesh_rank_ops(names, device)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return {name: [r[name] for r in every] for name in names}


def reports_from_ranks(by_name: dict[str, list]) -> dict[str, AuditReport]:
    """Reports of mesh rows from every rank's calls (``{name: [ops of
    rank 0, ops of rank 1, ...]}``)."""
    return {name: audit_ops([op for ops in ranks for op in ops],
                            _lookup(name).spec)
            for name, ranks in by_name.items()}


def run_audits(names=None, device="cuda") -> dict[str, AuditReport]:
    """Run and audit the named rows (default: all of
    :data:`ENTRY_POINTS`); the mesh rows together in one spawned world
    of :data:`MESH_WORLD` gloo ranks, their tensors on ``device``."""
    from repro_torch import resolve_device
    dev = resolve_device(device)
    names = list(ENTRY_POINTS) if names is None else list(names)
    for name in names:
        _lookup(name)
    reports = {}
    mesh = [n for n in names if _lookup(n).world > 1]
    for name in names:
        ep = _lookup(name)
        if ep.world == 1:
            ops, temp = _run_one(ep, dev,
                                 meter=ep.spec.max_temp_bytes is not None)
            reports[name] = audit_ops(ops, ep.spec, temp)
    if mesh:
        from repro_torch.launch import gossip_sim
        by_name = gossip_sim.launch(_mesh_world, MESH_WORLD, "gloo",
                                    (mesh, str(dev)),
                                    timeout_s=LAUNCH_TIMEOUT_S)
        reports.update(reports_from_ranks(by_name))
    return {name: reports[name] for name in names}


# ---------------------------------------------------------------------------
# The golden: the reference's, read-only
# ---------------------------------------------------------------------------

def collect_inventories(reports: dict[str, AuditReport]) -> dict:
    """Per entry point, per-kind collective counts (the golden's form)."""
    return {name: {"collectives": dict(sorted(r.inventory.items()))}
            for name, r in sorted(reports.items())}


def check_against_golden(reports: dict[str, AuditReport],
                         golden: dict) -> list[str]:
    """Mismatches between the audited inventories and the reference's
    pinned golden (counts per kind; entry points in both compared)."""
    problems = []
    for name, report in sorted(reports.items()):
        if name not in golden:
            problems.append(f"{name}: not in the reference's golden")
            continue
        want = golden[name]["collectives"]
        got = report.inventory
        if got != want:
            problems.append(f"{name}: collective inventory {got} != "
                            f"pinned {want}")
    return problems


def load_golden(path=GOLDEN) -> dict:
    with open(path) as f:
        return json.load(f)
