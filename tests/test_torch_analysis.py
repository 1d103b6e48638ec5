"""The port's analysis layer against the reference's (``repro.analysis``).

The counterparts of ``tests/test_analysis.py``: the collective recorder
(kinds under the reference's HLO names, shapes, groups, bytes); the
auditor's own negative checks (a planted integer ``[B, L]`` all_gather
across gloo ranks fails the allow-list and the privacy rule, a node-axis
all-reduce on the grid fails the group placement, a dense ``[K, V]``
beta in a serving slab fails the temp budget); the ten registry rows
passing their specs, with inventories equal to the reference's golden;
the compile counter; the PRNG-stream tracer and the chunk-invariance
check; the source lint on planted strings and on the port's tree, and
both CLIs. The mesh rows run once for the module in one world of 4 gloo
ranks (a 2 x 2 grid), at the reference's audit sizes (K=3, V=32, L=8).
"""

import ctypes
import dataclasses
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import audit, prng_check, source_lint  # noqa: E402
from repro_torch.analysis import trace_audit as ta  # noqa: E402
from repro_torch.analysis.collectives import (  # noqa: E402
    KIND_OF, CollectiveOp, Recorder, Shape, collective_bytes, summarize)
from repro_torch.core import threefry as tf3  # noqa: E402
from repro_torch.kernels import common  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESH = [n for n, ep in ta.ENTRY_POINTS.items() if ep.world > 1]
PLANTED_MESH = ["planted_doc_gather", "planted_node_reduce"]
SINGLE = [n for n, ep in ta.ENTRY_POINTS.items() if ep.world == 1]


@pytest.fixture(scope="module")
def world():
    """Every mesh row and the planted mesh rows, in one 4-rank world
    (spawned with ``ta.LAUNCH_TIMEOUT_S``: a hung rank fails the
    fixture, not the run)."""
    return ta.run_audits(MESH + PLANTED_MESH, device="cpu")


@pytest.fixture(scope="module")
def single():
    return ta.run_audits(SINGLE, device="cpu")


_DTYPES = {"f32": torch.float32, "s32": torch.int32}


def _op(kind, dims, dtype="f32", group=(0, 1), rank=0, name=None):
    t = torch.empty(tuple(dims), dtype=_DTYPES[dtype], device="meta")
    return CollectiveOp(kind, name or kind, (Shape.of(t),), group, rank=rank)


# ---------------------------------------------------------------------------
# The recorder
# ---------------------------------------------------------------------------

def test_kind_map_uses_the_reference_names():
    from repro.analysis.hlo import COLLECTIVE_OPS
    assert set(KIND_OF.values()) - {"collective-broadcast"} <= set(
        COLLECTIVE_OPS)
    assert set(Recorder.NAMES) >= {"all_reduce", "all_gather", "gather",
                                   "batch_isend_irecv",
                                   "all_gather_object"}


def test_recorder_gossip_pass_kinds_shapes_groups_bytes(world):
    ops = world["mesh_pass_1d"].ops
    assert sorted(op.rank for op in ops) == [0, 1, 2, 3]
    for op in ops:
        assert (op.kind, op.name) == ("collective-permute",
                                      "batch_isend_irecv")
        assert [(s.dtype, s.dims) for s in op.shapes] == [("f32",
                                                           (2, 3, 32))]
        assert op.group == tuple(sorted((op.rank, op.rank ^ 1)))
        assert op.nbytes == 2 * 3 * 32 * 4 and op.crosses_ranks
    assert summarize(ops) == {"collective-permute": {
        "count": 4, "bytes": 4 * 2 * 3 * 32 * 4}}
    assert collective_bytes(ops) == 4 * 2 * 3 * 32 * 4


def test_recorder_grid_estep_groups_are_vocab_lines(world):
    ops = world["grid_estep_2d"].ops
    for rank in range(4):
        mine = [op for op in ops if op.rank == rank]
        assert [op.name for op in mine] == ["all_reduce", "all_reduce"]
        line = (0, 1) if rank < 2 else (2, 3)
        assert all(op.group == line for op in mine)
        # the [n_local, K] denominators, then the [n_local, B, L, K/..]
        # column partials: floating point, never doc-shaped integers
        assert [s.dims for op in mine for s in op.shapes] == [
            (4, 3), (4, 3, 8, 3)]
        assert all(not s.is_integer for op in mine for s in op.shapes)


def test_recorder_records_and_objects_views():
    rec = Recorder()
    rec.ops.append(CollectiveOp("all-reduce", "all_reduce",
                                (Shape.of(torch.empty((2, 3))),), (0, 1),
                                phase="update"))
    rec.ops.append(CollectiveOp("all-gather", "all_gather_object", (),
                                (0, 1), objects=("int",)))
    assert rec.records == [("update", "all_reduce", "f32", True, (2, 3),
                            (0, 1))]
    assert rec.objects == ["int"]


@pytest.mark.parametrize("dtype", ["uint16", "uint32", "uint64", "int8",
                                   "bool"])
def test_recorder_judges_integer_payloads_by_the_tensor(monkeypatch, dtype):
    """A doc-shaped [B, L] all_gather of any integer dtype, named in the
    reference's table or not, is recorded as integer and fails the
    privacy rule."""
    import torch.distributed as dist
    monkeypatch.setattr(dist, "all_gather", lambda parts, t, **kw: None)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    docs = torch.zeros((4, 8), dtype=getattr(torch, dtype))
    with Recorder() as rec:
        dist.all_gather([torch.empty_like(docs)] * 2, docs)
    assert [r[3] for r in rec.records] == [False]       # not floating
    (shape,) = rec.ops[0].shapes
    assert shape.is_integer and shape.dims == (4, 8)
    rules = {v.rule for v in ta.audit_ops(rec.ops, GOSSIP_SPEC).violations}
    assert rules == {"collective-allowlist", "privacy-doc-buffer"}


def test_recorder_restores_torch_distributed():
    import torch.distributed as dist
    before = {n: getattr(dist, n) for n in Recorder.NAMES}
    with Recorder():
        assert all(getattr(dist, n) is not before[n] for n in before)
    assert all(getattr(dist, n) is before[n] for n in before)


# ---------------------------------------------------------------------------
# Specs and rules
# ---------------------------------------------------------------------------

GOSSIP_SPEC = ta.InvariantSpec(
    "gossip", allowed_collectives=ta.GOSSIP_ALLOWED, doc_len=8)


def test_planted_all_gather_of_docs_fails_across_ranks(world):
    report = world["planted_doc_gather"]
    assert not report.ok
    assert {v.rule for v in report.violations} == {"collective-allowlist",
                                                   "privacy-doc-buffer"}
    assert {op.rank for op in report.ops} == {0, 1, 2, 3}
    assert report.inventory == {"all-gather": 1}


def test_float_stats_exchange_passes(world):
    assert world["mesh_pass_1d"].ok, world["mesh_pass_1d"].summary()
    ok = _op("collective-permute", (4, 64))
    assert ta.audit_ops([ok], GOSSIP_SPEC).ok
    leaked = _op("all-gather", (64, 8), dtype="s32")
    rules = {v.rule for v in ta.audit_ops([leaked], GOSSIP_SPEC).violations}
    assert rules == {"collective-allowlist", "privacy-doc-buffer"}


def test_forbidden_exact_dims_and_count_budget():
    spec = ta.InvariantSpec(
        "x", allowed_collectives=frozenset({"all-reduce"}),
        max_counts=(("all-reduce", 1),), forbidden_dims=((2, 3),))
    two = [_op("all-reduce", (2, 3)), _op("all-reduce", (4,))]
    rules = {v.rule for v in ta.audit_ops(two, spec).violations}
    assert rules == {"privacy-doc-buffer", "collective-count"}
    # the budget holds per rank: one call on each of two ranks is fine
    spread = [_op("all-reduce", (4,), rank=0), _op("all-reduce", (4,),
                                                   rank=1)]
    assert ta.audit_ops(spread, spec).ok


def test_replica_group_placement_checked(world):
    spec = ta.InvariantSpec(
        "grid", allowed_collectives=frozenset({"all-reduce"}),
        replica_groups=((0, 1), (2, 3)),
        grouped_kinds=frozenset({"all-reduce"}))
    assert ta.audit_ops([_op("all-reduce", (4,), group=(2, 3))], spec).ok
    bad = ta.audit_ops([_op("all-reduce", (4,), group=(0, 2))], spec)
    assert [v.rule for v in bad.violations] == ["replica-groups"]
    node = world["planted_node_reduce"]
    assert {v.rule for v in node.violations} == {"replica-groups"}
    assert len(node.violations) == 4           # every rank's reduce


def test_temp_budget_violation():
    spec = ta.InvariantSpec("m", max_temp_bytes=100)
    report = ta.audit_ops([], spec, temp_bytes=101)
    assert [v.rule for v in report.violations] == ["temp-budget"]
    assert ta.audit_ops([], spec, temp_bytes=100).ok


def test_cpu_meter_reads_a_known_pair_of_temporaries():
    with ta.TempMeter("cpu") as m:
        a = torch.ones((8, 50_000))
        b = a * 2.0
        del a, b
        c = torch.zeros((4,))
    assert m.bytes == 2 * 8 * 50_000 * 4
    with ta.TempMeter("cpu") as m2:
        x = c.view(2, 2)                 # a view allocates nothing
        x.add_(1.0)                      # nor does an in-place op
    assert m2.bytes == 0


def test_planted_dense_beta_fails_the_slab_budget():
    report = ta.run_audits(["planted_dense_temp"], device="cpu")[
        "planted_dense_temp"]
    assert [v.rule for v in report.violations] == ["temp-budget"]
    assert report.temp_bytes >= 2 * ta._BIG_K * ta._BIG_V * 4


# ---------------------------------------------------------------------------
# The registry against the reference's specs and golden
# ---------------------------------------------------------------------------

def test_registry_mirrors_the_reference():
    from repro.analysis import trace_audit as ref
    assert set(ta.ENTRY_POINTS) == set(ref.ENTRY_POINTS)
    assert [f.name for f in dataclasses.fields(ta.InvariantSpec)] == [
        f.name for f in dataclasses.fields(ref.InvariantSpec)]
    for name, ep in ta.ENTRY_POINTS.items():
        mine, theirs = ep.spec, ref.ENTRY_POINTS[name].spec
        for field in ("name", "allowed_collectives", "max_counts",
                      "doc_len", "forbidden_dims", "grouped_kinds",
                      "max_temp_bytes"):
            assert getattr(mine, field) == getattr(theirs, field), (name,
                                                                    field)
        assert (mine.replica_groups is None) == (theirs.replica_groups
                                                 is None)
        assert (ep.world > 1) == (ref.ENTRY_POINTS[name].min_devices > 1)


@pytest.mark.parametrize("name", SINGLE)
def test_single_process_rows_pass(single, name):
    assert single[name].ok, single[name].summary()
    assert single[name].ops == []


@pytest.mark.parametrize("name", MESH)
def test_mesh_rows_pass(world, name):
    assert world[name].ok, world[name].summary()


def test_all_ten_rows_equal_the_reference_golden(single, world):
    reports = {**single, **{n: world[n] for n in MESH}}
    assert set(reports) == set(ta.ENTRY_POINTS)
    golden = ta.load_golden()
    assert set(golden) == set(ta.ENTRY_POINTS)
    assert ta.check_against_golden(reports, golden) == []
    assert ta.collect_inventories(reports) == golden


def test_slab_temps_sit_under_their_budgets(single):
    # eval_chunk owns one [K, V] add-temporary; the slabs none
    dense = ta._BIG_K * ta._BIG_V * 4
    assert dense <= single["eval_chunk"].temp_bytes < 2 * dense
    for name in ("serve_slab_ll", "serve_slab_mixture"):
        assert single[name].temp_bytes < dense // 4


# ---------------------------------------------------------------------------
# CompileCounter
# ---------------------------------------------------------------------------

def test_compile_counter_counts_a_new_load_and_a_new_build(monkeypatch,
                                                           tmp_path):
    monkeypatch.setattr(common, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(common, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(common, "_LIBS", {})

    class FakeNvcc:
        returncode = 0

        def __init__(self, cmd, **_kw):
            pathlib.Path(cmd[cmd.index("-o") + 1]).write_bytes(b"lib")

        def communicate(self):
            return "built", None

    monkeypatch.setattr(common.subprocess, "Popen", FakeNvcc)
    monkeypatch.setattr(common.ctypes, "CDLL", lambda path: ("lib", path))
    with ta.CompileCounter(*common.KERNEL_NAMES) as cc:
        common.load("gossip_mix")
        common.load("gossip_mix")             # cached: no second load
        common.build("gossip_mix")            # built: no second nvcc
    assert cc.counts == {n: int(n == "gossip_mix")
                         for n in common.KERNEL_NAMES}
    assert cc.builds == cc.counts and cc.total == 1
    with ta.CompileCounter("gossip_mix", "lda_l2r") as cc:
        common.load("gossip_mix")
        common.load("lda_l2r")
    assert cc.counts == {"gossip_mix": 0, "lda_l2r": 1}
    assert cc.builds == {"gossip_mix": 0, "lda_l2r": 1}
    # a path around the caches reads more than one
    with ta.CompileCounter("gossip_mix") as cc:
        common._LIBS.clear()
        common.load("gossip_mix")
        common.load("gossip_mix")
        for lib in tmp_path.glob("libgossip_mix-*.so"):
            lib.unlink()
        common.build("gossip_mix")
    assert cc.counts == {"gossip_mix": 1} and cc.builds == {"gossip_mix": 1}
    common._LIBS.clear()
    with ta.CompileCounter("gossip_mix") as cc:
        common.load("gossip_mix")
        common._LIBS.clear()
        common.load("gossip_mix")
    assert cc.counts == {"gossip_mix": 2} and cc.builds == {"gossip_mix": 0}
    assert common.ctypes is ctypes and common.subprocess is subprocess


def test_compile_counter_requires_kernels():
    with pytest.raises(ValueError):
        ta.CompileCounter()
    with pytest.raises(ValueError, match="unknown"):
        ta.CompileCounter("no_such_kernel")


# ---------------------------------------------------------------------------
# PRNG-stream check
# ---------------------------------------------------------------------------

def test_prng_check_flags_key_reuse():
    def leaky(key):
        return tf3.uniform(key, (3,)) + tf3.exponential(key, (3,))

    findings = prng_check.lint_fn(leaky, tf3.key(0))
    assert [f.kind for f in findings] == ["key-reuse"]

    def folded_twice(key):
        return tf3.fold_in_data(key, 5), tf3.fold_in_data(key, 5)

    assert [f.kind for f in prng_check.lint_fn(folded_twice, tf3.key(0))] \
        == ["key-reuse"]

    def drawn_and_folded(key):
        return tf3.uniform(key, (2,)), tf3.fold_in_data(key, 0)

    assert [f.kind for f in prng_check.lint_fn(drawn_and_folded,
                                               tf3.key(0))] == ["key-reuse"]


def test_prng_check_flags_batch_split():
    def per_doc_by_split(key, docs):
        return tf3.uniform(tf3.split(key, docs.shape[0]), (4,))

    docs = torch.zeros((16, 4), dtype=torch.int64)
    findings = prng_check.lint_fn(per_doc_by_split, tf3.key(0), docs)
    assert [f.kind for f in findings] == ["batch-split"]
    assert prng_check.check_fn(per_doc_by_split, tf3.key(0), docs,
                               allow_batch_splits=1) == []


def test_prng_check_clean_fold_in_idiom():
    def per_doc_by_fold_in(key, ids, docs):
        return tf3.uniform(tf3.fold_in_data(key, ids), (4,))

    docs = torch.zeros((16, 4), dtype=torch.int64)
    assert prng_check.lint_fn(per_doc_by_fold_in, tf3.key(0),
                              torch.arange(16), docs) == []


def test_prng_check_train_steps_has_one_init_split():
    fn, args = ta._deleda_call(1)(torch.device("cpu"))
    found = prng_check.check_fn(fn, *args)
    assert [f.kind for f in found] == ["batch-split"]
    assert prng_check.check_fn(fn, *args, allow_batch_splits=1) == []


def test_chunk_invariant_catches_a_batch_position_stream():
    def by_position(key, ids, words, mask):
        return tf3.uniform(tf3.split(key, ids.shape[0]), (2,))

    ids = torch.arange(4)
    words = torch.zeros((4, 8), dtype=torch.int64)
    found = prng_check.chunk_invariant(by_position, tf3.key(0), ids, words,
                                       words > 0)
    assert [f.kind for f in found] == ["chunk-variant"]


def test_eval_train_and_serving_streams_are_clean():
    """No reuse, no batch split, and the eval chunk and both serving
    slabs give the same bits whole and in two chunks."""
    assert audit.prng_checks("cpu") == []


# ---------------------------------------------------------------------------
# Source lint
# ---------------------------------------------------------------------------

PLANTED_LINT = {
    "timer-no-barrier": """\
        import time
        def timed(fn, x):
            t0 = time.perf_counter()
            y = fn(x)
            return y, time.perf_counter() - t0
    """,
    "optional-import": "import triton\n",
    "jit-per-call": """\
        import torch
        def bench(fn, xs):
            return [torch.compile(fn)(x) for x in xs for _ in (0,)] + [
                lambda: torch.compile(fn)]
        def build_each(common, names):
            for name in names:
                common.build(name)
    """,
    "use-pallas-alias": "cfg = make(use_pallas=True)\n",
}


@pytest.mark.parametrize("rule", source_lint.RULES)
def test_planted_string_is_flagged(rule):
    findings = source_lint.lint_text(textwrap.dedent(PLANTED_LINT[rule]))
    assert findings and {f.rule for f in findings} == {rule}


def test_synchronize_closes_a_timer_interval():
    clean = textwrap.dedent("""\
        import time, torch
        def timed(fn, x, event):
            t0 = time.perf_counter()
            y = fn(x)
            torch.cuda.synchronize()
            a = time.perf_counter() - t0
            t1 = time.perf_counter()
            z = fn(y)
            event.synchronize()
            return z, a, time.perf_counter() - t1
    """)
    assert source_lint.lint_text(clean) == []


def test_unbarriered_interval_flagged_and_pragma_suppresses():
    dirty = textwrap.dedent(PLANTED_LINT["timer-no-barrier"])
    assert [f.rule for f in source_lint.lint_text(dirty)] == [
        "timer-no-barrier"]
    suppressed = dirty.replace(
        "return y, time.perf_counter() - t0",
        "return y, time.perf_counter() - t0  # lint: allow(timer-no-barrier)")
    assert source_lint.lint_text(suppressed) == []


def test_guarded_lazy_and_port_only_imports():
    ok = textwrap.dedent("""\
        try:
            import triton
        except ImportError:
            triton = None
        def lazy():
            import scipy
            return scipy
    """)
    assert source_lint.lint_text(ok) == []
    ref = "import jax\nfrom repro.core import lda\n"
    assert source_lint.lint_text(ref, "tests/test_torch_x.py") == []
    found = source_lint.lint_text(ref, "src/repro_torch/core/x.py")
    assert [(f.line, f.rule) for f in found] == [(1, "optional-import"),
                                                 (2, "optional-import")]
    assert len(source_lint.lint_text(ref, "chip_smoke.py")) == 2
    lazy = "def f():\n    import jax\n    return jax\n"
    assert source_lint.lint_text(lazy, "src/repro_torch/core/x.py") == []


def test_hoisted_compile_and_other_compiles_not_flagged():
    ok = textwrap.dedent("""\
        import re, torch
        def bench(fn, xs, pats):
            compiled = torch.compile(fn)
            found = [re.compile(p) for p in pats]
            for x in xs:
                compiled(x)
            return found
    """)
    assert source_lint.lint_text(ok) == []


def test_port_tree_is_lint_clean(monkeypatch):
    monkeypatch.chdir(ROOT)
    files = list(source_lint.iter_python_files())
    assert ROOT / "chip_smoke.py" not in files   # relative paths
    assert pathlib.Path("chip_smoke.py") in files
    assert pathlib.Path("tests/test_torch_analysis.py") in files
    findings = source_lint.lint_paths()
    assert findings == [], "\n".join(str(f) for f in findings)


def _cli(*args, cwd=ROOT):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return subprocess.run([sys.executable, "-m", *args], env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_lint_cli_exit_codes(tmp_path, capsys):
    from repro_torch.analysis import lint
    clean = _cli("repro_torch.analysis.lint")
    assert clean.returncode == 0, clean.stdout + clean.stderr
    planted = []
    for rule, text in PLANTED_LINT.items():
        f = tmp_path / f"{rule.replace('-', '_')}.py"
        f.write_text(textwrap.dedent(text))
        planted.append(str(f))
        assert lint.main([str(f)]) == 1, rule
        assert rule in capsys.readouterr().out
    dirty = _cli("repro_torch.analysis.lint", *planted)
    assert dirty.returncode == 1, dirty.stdout + dirty.stderr
    assert all(rule in dirty.stdout for rule in source_lint.RULES)
    assert lint.main(["--list-rules"]) == 0
    assert capsys.readouterr().out.split() == list(source_lint.RULES)
    with pytest.raises(SystemExit) as bad:
        lint.main(["--rules", "nope", planted[0]])
    assert bad.value.code == 2


# ---------------------------------------------------------------------------
# The audit CLI
# ---------------------------------------------------------------------------

def test_audit_cli_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        audit.main([])


def test_audit_cli_fails_on_a_planted_row_naming_the_rule(capsys):
    assert audit.main(["--device", "cpu", "--only", "serve_slab_ll",
                       "--plant", "planted_dense_temp"]) == 1
    out = capsys.readouterr().out
    assert "serve_slab_ll: collectives {none}" in out and "OK" in out
    assert "FAIL [planted_dense_temp] temp-budget" in out


@pytest.mark.slow
def test_full_audit_cli_passes_on_the_cpu():
    """Every row (the mesh rows in 4 spawned gloo ranks), the golden and
    the PRNG checks in one subprocess; then the planted leak fails."""
    ok = _cli("repro_torch.analysis.audit", "--device", "cpu")
    assert ok.returncode == 0, ok.stdout + ok.stderr
    assert ok.stdout.count("— OK") == len(ta.ENTRY_POINTS)
    leak = _cli("repro_torch.analysis.audit", "--device", "cpu", "--only",
                "mesh_pass_1d", "--plant", "planted_doc_gather")
    assert leak.returncode == 1
    assert "privacy-doc-buffer" in leak.stdout
