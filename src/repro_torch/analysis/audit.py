"""Invariant-audit CLI: ``python -m repro_torch.analysis.audit``.

The torch counterpart of ``repro.analysis.audit``. Runs every registry
entry point (``trace_audit.ENTRY_POINTS``) under the collective recorder
and the temp meter, audits each against its
:class:`~repro_torch.analysis.trace_audit.InvariantSpec`, holds the
collective inventories against the reference's golden
(``tests/golden_collectives.json``, read; never written), and runs the
PRNG-stream checks (:func:`prng_checks`). Exits 1 on any violation,
golden mismatch or PRNG finding.

The mesh rows run in one world of 4 gloo ranks that the CLI spawns
itself, their tensors on the card or on the CPU as ``--device`` says.
The default device is the card; without one the CLI raises unless
``--device cpu`` is given (there is no quiet CPU fallback).

    PYTHONPATH=src python -m repro_torch.analysis.audit
    PYTHONPATH=src python -m repro_torch.analysis.audit --device cpu
    PYTHONPATH=src python -m repro_torch.analysis.audit --device cpu \\
        --only mesh_pass_2d
    # the auditor's own negative checks: each must make it exit 1
    PYTHONPATH=src python -m repro_torch.analysis.audit --device cpu \\
        --only serve_slab_ll --plant planted_dense_temp
"""

from __future__ import annotations

import argparse
import sys


def prng_checks(device="cuda") -> list[str]:
    """The PRNG-stream checks over the registry's own calls
    (``trace_audit``'s ``_eval_call``, ``_serve_call``, ``_deleda_call``),
    the slabs at the reference prng lint's sizes (``PRNG_SLAB``: K=3,
    V=32, L=8): no key reuse and no batch split in the eval chunk and
    both serving slabs, and the three slabs chunk-invariant bit for bit;
    the DELEDA segment with its one per-node init split. Returns the
    problems."""
    from repro_torch import resolve_device
    from repro_torch.analysis import prng_check
    from repro_torch.analysis import trace_audit as ta

    dev = resolve_device(device)
    problems = []
    for name, call, batched in (
            ("eval_chunk", ta._eval_call, (1, 2, 3)),
            ("serve_slab_ll", ta._serve_call("ll"), (0, 1, 2)),
            ("serve_slab_mixture", ta._serve_call("mixture"), (0, 1, 2))):
        fn, args = call(dev, ta.PRNG_SLAB)
        for f in prng_check.check_fn(fn, *args, allow_batch_splits=0):
            problems.append(f"prng[{name}]: {f}")
        for f in prng_check.chunk_invariant(fn, *args, batched=batched):
            problems.append(f"prng[{name}]: {f}")
    fn, args = ta._deleda_call(1)(dev)
    for f in prng_check.check_fn(fn, *args, allow_batch_splits=1):
        problems.append(f"prng[deleda_scan]: {f}")
    return problems


def main(argv=None) -> int:
    from repro_torch.analysis import trace_audit as ta

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.audit",
        description="run and audit the port's core entry points")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the rows run (mesh rows: gloo ranks with "
                         "their tensors there)")
    ap.add_argument("--only", nargs="*", default=None,
                    help="audit only these entry points")
    ap.add_argument("--plant", nargs="*", default=(),
                    choices=sorted(ta.PLANTED),
                    help="add planted rows that must fail (the auditor's "
                         "negative checks)")
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    dev = resolve_device(args.device)
    names = list(ta.ENTRY_POINTS) if args.only is None else list(args.only)
    unknown = sorted(set(names) - set(ta.ENTRY_POINTS))
    if unknown:
        ap.error(f"unknown entry points {unknown}")
    reports = ta.run_audits(names + list(args.plant), device=dev)
    failed = False
    for report in reports.values():
        print(report.summary())
        failed |= not report.ok
    golden = ta.load_golden()
    for problem in ta.check_against_golden(
            {n: r for n, r in reports.items() if n in ta.ENTRY_POINTS},
            golden):
        print(f"GOLDEN MISMATCH {problem}")
        failed = True
    for problem in prng_checks(dev):
        print(f"FAIL {problem}")
        failed = True
    print("audit:", "FAIL" if failed else "OK", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
