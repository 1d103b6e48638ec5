"""Port-rule lint CLI: ``python -m repro_torch.analysis.lint [paths...]``.

The torch counterpart of ``repro.analysis.lint``: runs the
:mod:`repro_torch.analysis.source_lint` AST rules over the port's tree
(default: ``src/repro_torch``, ``tests/test_torch_*.py``,
``tests/torch_*.py`` and ``chip_smoke.py``, from the repository root,
skipping ``fixtures`` directories) and exits 1 on any finding, 0 on none
(2 on a usage error). Imports no jax.

    python -m repro_torch.analysis.lint                 # the port's tree
    python -m repro_torch.analysis.lint chip_smoke.py   # one file
    python -m repro_torch.analysis.lint --rules timer-no-barrier src
    python -m repro_torch.analysis.lint --list-rules
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.analysis import source_lint


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="AST lint for the port's fixed bug classes")
    ap.add_argument("paths", nargs="*",
                    help=f"files, trees or globs to lint (default: "
                         f"{' '.join(source_lint.DEFAULT_PATHS)})")
    ap.add_argument("--rules", default=None,
                    help="comma-separated subset of rules to run")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for r in source_lint.RULES:
            print(r)
        return 0

    rules = source_lint.RULES
    if args.rules:
        rules = tuple(r.strip() for r in args.rules.split(",") if r.strip())
        unknown = sorted(set(rules) - set(source_lint.RULES))
        if unknown:
            ap.error(f"unknown rules {unknown}; "
                     f"known: {list(source_lint.RULES)}")

    paths = tuple(args.paths) or source_lint.DEFAULT_PATHS
    findings = source_lint.lint_paths(paths, rules=rules)
    for f in findings:
        print(f)
    n_files = sum(1 for _ in source_lint.iter_python_files(paths))
    print(f"{len(findings)} finding(s) in {n_files} file(s) "
          f"[rules: {', '.join(rules)}]", file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
