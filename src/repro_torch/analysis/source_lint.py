"""AST lint rules for the port's recurring bug classes.

The torch counterpart of ``repro.analysis.source_lint``: its four rules
under the same names, pragma syntax, :class:`Finding` type and
``lint_text`` / ``lint_file`` / ``lint_paths`` API, read for the port:

- ``timer-no-barrier``: a wall-clock interval ``<timer>() - t0`` closed
  without a barrier between start and stop. The barrier is any
  ``.synchronize()`` call (``torch.cuda.synchronize``, an event's or a
  stream's) or ``block_until_ready``: kernels launch asynchronously, so
  an unbarriered timer reads queueing time, not compute time.
- ``optional-import``: a module-level unconditional import of an optional
  dependency (``ml_dtypes``, ``scipy``, ``hypothesis``, ``triton``: the
  port imports ``triton`` only inside the function that launches a
  kernel); and, in ``src/repro_torch/`` and ``chip_smoke.py``, any
  module-level ``jax`` or ``repro`` import, since the card's machine has
  no jax.
- ``jit-per-call``: ``torch.compile`` or ``kernels.common.build`` /
  ``build_all`` inside a loop body or a ``lambda`` body: a fresh compile
  or build per iteration. Hoist it, or build once up front.
- ``use-pallas-alias``: the name ``use_pallas`` anywhere in the port, a
  knob the port never had (its kernels dispatch on the tensor's device).

False-positive escape hatch: a ``# lint: allow(rule-name)`` comment on
the flagged line or the line directly above suppresses that rule there
(the standing idiom for host-side intervals that time orchestration).
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
import re

TIMER_NAMES = frozenset({"time", "perf_counter", "monotonic"})
OPTIONAL_DEPS = frozenset({"ml_dtypes", "scipy", "hypothesis", "triton"})
REFERENCE_ONLY = frozenset({"jax", "jaxlib", "repro"})
BARRIER_NAMES = frozenset({"synchronize", "block_until_ready"})
# dotted call targets (matched by suffix) that compile or build
BUILD_CALLS = ("torch.compile", "common.build", "common.build_all")

RULES = ("timer-no-barrier", "optional-import", "jit-per-call",
         "use-pallas-alias")

_PRAGMA_RE = re.compile(r"#\s*lint:\s*allow\(([^)]*)\)")


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self):
        return f"{self.path}:{self.line}: {self.rule}: {self.message}"


def _call_name(node: ast.AST) -> str | None:
    """Trailing name of a call target: ``torch.cuda.synchronize`` ->
    ``synchronize``."""
    if isinstance(node, ast.Call):
        node = node.func
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _dotted(node: ast.AST) -> str:
    """``a.b.c`` of a call target (``""`` past a call or subscript)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _is_timer_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call) and not node.args
            and not node.keywords and _call_name(node) in TIMER_NAMES)


class _ScopeVisitor(ast.NodeVisitor):
    """Assigns every node its nearest enclosing function (or module)."""

    def __init__(self, path: str):
        self.path = path
        self.scope_of: dict[ast.AST, ast.AST] = {}
        self.parents: dict[ast.AST, ast.AST] = {}
        self._stack: list[ast.AST] = []

    def generic_visit(self, node):
        if self._stack:
            self.scope_of[node] = self._stack[-1]
        for child in ast.iter_child_nodes(node):
            self.parents[child] = node
        is_scope = isinstance(node, (ast.Module, ast.FunctionDef,
                                     ast.AsyncFunctionDef))
        if is_scope:
            self._stack.append(node)
        super().generic_visit(node)
        if is_scope:
            self._stack.pop()


def _timer_findings(tree, scopes: _ScopeVisitor) -> list[tuple[int, str]]:
    by_scope: dict[ast.AST, dict[str, list]] = {}

    def bucket(node):
        scope = scopes.scope_of.get(node, tree)
        return by_scope.setdefault(scope, {"starts": [], "stops": [],
                                           "barriers": []})

    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and _is_timer_call(node.value)):
            bucket(node)["starts"].append((node.lineno,
                                           node.targets[0].id))
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub):
            pairs = ((node.left, node.right), (node.right, node.left))
            for timer, other in pairs:
                if _is_timer_call(timer) and isinstance(other, ast.Name):
                    bucket(node)["stops"].append((node.lineno, other.id))
                    break
        elif (isinstance(node, ast.Call)
              and _call_name(node) in BARRIER_NAMES):
            bucket(node)["barriers"].append(node.lineno)

    out = []
    for info in by_scope.values():
        for stop_line, var in info["stops"]:
            starts = [ln for ln, v in info["starts"]
                      if v == var and ln <= stop_line]
            if not starts:
                continue        # interval start not visible: can't judge
            start_line = max(starts)
            if not any(start_line < b <= stop_line
                       for b in info["barriers"]):
                out.append((stop_line,
                            f"interval {var} -> stop at line {stop_line} "
                            f"has no synchronize barrier after the start "
                            f"at line {start_line}; asynchronous launches "
                            f"make this time queueing, not compute"))
    return out


def _in_port(path: str) -> bool:
    p = pathlib.PurePath(path)
    return "repro_torch" in p.parts or p.name == "chip_smoke.py"


def _import_findings(tree, scopes: _ScopeVisitor) -> list[tuple[int, str]]:
    banned = OPTIONAL_DEPS | (REFERENCE_ONLY if _in_port(scopes.path)
                              else frozenset())
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.Import, ast.ImportFrom)):
            continue
        if isinstance(node, ast.Import):
            mods = [a.name.split(".")[0] for a in node.names]
        else:
            mods = [(node.module or "").split(".")[0]]
        hits = sorted(set(mods) & banned)
        if not hits:
            continue
        # function-scope (lazy) or try-guarded imports are the idiom
        if not isinstance(scopes.scope_of.get(node, tree), ast.Module):
            continue
        guarded, cur = False, node
        while cur in scopes.parents:
            cur = scopes.parents[cur]
            if isinstance(cur, ast.Try):
                guarded = True
                break
        if guarded and not set(hits) & REFERENCE_ONLY:
            continue
        if set(hits) & REFERENCE_ONLY:
            out.append((node.lineno,
                        f"module-level import of {', '.join(hits)} in the "
                        f"port: the card's machine has no jax, and the "
                        f"port keeps its own copy of what it needs"))
            continue
        out.append((node.lineno,
                    f"unconditional module-level import of optional "
                    f"dependency {', '.join(hits)}; guard with try/except "
                    f"or import lazily in the consuming function"))
    return out


def _is_build_call(node: ast.Call) -> bool:
    dotted = _dotted(node.func)
    return any(dotted == c or dotted.endswith("." + c) for c in BUILD_CALLS)


def _jit_findings(tree, scopes: _ScopeVisitor) -> list[tuple[int, str]]:
    out = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and _is_build_call(node)):
            continue
        what = _dotted(node.func)
        cur = node
        while cur in scopes.parents:
            cur = scopes.parents[cur]
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Module)):
                break
            if isinstance(cur, ast.Lambda):
                out.append((node.lineno,
                            f"{what} inside a lambda body: a fresh compile "
                            f"or build per call"))
                break
            if isinstance(cur, (ast.For, ast.While)):
                out.append((node.lineno,
                            f"{what} inside a loop body: compiles or "
                            f"builds every iteration; hoist it out of the "
                            f"loop"))
                break
    return out


def _use_pallas_findings(tree, _scopes) -> list[tuple[int, str]]:
    out = []
    msg = ("use_pallas: a knob the port never had; its kernels dispatch "
           "on the tensor's device")
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            out.extend((node.lineno, msg) for kw in node.keywords
                       if kw.arg == "use_pallas")
        elif isinstance(node, ast.Attribute) and node.attr == "use_pallas":
            out.append((node.lineno, msg))
        elif isinstance(node, ast.Name) and node.id == "use_pallas":
            out.append((node.lineno, msg))
        elif isinstance(node, ast.arg) and node.arg == "use_pallas":
            out.append((node.lineno, msg))
    return out


_RULE_FNS = {
    "timer-no-barrier": _timer_findings,
    "optional-import": _import_findings,
    "jit-per-call": _jit_findings,
    "use-pallas-alias": _use_pallas_findings,
}
assert set(_RULE_FNS) == set(RULES)


def _pragmas(text: str) -> dict[int, set[str]]:
    out: dict[int, set[str]] = {}
    for i, line in enumerate(text.splitlines(), start=1):
        m = _PRAGMA_RE.search(line)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


def lint_text(text: str, path: str = "<string>",
              rules=RULES) -> list[Finding]:
    """Lint one file's source text; pragma-suppressed findings removed.
    ``path`` decides whether the port-only import rule applies."""
    try:
        tree = ast.parse(text)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 0, "syntax-error", str(e))]
    scopes = _ScopeVisitor(path)
    scopes.visit(tree)
    pragmas = _pragmas(text)
    findings = []
    for rule in rules:
        for line, message in _RULE_FNS[rule](tree, scopes):
            allowed = pragmas.get(line, set()) | pragmas.get(line - 1, set())
            if rule in allowed:
                continue
            findings.append(Finding(path, line, rule, message))
    return sorted(findings, key=lambda f: (f.line, f.rule))


def lint_file(path, rules=RULES) -> list[Finding]:
    p = pathlib.Path(path)
    return lint_text(p.read_text(), str(p), rules)


DEFAULT_PATHS = ("src/repro_torch", "tests/test_torch_*.py",
                 "tests/torch_*.py", "chip_smoke.py")
DEFAULT_EXCLUDE = ("fixtures",)


def iter_python_files(paths=DEFAULT_PATHS, exclude=DEFAULT_EXCLUDE):
    """The ``.py`` files of each path: a file, a tree, or a glob."""
    for root in paths:
        p = pathlib.Path(root)
        if p.is_file() and p.suffix == ".py":
            yield p            # an explicitly named file is never excluded
            continue
        if p.is_dir():
            found = sorted(p.rglob("*.py"))
        else:
            found = sorted(f for f in pathlib.Path(p.parent).glob(p.name)
                           if f.suffix == ".py")
        for f in found:
            if any(part in exclude for part in f.parts):
                continue
            yield f


def lint_paths(paths=DEFAULT_PATHS, exclude=DEFAULT_EXCLUDE,
               rules=RULES) -> list[Finding]:
    findings = []
    for f in iter_python_files(paths, exclude):
        findings.extend(lint_file(f, rules))
    return findings
