"""Lint pass — the AST rules of the JAX package's ``analysis/lint.py``
applied to the port (``src/repro_torch`` and ``chip_smoke.py``).

``L_DEPRECATED``
    The pre-engine entry points (``match_count`` / ``match_pairs`` /
    ``distributed_sbm_count``) finished their deprecation cycle in the
    reference and were never ported: every caller builds a plan.  The
    port may neither call nor define these names.

``L_EMPTY_GUARD``
    A function that takes ``max_pairs`` (or ``nslots``) and launches a
    kernel through ``_build.launch`` must compare that argument with 0
    (``max_pairs == 0``, either operand order) somewhere in its body:
    an empty buffer is ``(0, 2)`` and launches nothing, and a kernel
    handed 0 slots is a launch of an empty grid.  ``itm_walk``'s ``cap``
    is not such an argument: 0 there selects the count instance.

``L_MODULE_DOCSTRING``
    Modules under ``repro_torch/serve`` and ``repro_torch/analysis``
    open with a docstring of at least 120 characters stating their
    contract and invariants, as the reference demands of its own
    ``serve`` and ``analysis``.

``lint_source`` lints one module's text (the repo scan and the corpus
share it); ``lint_paths`` walks the roots, files or directories, and
logs the number of files it scanned.
"""
from __future__ import annotations

import ast
from pathlib import Path

from .report import Report

BANNED_CALLS = ("match_count", "match_pairs", "distributed_sbm_count")

DEFAULT_ROOTS = ("src/repro_torch", "chip_smoke.py")

# path fragments whose modules must carry substantive docstrings
DOCSTRING_ROOTS = ("repro_torch/serve", "repro_torch/analysis")
MIN_MODULE_DOCSTRING = 120

# arguments a launching function must short-circuit on when 0
GUARDED_ARGS = ("max_pairs", "nslots")


def _call_name(node: ast.Call) -> str | None:
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _guarded_args(fn: ast.FunctionDef) -> list[str]:
    a = fn.args
    names = [p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)]
    return [n for n in GUARDED_ARGS if n in names]


def _uses_launch(fn: ast.FunctionDef) -> bool:
    """A call of ``_build.launch`` anywhere in the function."""
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "launch"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "_build"):
            return True
    return False


def _has_empty_guard(fn: ast.FunctionDef, arg: str) -> bool:
    """A literal ``arg == 0`` compare anywhere in the body."""
    for node in ast.walk(fn):
        if not isinstance(node, ast.Compare) or len(node.ops) != 1:
            continue
        if not isinstance(node.ops[0], ast.Eq):
            continue
        sides = (node.left, node.comparators[0])
        has_name = any(isinstance(s, ast.Name) and s.id == arg
                       for s in sides)
        has_zero = any(isinstance(s, ast.Constant) and s.value == 0
                       for s in sides)
        if has_name and has_zero:
            return True
    return False


def lint_source(src: str, *, path: str, report: Report) -> None:
    """Lint one module's source text (shared by repo scan and corpus)."""
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        report.add("lint", "L_DEPRECATED", f"{path}:{e.lineno or 0}",
                   f"unparseable module: {e.msg}")
        return

    norm = "/" + str(path).replace("\\", "/")
    if any(f"/{root}/" in norm for root in DOCSTRING_ROOTS):
        doc = ast.get_docstring(tree) or ""
        if len(doc.strip()) < MIN_MODULE_DOCSTRING:
            report.add(
                "lint", "L_MODULE_DOCSTRING", f"{path}:1",
                f"module under {DOCSTRING_ROOTS} has "
                f"{'no' if not doc else 'only a trivial'} module "
                f"docstring ({len(doc.strip())} chars < "
                f"{MIN_MODULE_DOCSTRING}) — serve/analysis modules "
                "must state their contract and invariants up front")

    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            name = _call_name(node)
            if name in BANNED_CALLS:
                report.add(
                    "lint", "L_DEPRECATED", f"{path}:{node.lineno}",
                    f"call of removed shim '{name}' — build a "
                    "MatchPlan instead: "
                    "build_plan(MatchSpec(...), n_sub, n_upd, d)")
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node.name in BANNED_CALLS:
                report.add(
                    "lint", "L_DEPRECATED", f"{path}:{node.lineno}",
                    f"re-definition of removed shim '{node.name}' — the "
                    "pre-engine entry points completed their "
                    "deprecation cycle and must not be reintroduced")

    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not _uses_launch(node):
            continue
        for arg in _guarded_args(node):
            if not _has_empty_guard(node, arg):
                report.add(
                    "lint", "L_EMPTY_GUARD", f"{path}:{node.lineno}",
                    f"'{node.name}' takes {arg} and launches a kernel "
                    f"through _build.launch but never short-circuits on "
                    f"{arg} == 0 — an empty buffer is (0, 2) and "
                    "launches nothing")


def _py_files(base: Path):
    if base.is_file():
        return [base] if base.suffix == ".py" else []
    return sorted(base.rglob("*.py")) if base.is_dir() else []


def lint_paths(repo_root: str | Path, roots=DEFAULT_ROOTS, *,
               report: Report) -> int:
    """Lint every ``.py`` under ``roots`` (files or directories under
    ``repo_root``); returns the number of files scanned."""
    repo_root = Path(repo_root)
    scanned = 0
    for root in roots:
        for path in _py_files(repo_root / root):
            rel = path.relative_to(repo_root)
            lint_source(path.read_text(), path=str(rel), report=report)
            scanned += 1
    report.note_audit("lint", f"{scanned} file(s) under {roots}")
    return scanned
