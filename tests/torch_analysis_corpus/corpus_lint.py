"""Seeded lint-pass defects — source files under ``lint_defects/`` with
the banned patterns; the port's AST lint must flag each.
"""
from pathlib import Path

from repro_torch.analysis import lint_source

_DEFECTS = Path(__file__).parent / "lint_defects"


def _deprecated_calls(report, target):
    path = _DEFECTS / "uses_deprecated.py"
    lint_source(path.read_text(), path=str(path), report=report)


def _missing_empty_guard(report, target):
    path = _DEFECTS / "missing_guard.py"
    lint_source(path.read_text(), path=str(path), report=report)


def _trivial_module_docstring(report, target):
    # linted under a virtual serve path: the docstring rule keys on the
    # module's location, and this defect models a serve module shipped
    # with a one-word docstring instead of its contract
    path = _DEFECTS / "bare_serve_module.py"
    lint_source(path.read_text(),
                path="src/repro_torch/serve/bare_serve_module.py",
                report=report)


CASES = [
    dict(name="deprecated_shim_calls", pass_name="lint",
         code="L_DEPRECATED", audit=_deprecated_calls),
    dict(name="launch_wrapper_missing_empty_guard", pass_name="lint",
         code="L_EMPTY_GUARD", audit=_missing_empty_guard),
    dict(name="serve_module_trivial_docstring", pass_name="lint",
         code="L_MODULE_DOCSTRING", audit=_trivial_module_docstring),
]
