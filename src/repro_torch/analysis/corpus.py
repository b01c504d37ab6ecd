"""Seeded-defect corpus runner — proves the port's auditor detects.

The port's counterpart of the JAX package's ``analysis/corpus.py``.  A
corpus module (``tests/torch_analysis_corpus/corpus_*.py``) defines

    CASES = [
        {"name": "...",            # unique within the module
         "pass_name": "kernel",    # which pass must fire
         "code": "K_INT32_ARG",    # the finding code it must raise
         "audit": fn,              # fn(report, target) runs the audit
         "device": "cuda"},        # optional: the case needs the card
        ...
    ]

Each case runs against a fresh ``Report``; it *passes* when its code
appears among the findings of its pass.  A seeded defect the auditor
misses is a fault of the auditor: the runner reports it and the CLI
exits non-zero.  A case that needs the card is not run on the CPU and is
listed as such, never counted as detected.  Corpus findings never enter
the repo report: they are expected.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import sys
from pathlib import Path

from .report import Report


@dataclasses.dataclass
class CaseResult:
    module: str
    name: str
    pass_name: str
    code: str
    detected: bool
    got_codes: tuple[str, ...]
    error: str | None = None
    ran: bool = True

    @property
    def ok(self) -> bool:
        return not self.ran or (self.detected and self.error is None)


def load_corpus_modules(corpus_dir: str | Path):
    corpus_dir = Path(corpus_dir)
    mods = []
    for path in sorted(corpus_dir.glob("corpus_*.py")):
        modname = f"_repro_torch_analysis_corpus_{path.stem}"
        spec = importlib.util.spec_from_file_location(modname, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[modname] = mod
        spec.loader.exec_module(mod)
        mods.append((path.stem, mod))
    return mods


def run_corpus(corpus_dir: str | Path, *,
               device: str = "cpu") -> list[CaseResult]:
    """Run every seeded defect that ``device`` can run; each must be
    flagged with its code."""
    results: list[CaseResult] = []
    for stem, mod in load_corpus_modules(corpus_dir):
        for case in getattr(mod, "CASES", []):
            name = case["name"]
            if case.get("device", "cpu") == "cuda" and device != "cuda":
                results.append(CaseResult(
                    module=stem, name=name, pass_name=case["pass_name"],
                    code=case["code"], detected=False, got_codes=(),
                    ran=False))
                continue
            target = f"corpus:{stem}:{name}"
            sub = Report(device)
            error = None
            try:
                case["audit"](sub, target)
            except Exception as e:  # noqa: BLE001 — auditor crash = fail
                error = f"{type(e).__name__}: {e}"
            got = tuple(sorted(
                f.code for f in sub.findings_for(case["pass_name"])))
            results.append(CaseResult(
                module=stem, name=name, pass_name=case["pass_name"],
                code=case["code"], detected=case["code"] in got,
                got_codes=got, error=error))
    return results


def corpus_summary(results: list[CaseResult]) -> str:
    lines = [f"corpus: {len(results)} seeded defect(s)"]
    for r in results:
        status = ("NOT RUN" if not r.ran
                  else "DETECTED" if r.ok else "MISSED")
        extra = f" [{r.error}]" if r.error else ""
        got = ",".join(r.got_codes) or "-"
        lines.append(f"  {status:8s} {r.module}:{r.name} "
                     f"expect {r.code} got {got}{extra}")
    missed = [r for r in results if not r.ok]
    lines.append("corpus RESULT: "
                 + ("OK" if results and not missed
                    else f"{len(missed)} MISSED" if results
                    else "EMPTY"))
    return "\n".join(lines)


def corpus_to_dict(results: list[CaseResult]) -> dict:
    return {
        "n_cases": len(results),
        "n_missed": sum(not r.ok for r in results),
        "n_not_run": sum(not r.ran for r in results),
        "cases": [dataclasses.asdict(r) for r in results],
    }
