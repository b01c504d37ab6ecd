"""CLI: ``python -m repro_torch.analysis [--json PATH] [--corpus DIR]
[--root DIR] [--device cuda|cpu]``.

Runs ``matrix.run_all`` on the device (the card unless ``--device cpu``;
``cuda`` without a card raises, there is no fallback to the CPU), then
the seeded-defect corpus (default ``tests/torch_analysis_corpus`` under
the repo root when present; ``--corpus ''`` skips it).  Exit status 0
only when the audit has no error finding and every corpus defect the
device can run was flagged.  The JSON report holds both, and the checks
not run on this device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .corpus import corpus_summary, corpus_to_dict, run_corpus
from .matrix import run_all


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="The port's plan, launch and kernel auditor.")
    parser.add_argument("--json", metavar="PATH", default=None,
                        help="write the full JSON report here")
    parser.add_argument("--corpus", metavar="DIR", default=None,
                        help="seeded-defect corpus directory (default: "
                             "tests/torch_analysis_corpus when present; "
                             "pass '' to skip)")
    parser.add_argument("--root", metavar="DIR", default=None,
                        help="repo root for the lint (default: derived "
                             "from the package location)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the audit runs (default: the card)")
    args = parser.parse_args(argv)

    root = Path(args.root) if args.root else \
        Path(__file__).resolve().parents[3]

    report = run_all(root=root, device=args.device)
    print(report.summary())
    for target, counts in sorted(report.plan_counts.items()):
        print(f"  syncs {target}: {counts['syncs']}"
              + (f" (sync debug mode {counts['sync_debug']})"
                 if counts.get("sync_debug") is not None else ""))

    corpus_dir = args.corpus
    if corpus_dir is None:
        default = root / "tests" / "torch_analysis_corpus"
        corpus_dir = str(default) if default.is_dir() else ""
    results = []
    if corpus_dir:
        results = run_corpus(corpus_dir, device=args.device)
        print(corpus_summary(results))

    if args.json:
        payload = report.to_dict()
        payload["corpus"] = corpus_to_dict(results)
        Path(args.json).write_text(
            json.dumps(payload, indent=2, sort_keys=True) + "\n")
        print(f"report written to {args.json}")

    failed = (not report.ok()) or any(not r.ok for r in results) \
        or (bool(corpus_dir) and not results)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
