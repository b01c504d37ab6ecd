"""Shared pieces of the benchmark's tests: a checkout root whose cells
are the benchmark's own at a size the CPU runs in a second."""
import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# the benchmark's configurations, cut to a size the CPU runs at once
TINY = {"sbm-uniform-n1e7": {"n_total": 4000},
        "itm-uniform-n1e8": {"n_total": 3000}}


def tiny_root(tmp: Path) -> Path:
    """A checkout root with the benchmark's ``BENCHMARK.json``, its
    traffic mixes, and its configurations cut to ``TINY``."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (tmp / "ddmbench" / "traffic").mkdir(parents=True)
    for f in (REPO / "ddmbench" / "traffic").glob("*.json"):
        shutil.copy(f, tmp / "ddmbench" / "traffic" / f.name)
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        cfg["params"].update(TINY[c["name"]])
        dst = tmp / c["file"]
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text(json.dumps(cfg))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
