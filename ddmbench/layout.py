"""Where a cell's parts live, found by the names in ``BENCHMARK.json``.

``BENCHMARK.json``, at the root of the checkout, lists the cells; a cell
names a configuration and a traffic mix, and the metrics name the cells
they are read in.  Every other part is a file of its own:

    <configs[].file>                   a configuration (sizes, generator,
                                       MatchSpec fields, reduced, assumed)
    ddmbench/traffic/<traffic>.json    a traffic mix (operation, move model,
                                       warm-up, check sample, trace length)
    ddmbench/metrics/<metric>.py       one reader a metric
    ddmbench/generators/<name>.py      a region generator
    ddmbench/moves/<name>.py           a move model
    ddmbench/operations/<name>.py      what a tick asks of the plan, and
                                       how its answer is judged

So a configuration, a traffic mix, a cell or a metric is added by adding
files and entries; no file that is there needs an edit.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    """One entry of ``workloads``, with the files it names loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple   # the metric entries a ``--trace 0`` run reports
    per_layer: tuple    # the metric entries a ``--trace 1`` run reports


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _read_json(path: Path, what: str) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{what}: no file {path}")
    return json.loads(path.read_text())


def _metrics_of(bench: dict, cell: str) -> tuple[tuple, tuple]:
    """The end-to-end and per-layer metric entries that ``cell`` reports.

    A metric with a ``workloads`` key is read in the cells it lists; one
    without is read in every cell, or, for a per-layer metric, in every
    cell that reports the end-to-end metric it moves.
    """
    e2e = tuple(m for m in bench["end_to_end"]
                if cell in m.get("workloads", (cell,)))
    names = {m["name"] for m in e2e}
    layer = tuple(m for m in bench["per_layer"]
                  if (cell in m["workloads"] if "workloads" in m
                      else m["moves"] in names))
    return e2e, layer


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``, its files read."""
    root = Path(root)
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}; "
                       f"it has {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(root / configs[w["config"]]["file"],
                        f"configuration {w['config']!r}")
    traffic = _read_json(root / "ddmbench" / "traffic" / f"{w['traffic']}.json",
                         f"traffic {w['traffic']!r}")
    e2e, layer = _metrics_of(bench, name)
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=layer)


def load_plugin(kind: str, name: str):
    """The module ``ddmbench/<kind>/<name>.py``, loaded once a process."""
    path = PACKAGE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    key = "_ddmbench_" + re.sub(r"\W", "_", f"{kind}_{name}")
    mod = sys.modules.get(key)
    if mod is None:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return mod
