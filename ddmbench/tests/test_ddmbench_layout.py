"""The benchmark's layout: every cell resolves to its files, a cell added
as new files only is found, ``BENCHMARK.json`` keeps to the contract's
shape, and a run loads neither JAX nor the JAX package."""
import json
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from ddmbench_cases import REPO, tiny_root  # noqa: E402

from ddmbench import layout  # noqa: E402

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_to_its_files(cell):
    c = layout.load_cell(cell, REPO)
    assert c.chips == 1
    layout.load_plugin("generators", c.config["generator"])
    layout.load_plugin("moves", c.traffic["moves"]["model"])
    layout.load_plugin("operations", c.traffic["operation"])
    names = {m["name"] for m in c.end_to_end}
    assert {"peak_gb", "setup_s"} < names
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.end_to_end + c.per_layer:
        mod = layout.load_plugin("metrics", m["name"])
        assert mod.UNIT == m["unit"]
        if "layer" in m:
            assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])
            assert m["moves"] in names


def test_a_cell_added_as_new_files_only_is_found(tmp_path):
    root = tiny_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "ddmbench/configs/sbm-uniform-n1e7.json")
                     .read_text())
    cfg["params"]["alpha"] = 10
    (root / "ddmbench/configs/sbm-uniform-a10.json").write_text(
        json.dumps(cfg))
    (root / "ddmbench/traffic/replace-5pct.count.json").write_text(
        json.dumps({"operation": "count",
                    "moves": {"model": "replace_uniform", "fraction": 0.05,
                              "pool": 8},
                    "warmup_ticks": 1, "check_ticks": 2, "check_span": 10,
                    "trace_seconds": 1}))
    bench["configs"].append({"name": "sbm-uniform-a10", "source": "x",
                             "file": "ddmbench/configs/sbm-uniform-a10.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "sbm-uniform-a10.count",
                               "config": "sbm-uniform-a10",
                               "traffic": "replace-5pct.count", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "kernels_per_tick.new", "unit": "count",
                               "better": "lower", "source": "device_trace",
                               "layer": "kernel wrappers", "moves": "tick_ms",
                               "workloads": ["sbm-uniform-a10.count"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = layout.load_cell("sbm-uniform-a10.count", root)
    assert c.config["params"]["alpha"] == 10
    assert c.traffic["moves"]["fraction"] == 0.05
    assert [m["name"] for m in c.per_layer] == ["kernels_per_tick.new"]
    assert {m["name"] for m in c.end_to_end} == {"peak_gb", "setup_s"}
    with pytest.raises(KeyError):
        layout.load_cell("no-such-cell", root)


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["ddmbench"]
    assert {m["name"] for m in BENCH["end_to_end"]} >= {
        "tick_ms", "tick_p95_ms", "peak_gb", "setup_s"}
    assert all(not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    seen = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("ddmbench/") and (REPO / c["file"]).is_file()
        assert c["reduced"] == json.loads((REPO / c["file"]).read_text())[
            "reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
    for kind, keys in (("end_to_end", {"name", "unit", "better", "bound",
                                       "source"}),
                       ("per_layer", {"name", "unit", "better", "source",
                                      "layer", "moves"})):
        for m in BENCH[kind]:
            assert set(m) - {"workloads"} == keys
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
            if kind == "end_to_end":
                assert m["source"] in ("host_clock", "device_trace")
                assert 0.01 <= m["bound"] <= 0.25
            else:
                assert set(m["workloads"]) <= set(CELLS)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    for x in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(x), x
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [c["why"] for c in BENCH["configs"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_run_loads_no_jax_and_no_jax_package(tmp_path):
    root = tiny_root(tmp_path)
    code = f"""
import sys, time
sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'src')!r}]
import torch
from ddmbench import run, control, layout
for cell in ("sbm-uniform-n1e7.pairs", "itm-uniform-n1e8.count"):
    c = layout.load_cell(cell, {str(root)!r})
    run.measure(c, 7, 0.05, True, torch.device("cpu"), time.perf_counter())
print(sorted({{m.split(".")[0] for m in sys.modules}}))
print("FORBIDDEN", run.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = eval(out.stdout.splitlines()[-2])
    assert "repro_torch" in tops and "torch" in tops
    assert not {"jax", "jaxlib", "flax", "repro"} & set(tops)
    assert out.stdout.splitlines()[-1] == "FORBIDDEN []"
