"""Whole runs of the benchmark's cells at a size the CPU holds: the last
line's shape, ``correct`` on sound runs, and ``correct`` false with the
timed path broken underneath (an answer altered, the state left
unchanged, half of the updates left out) and with the bfloat16 control
in the program's place.

The harness's look for a chip is skipped: these runs call
``run.measure`` on the CPU, where the port's kernels run their plain
versions.  ``test_a_cell_on_the_card`` runs on a CUDA card only.
"""
import time

import pytest

torch = pytest.importorskip("torch")

from ddmbench_cases import tiny_root  # noqa: E402

from ddmbench import control, run  # noqa: E402
from ddmbench.layout import load_cell  # noqa: E402
from repro_torch.core.engine import MatchPlan  # noqa: E402
from repro_torch.core.regions import Regions  # noqa: E402

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}
CELLS = ("sbm-uniform-n1e7.count", "sbm-uniform-n1e7.pairs",
         "itm-uniform-n1e8.count")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("root"))


def _run(root, cell, seed, trace=False, seconds=0.15):
    c = load_cell(cell, root)
    return run.measure(c, seed, seconds, trace, torch.device("cpu"),
                       time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct_and_its_line_has_the_contracts_keys(root,
                                                                     cell):
    res, info = _run(root, cell, 2**31 + 11)
    assert set(res) == KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    # every end-to-end metric of the cell but the device's memory
    want = {m["name"] for m in load_cell(cell, root).end_to_end}
    assert set(res["metrics"]) == want - {"peak_gb"}
    assert all(set(v) == {"value", "unit"} for v in res["metrics"].values())
    assert all(c["value"] == 0 and c["limit"] == 0
               for c in res["checks"].values())
    assert "state_gap" in res["checks"]
    assert any("checked against the reference" in line for line in info)


def test_a_traced_run_keeps_the_shape(root):
    res, _ = _run(root, "sbm-uniform-n1e7.count", 12, trace=True)
    assert set(res) == KEYS | {"breakdown"} and list(res)[-1] == "checks"
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert res["correct"] is True
    # no device here: the device metrics are left out, not zero
    assert "idle_share" not in res["metrics"]


def _altered(orig):
    def count(self, S, U):
        return orig(self, S, U) + 1

    def pairs(self, S, U):
        res, k = orig(self, S, U)
        res.data[0, 1] = (res.data[0, 1] + 1) % U.n
        return res, k
    return {"count": count, "pairs": pairs}[orig.__name__]


def _unchanged(orig):
    first = []

    def f(self, S, U):
        if not first:
            first.append(orig(self, S, U))
        return first[0]
    return f


def _half(orig):
    def f(self, S, U):
        lo, hi = U.lo.clone(), U.hi.clone()
        lo[U.n // 2:], hi[U.n // 2:] = 1e30, 2e30    # overlaps nothing
        return orig(self, S, Regions(lo, hi))
    return f


@pytest.mark.parametrize("fault", [_altered, _unchanged, _half])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(root, cell, fault, monkeypatch):
    method = "pairs" if cell.endswith(".pairs") else "count"
    monkeypatch.setattr(MatchPlan, method, fault(getattr(MatchPlan, method)))
    res, _ = _run(root, cell, 31)
    assert res["correct"] is False and res["failed"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_the_bfloat16_control_fails_on_three_seeds(root, cell):
    c = load_cell(cell, root)
    for seed in (1, 2, 2**31 + 3):
        res = control.control_run(c, seed, 0.15, torch.device("cpu"))
        assert res["correct"] is False and res["failed"] >= 1
        assert res["checks"]["k_gap"]["value"] > 0
    # the program is back in its place afterwards
    assert _run(root, cell, 1)[0]["correct"] is True


@pytest.mark.cuda
def test_a_cell_on_the_card(root):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    c = load_cell("sbm-uniform-n1e7.count", root)
    res, _ = run.measure(c, 5, 0.5, True, torch.device("cuda", 0),
                         time.perf_counter())
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
    assert {"k1_roofline", "lexsort_ms", "host_reads_per_tick",
            "stage_idle_ms"} <= set(res["metrics"])
