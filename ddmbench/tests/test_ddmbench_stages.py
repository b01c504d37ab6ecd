"""``ddmbench/stages.py``: the port's spans read from a trace.

On a synthetic event list: a device operation counts for a span when its
launch call (same correlation id) started inside it, ancestors included;
one launched outside counts for none; one with no launch call is
unmatched; an idle gap counts as the program's when its midpoint lies in
one of its spans.  ``trace.reduce``'s outputs on that list are pinned,
and equal for the list with and without correlation ids.  On the CPU, a
tick of each cell untraced opens no profiler range, and a
traced window reads the host reads a tick.
"""
import pytest

torch = pytest.importorskip("torch")

from ddmbench_cases import tiny_root  # noqa: E402

from ddmbench import session, stages, trace  # noqa: E402
from ddmbench.layout import load_cell  # noqa: E402

CELLS = ("sbm-uniform-n1e7.count", "sbm-uniform-n1e7.pairs",
         "itm-uniform-n1e8.count")
E = stages.Event

# three ticks on thread 1 (the first skipped), device work on stream 7
EVENTS = [
    E("ddmbench.tick", "user_annotation", 0, 100, 1),
    E("ddmbench.tick", "user_annotation", 100, 100, 1),
    E("ddmbench.tick", "user_annotation", 200, 100, 1),
    E("ddmbench.match", "user_annotation", 120, 70, 1),
    E("ddmbench.match", "user_annotation", 220, 70, 1),
    E("repro_torch.sbm.pass1", "user_annotation", 130, 40, 1),
    E("repro_torch.host_read", "user_annotation", 175, 10, 1),
    E("repro_torch.engine.reemit", "user_annotation", 225, 60, 1),
    E("repro_torch.sbm.pass1", "user_annotation", 230, 30, 1),
    E("repro_torch.host_read", "user_annotation", 270, 10, 1),
    E("repro_torch.sbm.pass1", "user_annotation", 230, 30, 2),
    E("aten::searchsorted", "cpu_op", 140, 5, 1, 101),
    E("cudaLaunchKernel", "cuda_runtime", 45, 2, 1, 5),
    E("searchsorted_cuda_kernel", "kernel", 50, 10, 7, 5),
    E("cudaLaunchKernel", "cuda_runtime", 140, 2, 1, 1),
    E("searchsorted_cuda_kernel", "kernel", 150, 10, 7, 1),
    E("cudaStreamSynchronize", "cuda_runtime", 176, 8, 1, 10),
    E("cudaMemcpyAsync", "cuda_runtime", 205, 1, 1, 4),
    E("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 206, 4, 7, 4),
    E("cudaLaunchKernel", "cuda_runtime", 235, 2, 1, 2),
    E("radixSortKVInPlace", "kernel", 240, 15, 7, 2),
    E("cuLaunchKernel", "cuda_driver", 265, 1, 1, 3),
    E("emit_tiles_kernel", "kernel", 265, 10, 7, 3),
    E("orphan_kernel", "kernel", 290, 5, 7, 9),
]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("root"))


@pytest.mark.parametrize("name, want", [
    ("sbm.pass1", (2, 25)),        # one launch in each pass 1 span
    ("engine.reemit", (2, 25)),    # its own launch and its pass 1's
    ("sbm.endpoint_sort", (0, 0)),
    ("host_read", (0, 0)),         # a sync launches no device work
])
def test_device_work_counts_for_the_spans_its_launch_started_in(name,
                                                                want):
    assert stages.stages(EVENTS, 1).within(name) == want


@pytest.mark.parametrize("call, kind, found", [
    ("cudaLaunchKernel", "cuda_runtime", True),
    ("cuLaunchKernelEx", "cuda_driver", True),
    # a build without activity types: the runtime call reads as cpu_op
    ("cudaLaunchKernel", "cpu_op", True),
    ("aten::argsort", "cpu_op", False),
])
def test_a_launch_call_is_found_by_its_kind_or_its_name(call, kind, found):
    evs = [E("ddmbench.tick", "user_annotation", 0, 100, 1),
           E("repro_torch.itm.build_tree", "cpu_op", 10, 50, 1),
           E(call, kind, 20, 2, 1, 8),
           E("radixSortKVInPlace", "kernel", 30, 9, 7, 8)]
    st = stages.stages(evs, 0)
    assert st.within("itm.build_tree") == ((1, 9) if found else (0, 0))
    assert st.unmatched == ([] if found else ["radixSortKVInPlace"])


def test_spans_unmatched_ops_and_idle_in_the_program():
    st = stages.stages(EVENTS, 1)
    assert st.ticks == 2
    # the span on thread 2 is not the ticks' thread's
    assert st.spans_of("sbm.pass1") == (2, 70)
    assert st.spans_of("host_read") == (2, 20)
    assert st.unmatched == ["orphan_kernel"]
    # gaps at midpoints 183 (a read), 225, 260, 282 (the re-emit); not
    # 125 (before pass 1) nor 297 (after the re-emit)
    assert st.idle_in_program_ns() == 46 + 30 + 10 + 15
    r = stages.readings(st)
    assert r["pass1_ms"] == r["reemit_ms"] == 25 / 1e6 / 2
    assert "lexsort_ms" not in r and "tree_ms" not in r
    assert r["host_reads_per_tick"] == 1.0 and r["reemits_per_tick"] == 0.5
    assert r["stage_idle_ms"] == 101 / 1e6 / 2


def test_reduce_reads_the_list_as_it_did_before_the_spans():
    plain = [trace.Record(e.name, e.kind, e.start_ns, e.dur_ns, e.thread)
             for e in EVENTS]
    tr = trace.reduce(EVENTS, 1)
    assert tr == trace.reduce(plain, 1)
    assert (tr.ticks, tr.window_ns, tr.busy_ns) == (2, 200, 44)
    assert tr.ops == [("searchsorted_cuda_kernel", "kernel", 10),
                      ("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 4),
                      ("radixSortKVInPlace", "kernel", 15),
                      ("emit_tiles_kernel", "kernel", 10),
                      ("orphan_kernel", "kernel", 5)]
    assert tr.stage(("radixsort",)) == (1, 15)
    assert tr.breakdown == {
        "device_ops": [["radixSortKVInPlace", 1.5e-08],
                       ["searchsorted_cuda_kernel", 1e-08],
                       ["emit_tiles_kernel", 1e-08],
                       ["orphan_kernel", 5e-09],
                       ["Memcpy DtoD (Device -> Device)", 4e-09]],
        "idle_gaps": [["ddmbench.match/repro_torch.engine.reemit",
                       5.5e-08],
                      ["ddmbench.match/python", 5e-08],
                      ["ddmbench.match/cudaStreamSynchronize", 4.6e-08],
                      ["ddmbench.tick/python", 5e-09]]}


def _raise(*args, **kwargs):
    raise AssertionError("a profiler range made with no profiler running")


def _no_ranges(monkeypatch):
    """Make every way of opening a profiler range raise."""
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _raise)


@pytest.mark.parametrize("cell", CELLS)
def test_an_untraced_tick_never_opens_a_profiler_range(root, cell,
                                                         monkeypatch):
    ses = session.Session(load_cell(cell, root), 2**31 + 5,
                          torch.device("cpu"))
    _no_ranges(monkeypatch)
    for _ in range(2):
        ses.op.k_of(ses.tick())


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_window_reads_the_host_reads_a_tick(root, cell):
    line = stages.measure(load_cell(cell, root), 2**31 + 9, 0.2,
                          torch.device("cpu"))
    got = {k: v["value"] for k, v in line["stages"].items()}
    assert line["ticks"] >= 1 and line["device_ops"] == 0
    if cell.endswith(".pairs"):
        # two reads an emission, and one more emission a tick whose K
        # differs from the last
        assert 0 < got["reemits_per_tick"] <= 1
        assert got["host_reads_per_tick"] == pytest.approx(
            2 * (1 + got["reemits_per_tick"]))
    else:
        assert got["reemits_per_tick"] == 0.0
        assert got["host_reads_per_tick"] == 1.0
    assert got["host_wait_ms"] > 0
    # no device here: no stage's device time, no idle reading
    assert not set(got) & {"lexsort_ms", "pass1_ms", "tree_ms",
                           "reemit_ms", "stage_idle_ms"}
    assert line["traced_ms_per_tick"] > 0
