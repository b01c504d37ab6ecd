"""The port's spans read from a trace (``ddmbench/trace.py``) and the
per-layer metrics that read them.

On a synthetic event list: a device operation counts for a span when its
launch call (same correlation id) started inside it, ancestors included;
one launched outside counts for none; one with no launch call is
unmatched; an idle gap counts as the program's when its midpoint lies in
one of its spans.  Each stage reader's value on such lists is worked out
by hand, its ``None`` and 0 cases included.  ``trace.reduce``'s outputs
that the accepted metrics read are pinned on that list, and equal with
and without correlation ids.  On the CPU, a tick of each cell untraced
opens no profiler range, and a traced window reads the host reads a
tick.
"""
import time

import pytest

torch = pytest.importorskip("torch")

from ddmbench_cases import tiny_root  # noqa: E402

from ddmbench import run, session, trace  # noqa: E402
from ddmbench.layout import load_cell, load_plugin  # noqa: E402

CELLS = ("sbm-uniform-n1e7.count", "sbm-uniform-n1e7.pairs",
         "itm-uniform-n1e8.count")
E = trace.Record

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
    assert trace.reduce(EVENTS, 1).within(name) == want


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
    tr = trace.reduce(evs, 0)
    assert tr.within("itm.build_tree") == ((1, 9) if found else (0, 0))
    assert tr.unmatched == ([] if found else ["radixSortKVInPlace"])


def test_spans_unmatched_ops_and_idle_in_the_program():
    tr = trace.reduce(EVENTS, 1)
    assert tr.ticks == 2
    # the span on thread 2 is not the ticks' thread's
    assert tr.spans_of("sbm.pass1") == (2, 70)
    assert tr.spans_of("host_read") == (2, 20)
    assert tr.spans_of("engine.reemit") == (1, 60)
    assert tr.unmatched == ["orphan_kernel"]
    # gaps at midpoints 183 (a read), 225, 260, 282 (the re-emit); not
    # 125 (before pass 1) nor 297 (after the re-emit)
    assert tr.idle_in_program_ns() == 46 + 30 + 10 + 15


# the reduced outputs that the accepted metrics read, as ``reduce`` gave
# them before it kept the port's spans and the launch calls
PINNED = {
    "ticks": 2, "window_ns": 200, "busy_ns": 44,
    "ops": [("searchsorted_cuda_kernel", "kernel", 10),
            ("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 4),
            ("radixSortKVInPlace", "kernel", 15),
            ("emit_tiles_kernel", "kernel", 10),
            ("orphan_kernel", "kernel", 5)],
    "breakdown": {
        "device_ops": [["radixSortKVInPlace", 1.5e-08],
                       ["searchsorted_cuda_kernel", 1e-08],
                       ["emit_tiles_kernel", 1e-08],
                       ["orphan_kernel", 5e-09],
                       ["Memcpy DtoD (Device -> Device)", 4e-09]],
        "idle_gaps": [["ddmbench.match/repro_torch.engine.reemit",
                       5.5e-08],
                      ["ddmbench.match/python", 5e-08],
                      ["ddmbench.match/cudaStreamSynchronize", 4.6e-08],
                      ["ddmbench.tick/python", 5e-09]]}}


def _without_corr(evs):
    return [E(e.name, e.kind, e.start_ns, e.dur_ns, e.thread) for e in evs]


def test_reduce_reads_the_list_as_it_did_before_the_spans():
    tr, plain = trace.reduce(EVENTS, 1), trace.reduce(_without_corr(EVENTS),
                                                      1)
    for field in PINNED:
        assert getattr(tr, field) == getattr(plain, field), field
    assert tr.kernels == plain.kernels and len(tr.kernels) == 4
    assert tr.stage(("radixsort",)) == plain.stage(("radixsort",)) == (1, 15)
    # with no correlation id no operation has a launch call
    assert plain.unmatched == [o[0] for o in PINNED["ops"]]
    assert plain.within("sbm.pass1") == (0, 0)
    assert plain.spans == tr.spans and plain.gaps == tr.gaps


@pytest.mark.parametrize("corr", [True, False])
def test_reduce_gives_the_parents_outputs_on_the_list(corr):
    tr = trace.reduce(EVENTS if corr else _without_corr(EVENTS), 1)
    assert {f: getattr(tr, f) for f in PINNED} == PINNED


# two kept ticks of a count or ITM tick: two endpoint sorts, one
# build_tree, no host read and no re-emission
COUNT_EVENTS = [
    E("ddmbench.tick", "user_annotation", 0, 100, 1),
    E("ddmbench.tick", "user_annotation", 100, 100, 1),
    E("ddmbench.tick", "user_annotation", 200, 100, 1),
    E("repro_torch.sbm.endpoint_sort", "cpu_op", 110, 40, 1),
    E("repro_torch.itm.build_tree", "cpu_op", 160, 30, 1),
    E("repro_torch.sbm.endpoint_sort", "cpu_op", 210, 40, 1),
    E("cudaLaunchKernel", "cuda_runtime", 115, 2, 1, 21),
    E("radixSortKVInPlace", "kernel", 120, 20, 7, 21),
    E("cuLaunchKernel", "cuda_driver", 165, 1, 1, 23),
    E("walk_per_thread", "kernel", 170, 8, 7, 23),
    E("cudaLaunchKernel", "cuda_runtime", 215, 2, 1, 22),
    E("radixSortKVInPlace", "kernel", 220, 12, 7, 22),
]
# EVENTS with no re-emission span, and EVENTS with no device operation
NO_REEMIT = [e for e in EVENTS if e.name != "repro_torch.engine.reemit"]
NO_DEVICE = [e for e in EVENTS if e.kind not in trace.DEVICE_KINDS]


@pytest.mark.parametrize("metric, evs, want", [
    ("lexsort_ms", COUNT_EVENTS, (20 + 12) / 1e6 / 2),
    ("lexsort_ms", EVENTS, None),          # no endpoint sort span
    ("pass1_ms", EVENTS, (10 + 15) / 1e6 / 2),
    ("pass1_ms", COUNT_EVENTS, None),
    ("reemit_ms", EVENTS, (15 + 10) / 1e6 / 2),
    ("reemit_ms", NO_REEMIT, 0.0),         # one emission a tick
    ("reemit_ms", COUNT_EVENTS, 0.0),
    ("reemit_ms", NO_DEVICE, None),
    # re-emission spans whose work no launch call ties to them
    ("reemit_ms", _without_corr(EVENTS), None),
    ("tree_ms", COUNT_EVENTS, 8 / 1e6 / 2),
    ("tree_ms", EVENTS, None),
    ("host_reads_per_tick", EVENTS, 2 / 2),
    ("host_reads_per_tick", NO_DEVICE, 2 / 2),
    ("host_reads_per_tick", COUNT_EVENTS, 0.0),
    ("host_wait_ms", EVENTS, (10 + 10) / 1e6 / 2),
    ("host_wait_ms", COUNT_EVENTS, 0.0),
    # gaps at midpoints 183, 225, 260, 282 in EVENTS; [100, 120) at
    # midpoint 110, the first endpoint sort's start, in COUNT_EVENTS
    ("stage_idle_ms", EVENTS, (46 + 30 + 10 + 15) / 1e6 / 2),
    ("stage_idle_ms", COUNT_EVENTS, 20 / 1e6 / 2),
    ("stage_idle_ms", NO_DEVICE, None),
])
def test_each_stage_reader_on_a_hand_built_trace(metric, evs, want):
    win = session.Window(1, 1, 0.0, [], 0.0, [1], trace=trace.reduce(evs, 1))
    got = load_plugin("metrics", metric).read(win)
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want)
    assert bool(win.notes) == (want is None)


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
    c = load_cell(cell, root)
    win, _, _, _, info = session.run(c, 2**31 + 9, 0.2, True,
                                     torch.device("cpu"), time.perf_counter())
    got = {k: v["value"] for k, v in run._metrics(c.per_layer, win).items()}
    tr = win.trace
    assert tr.ticks >= 1 and tr.ops == []
    assert "device ops with no launch call: 0 of 0" in info
    reemits = tr.spans_of("engine.reemit")[0] / tr.ticks
    if cell.endswith(".pairs"):
        # two reads an emission, and one more emission a tick whose K
        # differs from the last
        assert 0 < reemits <= 1
        assert got["host_reads_per_tick"] == pytest.approx(2 * (1 + reemits))
    else:
        assert reemits == 0.0
        assert got["host_reads_per_tick"] == 1.0
    assert got["host_wait_ms"] > 0
    # no device here: no stage's device time, no idle reading
    assert not set(got) & {"lexsort_ms", "pass1_ms", "tree_ms",
                           "reemit_ms", "stage_idle_ms"}
    assert tr.window_ns / tr.ticks > 0
