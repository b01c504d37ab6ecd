"""Stage readings from the port's own spans, in one traced window of a cell.

The port marks its stages with ``torch.profiler.record_function`` ranges
named ``repro_torch.*`` (``src/repro_torch/spans.py``): the endpoint
lex-sort, pass 1 of the two-pass emit, ``build_tree``, ``exact``'s and
``grow``'s second emission, and every host read of a count.  They land
in the same trace as the device operations, on its clock.  This module
keeps what attributing device work to them needs, beside what
``trace.reduce`` keeps:

* ``Event``: ``trace.Record`` with the profiler's correlation id, which
  ties a device operation to the runtime or driver call that launched it
  (0 where a torch build has none);
* ``Stages``: over ``trace.reduce``'s window, the spans on the ticks'
  thread, each device operation with the start of its launch call, and
  the idle gaps; ``within``, ``spans_of`` and ``idle_in_program_ns``
  read them;
* ``readings``: the stage metrics a tick.

    python3 ddmbench/stages.py --workload <cell> --seed <n>

from the root of a checkout runs the cell's set-up and warm-up, traces
the traffic's ``trace_seconds`` of ticks as ``run.py --trace 1`` does
(on a card), and prints one JSON
line: the stage readings with their units, the cell's accepted per-layer
metrics read from the same trace, the traced ms a tick, and the device
operations whose launch call the trace lacks.  ``run.py``'s result line
does not carry the stage readings: ``trace.reduce``, which it calls,
keeps no correlation id and no span of the program.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import re
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    ROOT = Path(__file__).resolve().parent.parent
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from ddmbench import trace  # noqa: E402

PROGRAM_PREFIX = "repro_torch."
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")
# a runtime or driver call by its name (cudaLaunchKernel, cuLaunchKernel):
# where a torch build gives its events no activity type, ``trace._kind``
# reads these as ``cpu_op``
API_CALL = re.compile(r"cu(da)?[A-Z]")


def _launch_call(r) -> bool:
    return r.kind in LAUNCH_KINDS or (r.kind == "cpu_op"
                                      and API_CALL.match(r.name) is not None)


@dataclasses.dataclass(frozen=True)
class Event(trace.Record):
    """A ``trace.Record`` with the profiler's correlation id."""

    corr: int = 0


def events(prof) -> list[Event]:
    """``trace.records(prof)``, each with its correlation id."""
    out = []
    for e in prof.profiler.kineto_results.events():
        kind = trace._kind(e)
        if kind in trace.DEVICE_KINDS or kind in trace.HOST_KINDS:
            corr = e.correlation_id() if hasattr(e, "correlation_id") else 0
            out.append(Event(e.name(), kind, int(e.start_ns()),
                             int(e.duration_ns()), int(e.start_thread_id()),
                             int(corr)))
    return out


def _inside(union: list, starts: list, x: int) -> bool:
    """Whether ``x`` lies in one of the disjoint sorted ``union``
    intervals (``trace._merge``'s; ``starts`` their starts)."""
    i = bisect.bisect_right(starts, x) - 1
    return i >= 0 and x < union[i][1]


@dataclasses.dataclass
class Stages:
    ticks: int
    spans: list      # (name, start_ns, end_ns) of the program's spans
    launched: list   # (name, dur_ns, launch call's start_ns or None)
    gaps: list       # (start_ns, end_ns) with no device operation

    @property
    def unmatched(self) -> list:
        """Names of the window's device operations with no launch call."""
        return [name for name, _, at in self.launched if at is None]

    def _union_of(self, names) -> tuple[list, list]:
        u = trace._merge((a, b) for n, a, b in self.spans if n in names)
        return u, [a for a, _ in u]

    def within(self, name: str) -> tuple[int, int]:
        """(launches, device ns) of the device operations whose launch
        call started inside a ``repro_torch.<name>`` span; a span nested
        in another counts for both."""
        union, starts = self._union_of({PROGRAM_PREFIX + name})
        hit = [dur for _, dur, at in self.launched
               if at is not None and _inside(union, starts, at)]
        return len(hit), sum(hit)

    def spans_of(self, name: str) -> tuple[int, int]:
        """(count, host ns) of the ``repro_torch.<name>`` spans."""
        full = PROGRAM_PREFIX + name
        durs = [b - a for n, a, b in self.spans if n == full]
        return len(durs), sum(durs)

    def idle_in_program_ns(self) -> int:
        """Idle ns of the gaps whose midpoint lies inside any of the
        program's spans."""
        union, starts = self._union_of({n for n, _, _ in self.spans})
        return sum(b - a for a, b in self.gaps
                   if _inside(union, starts, (a + b) // 2))


def stages(evs: list[Event], skip: int) -> Stages | None:
    """The program's spans and device work over the window
    ``trace.reduce(evs, skip)`` reads; ``None`` where it reads none."""
    ticks = sorted((r for r in evs if r.name == trace.TICK_SPAN),
                   key=lambda r: r.start_ns)[skip:]
    if not ticks:
        return None
    w0, w1 = ticks[0].start_ns, max(r.end_ns for r in ticks)
    thread = ticks[0].thread
    dev = [r for r in evs if r.kind in trace.DEVICE_KINDS
           and w0 <= r.start_ns < w1]
    launch: dict[int, int] = {}
    for r in evs:
        if r.corr and _launch_call(r):
            launch[r.corr] = min(launch.get(r.corr, r.start_ns), r.start_ns)
    spans = [(r.name, r.start_ns, r.end_ns) for r in evs
             if r.name.startswith(PROGRAM_PREFIX) and r.kind in
             trace.HOST_KINDS and r.thread == thread
             and w0 <= r.start_ns < w1]
    busy = trace._merge((r.start_ns, min(r.end_ns, w1)) for r in dev)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[j], edges[j + 1]) for j in range(0, len(edges), 2)
            if edges[j + 1] > edges[j]]
    return Stages(ticks=len(ticks), spans=spans,
                  launched=[(r.name, r.dur_ns, launch.get(r.corr))
                            for r in dev],
                  gaps=gaps)


# the readings of device ms a tick: name -> the span whose work they read
DEVICE_MS = {"lexsort_ms": "sbm.endpoint_sort", "pass1_ms": "sbm.pass1",
             "tree_ms": "itm.build_tree", "reemit_ms": "engine.reemit"}
UNITS = {"lexsort_ms": "ms", "pass1_ms": "ms", "tree_ms": "ms",
         "reemit_ms": "ms", "reemits_per_tick": "count",
         "host_reads_per_tick": "count", "host_wait_ms": "ms",
         "stage_idle_ms": "ms"}


def readings(st: Stages) -> dict:
    """The stage readings a tick; a stage that launched nothing in the
    window, and the idle reading of a trace with no device operation,
    are left out."""
    out = {}
    for name, span in DEVICE_MS.items():
        launches, ns = st.within(span)
        if launches:
            out[name] = ns / 1e6 / st.ticks
    reemits, _ = st.spans_of("engine.reemit")
    reads, wait_ns = st.spans_of("host_read")
    out["reemits_per_tick"] = reemits / st.ticks
    out["host_reads_per_tick"] = reads / st.ticks
    out["host_wait_ms"] = wait_ns / 1e6 / st.ticks
    if st.launched:
        out["stage_idle_ms"] = st.idle_in_program_ns() / 1e6 / st.ticks
    return out


def measure(cell, seed: int, seconds: float, device) -> dict:
    """One traced window of ``cell``: the line ``main`` prints."""
    from ddmbench import run, session

    t0 = time.perf_counter()
    ses = session.Session(cell, seed, device)
    ses.warm_up()
    setup_s = time.perf_counter() - t0
    prof, ks = ses.traced(seconds)
    evs = events(prof)
    tr = trace.reduce(evs, session.TRACE_SKIP)
    st = stages(evs, session.TRACE_SKIP)
    if tr is None or st is None:
        return {"workload": cell.name, "seed": seed, "error": "no tick"}
    win = session.Window(ses.work.n, ses.work.m, setup_s, [], 0.0, ks,
                         trace=tr)
    accepted = run._metrics(cell.per_layer, win)
    unmatched: dict[str, int] = {}
    for name in st.unmatched:
        unmatched[name[:120]] = unmatched.get(name[:120], 0) + 1
    return {"workload": cell.name, "seed": seed, "device": str(device),
            "ticks": st.ticks, "traced_ms_per_tick": tr.window_ns / 1e6
            / tr.ticks, "busy_s": tr.busy_ns / 1e9,
            "window_s": tr.window_ns / 1e9,
            "stages": {k: {"value": v, "unit": UNITS[k]}
                       for k, v in readings(st).items()},
            "accepted": {k: v["value"] for k, v in accepted.items()},
            "device_ops": len(st.launched),
            "unmatched_ops": len(st.unmatched), "unmatched": unmatched,
            "notes": win.notes}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    from ddmbench import run
    run._fixed_caches()
    from ddmbench.layout import load_cell
    cell = load_cell(args.workload, run.ROOT)

    import torch
    if not torch.cuda.is_available():
        print(f"{cell.name} needs a CUDA card", file=sys.stderr)
        return 2
    print(json.dumps(measure(cell, args.seed,
                             float(cell.traffic["trace_seconds"]),
                             torch.device("cuda", 0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
