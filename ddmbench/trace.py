"""One ``torch.profiler`` trace of the steady window, reduced to what the
per-layer metrics read.

The harness marks every traced tick with a ``ddmbench.tick`` span (and
its parts with ``ddmbench.move`` and ``ddmbench.match``); the port marks
its own stages with ``repro_torch.*`` spans (``src/repro_torch/spans.py``:
the endpoint lex-sort, pass 1 of the two-pass emit, ``build_tree``, the
second emission of ``exact`` and ``grow``, every host read of a count),
function-scope records on the same clock.  ``records`` turns the
profiler's raw events into plain ``Record``s; ``reduce`` keeps the ticks
after the first ``skip`` (the profiler's own warm-up) and gives, over the
window from the first kept tick's start to the last one's end:

* the device operations that started in it (kernels, copies, fills),
  with their names and durations, and ``kernels`` among them;
* ``busy_ns``: the union of those operations' intervals, clipped to the
  window;
* the idle gaps between them, each named by what the host was doing at
  its midpoint: the innermost ``ddmbench.*`` span, then the innermost
  host operation (``between ticks`` and ``python`` where there is none);
* ``breakdown``: the ten device operations that took most time, and the
  ten host activities that the device waited longest on, summed by name;
* the port's spans on the ticks' thread, and for each device operation
  the start of the runtime or driver call that launched it, found by the
  profiler's correlation id.

A stage is either a group of kernels by name (``stage``), which depends
on the kernels' names, or the device work launched inside one of the
port's spans (``within``), which depends on the span's name.
"""
from __future__ import annotations

import bisect
import dataclasses
import re

TICK_SPAN = "ddmbench.tick"
SPAN_PREFIX = "ddmbench."
PROGRAM_PREFIX = "repro_torch."
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")
# a runtime or driver call by its name (cudaLaunchKernel, cuLaunchKernel):
# where a torch build gives its events no activity type, ``_kind`` reads
# these as ``cpu_op``
API_CALL = re.compile(r"cu(da)?[A-Z]")


@dataclasses.dataclass(frozen=True)
class Record:
    """One profiler event: ``kind`` is the profiler's activity type,
    ``corr`` its correlation id (0 where the torch build has none)."""

    name: str
    kind: str
    start_ns: int
    dur_ns: int
    thread: int = 0
    corr: int = 0

    @property
    def end_ns(self) -> int:
        return self.start_ns + self.dur_ns


def _kind(e) -> str:
    """The profiler's activity type of a raw event.  Older torch (2.11)
    has no ``activity_type``: a device event is then a copy, a fill, a
    span's device mirror, a sync marker or a kernel by its name."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    from torch.autograd import DeviceType
    name = e.name()
    if e.device_type() != DeviceType.CUDA:
        return "user_annotation" if name.startswith(SPAN_PREFIX) \
            else "cpu_op"
    if name.startswith(SPAN_PREFIX):
        return "gpu_user_annotation"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    if name.endswith(" Sync") or name == "Stream Wait Event":
        return "cuda_sync"
    return "kernel"


def records(prof) -> list[Record]:
    """The raw events of a finished ``torch.profiler.profile``."""
    out = []
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        if kind in DEVICE_KINDS or kind in HOST_KINDS:
            corr = e.correlation_id() if hasattr(e, "correlation_id") else 0
            out.append(Record(e.name(), kind, int(e.start_ns()),
                              int(e.duration_ns()), int(e.start_thread_id()),
                              int(corr)))
    return out


def matches(name: str, patterns) -> bool:
    """Whether a kernel's name contains one of ``patterns``, ignoring case."""
    low = name.lower()
    return any(p.lower() in low for p in patterns)


def _launch_call(r: Record) -> bool:
    return r.kind in LAUNCH_KINDS or (r.kind == "cpu_op"
                                      and API_CALL.match(r.name) is not None)


def _inside(union: list, starts: list, x: int) -> bool:
    """Whether ``x`` lies in one of the disjoint sorted ``union``
    intervals (``_merge``'s; ``starts`` their starts)."""
    i = bisect.bisect_right(starts, x) - 1
    return i >= 0 and x < union[i][1]


@dataclasses.dataclass
class Trace:
    ticks: int
    window_ns: int
    busy_ns: int
    ops: list            # (name, kind, dur_ns) of the window's device ops
    breakdown: dict
    spans: list          # (name, start_ns, end_ns) of the port's spans
    launch_ns: list      # each op's launch call's start_ns, or None
    gaps: list           # (start_ns, end_ns) with no device operation

    @property
    def kernels(self) -> list:
        return [o for o in self.ops if o[1] == "kernel"]

    def stage(self, patterns) -> tuple[int, int]:
        """(launches, device ns) of the window's kernels in a stage."""
        hit = [o[2] for o in self.kernels if matches(o[0], patterns)]
        return len(hit), sum(hit)

    @property
    def unmatched(self) -> list:
        """Names of the window's device operations with no launch call."""
        return [o[0] for o, at in zip(self.ops, self.launch_ns) if at is None]

    def _union_of(self, names) -> tuple[list, list]:
        u = _merge((a, b) for n, a, b in self.spans if n in names)
        return u, [a for a, _ in u]

    def within(self, name: str) -> tuple[int, int]:
        """(launches, device ns) of the device operations whose launch
        call started inside a ``repro_torch.<name>`` span; a span nested
        in another counts for both."""
        union, starts = self._union_of({PROGRAM_PREFIX + name})
        hit = [o[2] for o, at in zip(self.ops, self.launch_ns)
               if at is not None and _inside(union, starts, at)]
        return len(hit), sum(hit)

    def spans_of(self, name: str) -> tuple[int, int]:
        """(count, host ns) of the ``repro_torch.<name>`` spans."""
        full = PROGRAM_PREFIX + name
        durs = [b - a for n, a, b in self.spans if n == full]
        return len(durs), sum(durs)

    def idle_in_program_ns(self) -> int:
        """Idle ns of the gaps whose midpoint lies inside any of the
        port's spans."""
        union, starts = self._union_of({n for n, _, _ in self.spans})
        return sum(b - a for a, b in self.gaps
                   if _inside(union, starts, (a + b) // 2))


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _label_gaps(gaps, host, thread):
    """Name each ``(start, end)`` gap by the host activity at its midpoint."""
    events = sorted((r for r in host if r.thread == thread),
                    key=lambda r: r.start_ns)
    labels = []
    active: list[Record] = []
    i = 0
    for a, b in sorted(gaps):
        mid = (a + b) // 2
        while i < len(events) and events[i].start_ns <= mid:
            active.append(events[i])
            i += 1
        active = [r for r in active if r.end_ns > mid]
        spans = [r for r in active if r.name.startswith(SPAN_PREFIX)]
        ops = [r for r in active if not r.name.startswith(SPAN_PREFIX)]
        span = max(spans, key=lambda r: r.start_ns).name if spans \
            else "between ticks"
        op = max(ops, key=lambda r: r.start_ns).name if ops else "python"
        labels.append((f"{span}/{op}", b - a))
    return labels


def _top(pairs, k: int = 10) -> list:
    tot: dict[str, int] = {}
    for name, ns in pairs:
        tot[name] = tot.get(name, 0) + ns
    return [[name[:200], ns / 1e9] for name, ns in
            sorted(tot.items(), key=lambda x: -x[1])[:k]]


def reduce(recs: list[Record], skip: int) -> Trace | None:
    """The window of the ticks after the first ``skip``; ``None`` when the
    trace holds no such tick."""
    ticks = sorted((r for r in recs if r.name == TICK_SPAN),
                   key=lambda r: r.start_ns)[skip:]
    if not ticks:
        return None
    w0, w1 = ticks[0].start_ns, max(r.end_ns for r in ticks)
    thread = ticks[0].thread
    dev = [r for r in recs if r.kind in DEVICE_KINDS
           and w0 <= r.start_ns < w1]
    busy = _merge((r.start_ns, min(r.end_ns, w1)) for r in dev)
    busy_ns = sum(b - a for a, b in busy)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[j], edges[j + 1]) for j in range(0, len(edges), 2)
            if edges[j + 1] > edges[j]]
    host = [r for r in recs if r.kind in HOST_KINDS]
    labels = _label_gaps(gaps, host, thread)
    breakdown = {"device_ops": _top((r.name, r.dur_ns) for r in dev),
                 "idle_gaps": _top(labels)}
    launch: dict[int, int] = {}
    for r in host:
        if r.corr and _launch_call(r):
            launch[r.corr] = min(launch.get(r.corr, r.start_ns), r.start_ns)
    spans = [(r.name, r.start_ns, r.end_ns) for r in host
             if r.name.startswith(PROGRAM_PREFIX) and r.thread == thread
             and w0 <= r.start_ns < w1]
    return Trace(ticks=len(ticks), window_ns=w1 - w0, busy_ns=busy_ns,
                 ops=[(r.name, r.kind, r.dur_ns) for r in dev],
                 breakdown=breakdown, spans=spans,
                 launch_ns=[launch.get(r.corr) for r in dev], gaps=gaps)
