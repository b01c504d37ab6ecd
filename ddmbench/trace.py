"""One ``torch.profiler`` trace of the steady window, reduced to what the
per-layer metrics read.

The harness marks every traced tick with a ``ddmbench.tick`` span (and
its parts with ``ddmbench.move`` and ``ddmbench.match``).  ``records``
turns the profiler's raw events into plain ``Record``s; ``reduce`` keeps
the ticks after the first ``skip`` (the profiler's own warm-up) and
gives, over the window from the first kept tick's start to the last
one's end:

* the device operations that started in it (kernels, copies, fills),
  with their names and durations, and ``kernels`` among them;
* ``busy_ns``: the union of those operations' intervals, clipped to the
  window;
* the idle gaps between them, each named by what the host was doing at
  its midpoint: the innermost ``ddmbench.*`` span, then the innermost
  host operation (``between ticks`` and ``python`` where there is none);
* ``breakdown``: the ten device operations that took most time, and the
  ten host activities that the device waited longest on, summed by name.

A stage is a group of kernels by name (``stage``), so a stage metric
depends on the kernels' names, not on spans inside the program.
"""
from __future__ import annotations

import dataclasses

TICK_SPAN = "ddmbench.tick"
SPAN_PREFIX = "ddmbench."
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclasses.dataclass(frozen=True)
class Record:
    """One profiler event: ``kind`` is the profiler's activity type."""

    name: str
    kind: str
    start_ns: int
    dur_ns: int
    thread: int = 0

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
            out.append(Record(e.name(), kind, int(e.start_ns()),
                              int(e.duration_ns()), int(e.start_thread_id())))
    return out


def matches(name: str, patterns) -> bool:
    """Whether a kernel's name contains one of ``patterns``, ignoring case."""
    low = name.lower()
    return any(p.lower() in low for p in patterns)


@dataclasses.dataclass
class Trace:
    ticks: int
    window_ns: int
    busy_ns: int
    ops: list            # (name, kind, dur_ns) of the window's device ops
    breakdown: dict

    @property
    def kernels(self) -> list:
        return [o for o in self.ops if o[1] == "kernel"]

    def stage(self, patterns) -> tuple[int, int]:
        """(launches, device ns) of the window's kernels in a stage."""
        hit = [o[2] for o in self.kernels if matches(o[0], patterns)]
        return len(hit), sum(hit)


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
    dev = [r for r in recs if r.kind in DEVICE_KINDS
           and w0 <= r.start_ns < w1]
    busy = _merge((r.start_ns, min(r.end_ns, w1)) for r in dev)
    busy_ns = sum(b - a for a, b in busy)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[j], edges[j + 1]) for j in range(0, len(edges), 2)
            if edges[j + 1] > edges[j]]
    host = [r for r in recs if r.kind in HOST_KINDS]
    labels = _label_gaps(gaps, host, ticks[0].thread)
    breakdown = {"device_ops": _top((r.name, r.dur_ns) for r in dev),
                 "idle_gaps": _top(labels)}
    return Trace(ticks=len(ticks), window_ns=w1 - w0, busy_ns=busy_ns,
                 ops=[(r.name, r.kind, r.dur_ns) for r in dev],
                 breakdown=breakdown)
