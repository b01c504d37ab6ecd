"""One run of a cell: set-up, the window of ticks, and the judging after it.

Set-up makes the regions from the seed (the configuration's generator,
on the host), puts them in the region store on the device, builds the
plan (``repro_torch.core.engine.build_plan``), makes the pool of move
batches on the device from the seed, and runs the warm-up ticks.

A tick is the RTI's: the next move batch written into the store (harness
code: the RTI's region store), then the traffic's operation on the plan,
ending in its host read.  The previous tick's answer is dropped before
the next tick starts.  Ticks run back to back, one caller, a closed loop.

Judging: ticks drawn from the seed among the first ``check_span`` of the
untraced window, and the window's last tick, are summarized as they
finish (the clock stands still meanwhile, so that neither the window nor
the tick times count it); after the window the plain reference replays
the moves from the generated regions and computes each checked tick's
answer again, and the store is compared with the replayed state.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from ddmbench.layout import Cell, load_plugin

TRACE_SKIP = 2   # traced ticks left out of the trace's window


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one stream of draws, from the run's seed."""
    return int(np.random.SeedSequence([seed, stream]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


class Store:
    """The RTI's region store: ``(count, d)`` float32 device tensors."""

    def __init__(self, work, device):
        # a copy on every device: the generated arrays stay as made, for
        # the reference's replay
        self.s_lo, self.s_hi, self.u_lo, self.u_hi = (
            torch.tensor(a, device=device)
            for a in (work.s_lo, work.s_hi, work.u_lo, work.u_hi))

    def tensors(self):
        return self.s_lo, self.s_hi, self.u_lo, self.u_hi


def _nospan(name):
    return contextlib.nullcontext()


@dataclasses.dataclass
class Window:
    """What a run measured: what the metric readers read."""

    n: int
    m: int
    setup_s: float
    tick_s: list          # every timed tick's host-clock seconds
    window_s: float       # the window's seconds, checks left out
    ks: list              # K of every tick the metrics read
    peak_bytes: int = 0
    trace: object = None  # trace.Trace of a --trace 1 run
    notes: list = dataclasses.field(default_factory=list)

    def note(self, msg: str) -> None:
        self.notes.append(msg)


class Session:
    def __init__(self, cell: Cell, seed: int, device: torch.device):
        from repro_torch.core.engine import MatchSpec, build_plan
        from repro_torch.core.regions import Regions

        cfg, trf = cell.config, cell.traffic
        self.cell, self.device = cell, device
        self.work = load_plugin("generators", cfg["generator"]).make(
            cfg["params"], seed)
        self.store = Store(self.work, device)
        self.S = Regions(self.store.s_lo, self.store.s_hi)
        self.U = Regions(self.store.u_lo, self.store.u_hi)
        spec = MatchSpec(**cfg["spec"], device=device.type)
        self.plan = build_plan(spec, self.work.n, self.work.m, self.work.d,
                               key=("ddmbench", cell.name, seed))
        self.moves = load_plugin("moves", trf["moves"]["model"])
        self.pool = self.moves.make_pool(self.work, trf["moves"],
                                         sub_seed(seed, 1), device)
        self.op = load_plugin("operations", trf["operation"])
        self.t = 0                       # the next tick's move batch
        rng = np.random.default_rng(sub_seed(seed, 2))
        span = int(trf["check_span"])
        self.check_rel = set(rng.choice(span, min(int(trf["check_ticks"]),
                                                  span), replace=False)
                             .tolist())
        self.summaries: dict[int, dict] = {}

    def tick(self, span=_nospan):
        with span("ddmbench.move"):
            self.moves.apply(self.store, self.pool, self.t)
        self.t += 1
        with span("ddmbench.match"):
            return self.op.call(self.plan, self.S, self.U)

    def warm_up(self) -> None:
        for _ in range(int(self.cell.traffic["warmup_ticks"])):
            self.tick()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _summarize(self, t: int, res) -> float:
        a = time.perf_counter()
        self.summaries[t] = self.op.summarize(res, self.store)
        return time.perf_counter() - a

    def timed(self, seconds: float):
        """Ticks back to back until ``seconds`` of window have passed:
        ``(tick seconds, window seconds, Ks, the last (t, answer))``."""
        times, ks = [], []
        paused = 0.0
        last = None
        start = time.perf_counter()
        i = 0
        while True:                      # at least one tick
            last = None                  # the RTI has consumed it
            t = self.t
            a = time.perf_counter()
            res = self.tick()
            end = time.perf_counter()
            times.append(end - a)
            ks.append(self.op.k_of(res))
            if i in self.check_rel:
                paused += self._summarize(t, res)
            last = (t, res)
            del res
            i += 1
            if time.perf_counter() - start - paused >= seconds:
                break
        return times, end - start - paused, ks, last

    def traced(self, seconds: float):
        """Ticks under ``torch.profiler`` for ``seconds``, spans on:
        ``(profile, Ks of the ticks the trace's window keeps)``."""
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        ks = []
        with profile(activities=acts) as prof:
            start = time.perf_counter()
            i = 0
            while i < TRACE_SKIP + 1 or time.perf_counter() - start < seconds:
                with record_function("ddmbench.tick"):
                    res = self.tick(record_function)
                if i >= TRACE_SKIP:
                    ks.append(self.op.k_of(res))
                del res
                i += 1
        return prof, ks

    def keep_last(self, last) -> int:
        """Summarize the window's last tick, if not yet; its index."""
        t_last, res = last
        if t_last not in self.summaries:
            self._summarize(t_last, res)
        return t_last

    def judge(self, t_last: int) -> tuple[dict, int, list]:
        """Replay the moves to ``t_last`` and compare every summarized
        tick with the reference: ``({check: worst value}, ticks that
        failed, regions whose extent changed at each replayed tick)``."""
        limits = dict(self.op.LIMITS, state_gap=0)
        worst = {name: 0 for name in limits}
        failed = 0
        ref = Store(self.work, self.device)
        changed = []
        for t in range(t_last + 1):
            before = [x.clone() for x in ref.tensors()]
            self.moves.apply(ref, self.pool, t)
            changed.append(sum(
                ((lo != lo0) | (hi != hi0)).any(dim=1).sum()
                for lo, hi, lo0, hi0 in ((ref.s_lo, ref.s_hi, *before[:2]),
                                         (ref.u_lo, ref.u_hi, *before[2:]))))
            if t in self.summaries:
                gaps = self.op.compare(self.summaries[t],
                                       self.op.expected(ref))
                failed += any(v > limits[k] for k, v in gaps.items())
                for k, v in gaps.items():
                    worst[k] = max(worst[k], v)
        worst["state_gap"] = sum(int((a != b).sum()) for a, b in
                                 zip(self.store.tensors(), ref.tensors()))
        return worst, failed, torch.stack(changed).tolist()


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t0: float):
    """One run: ``(Window, checks {name: (value, limit)}, ticks attempted,
    ticks failed, info lines)``."""
    from ddmbench import trace as tr

    ses = Session(cell, seed, device)
    ses.warm_up()
    setup_s = time.perf_counter() - t0
    info = []
    if trace:
        traced_s = min(float(cell.traffic["trace_seconds"]), seconds)
        prof, ks = ses.traced(traced_s)
        times, _, _, last = ses.timed(max(seconds - traced_s, 0.0))
        attempted = len(ks) + TRACE_SKIP + len(times)
        win = Window(ses.work.n, ses.work.m, setup_s, [], 0.0, ks)
    else:
        times, window_s, ks, last = ses.timed(seconds)
        attempted = len(times)
        win = Window(ses.work.n, ses.work.m, setup_s, times, window_s, ks)
    if device.type == "cuda":
        win.peak_bytes = int(torch.cuda.max_memory_allocated(device))
    t_last = ses.keep_last(last)
    del last                             # the last answer, judged
    t_judge = time.perf_counter()
    worst, failed, changed = ses.judge(t_last)
    info.append(f"the reference's replay and checks took "
                f"{time.perf_counter() - t_judge!r} s")
    info.append(f"regions whose extent changed a tick, over the "
                f"{len(changed)} ticks replayed: least {min(changed)}, "
                f"mean {sum(changed) / len(changed)!r}, most {max(changed)}")
    limits = dict(ses.op.LIMITS, state_gap=0)
    checks = {k: (worst[k], limits[k]) for k in limits}
    info.append(f"ticks checked against the reference: "
                f"{sorted(ses.summaries)} of {ses.t} (warm-up "
                f"{cell.traffic['warmup_ticks']})")
    if trace:
        t_read = time.perf_counter()
        win.trace = tr.reduce(tr.records(prof), TRACE_SKIP)
        info.append(f"trace read in {time.perf_counter() - t_read!r} s")
        if win.trace is not None:
            info.append(f"device ops with no launch call: "
                        f"{len(win.trace.unmatched)} of {len(win.trace.ops)}")
    info.extend(_program_lines(ses))
    return win, checks, attempted, failed, info


def _program_lines(ses: Session) -> list[str]:
    """What the program's own counters say about the run."""
    from repro_torch.kernels import itm as k8, ops
    lines = [f"emit route of the last pairs() call: {ops.last_emit_route()}",
             f"plan capacities resolved for the first time: "
             f"{len(ses.plan.new_capacities)}",
             f"K8 launches: {k8.itm_walk.launches} "
             f"(CTA regime {k8.itm_walk.cta_launches})"]
    return lines
