"""The port's stage spans (``repro_torch.spans``).

Without a profiler ``span`` hands back one shared null context and no
profiler range is opened.  Under ``torch.profiler`` the five
stage names appear, nested as the calls nest: ``engine.reemit`` holds a
whole second emission (its pass 1 and its host reads), and every count
read of ``count()`` and ``pairs()`` is a ``host_read``.
"""
import contextlib

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import spans  # noqa: E402
from repro_torch.core.engine import MatchSpec, build_plan  # noqa: E402
from repro_torch.core.regions import Regions  # noqa: E402

FIVE = {"repro_torch.sbm.endpoint_sort", "repro_torch.sbm.pass1",
        "repro_torch.itm.build_tree", "repro_torch.engine.reemit",
        "repro_torch.host_read"}


def _regions(gen, n, length=1.0):
    lo = torch.rand(n, 1, generator=gen) * 100.0
    return Regions(lo, lo + length)


def _spans(prof):
    """``(name, start, end)`` of the port's spans, in start order."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith(spans.PREFIX)]
    return sorted(out, key=lambda s: s[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _raise(*args, **kwargs):
    raise AssertionError("a profiler range made with no profiler running")


def _no_ranges(monkeypatch):
    """Make every way of opening a profiler range raise."""
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _raise)


def test_span_without_a_profiler_is_the_shared_null_context(monkeypatch):
    _no_ranges(monkeypatch)
    a, b = spans.span("sbm.pass1"), spans.span("host_read")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        pass
    assert spans.host_read(torch.tensor(7, dtype=torch.int64)) == 7


@pytest.mark.parametrize("algo", ["sbm", "itm", "bfm", "gbm"])
def test_untraced_calls_never_open_a_profiler_range(algo, monkeypatch):
    _no_ranges(monkeypatch)
    gen = torch.Generator().manual_seed(3)
    S, U = _regions(gen, 300), _regions(gen, 200)
    plan = build_plan(MatchSpec(algo=algo, backend="cuda", device="cpu"),
                      300, 200, 1, key="untraced")
    k = plan.count(S, U)
    assert plan.pairs(S, U)[1] == k
    assert plan.pairs(S, _regions(gen, 200, 2.0))[1] >= 0


def test_host_read_is_int_inside_its_span():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = spans.host_read(torch.arange(5).sum())
    assert got == 10 and isinstance(got, int)
    assert [s[0] for s in _spans(prof)] == ["repro_torch.host_read"]


@pytest.mark.parametrize("capacity", ["exact", "grow"])
def test_the_five_spans_appear_nested_as_the_calls_nest(capacity):
    gen = torch.Generator().manual_seed(5)
    S, U = _regions(gen, 400), _regions(gen, 300)
    S2 = _regions(gen, 400, 4.0)          # K grows: both policies re-emit
    sbm = build_plan(MatchSpec(algo="sbm", backend="cuda", device="cpu",
                               capacity=capacity), 400, 300, 1,
                     key=("spans", capacity))
    itm = build_plan(MatchSpec(algo="itm", backend="cuda", device="cpu"),
                     400, 300, 1, key=("spans", capacity))
    sbm.pairs(S, U)                       # the capacity memoized
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sbm.count(S, U)
        sbm.pairs(S2, U)
        itm.count(S, U)
    got = _spans(prof)
    assert {s[0] for s in got} == FIVE
    by = {name: [s for s in got if s[0] == name] for name in FIVE}
    (reemit,) = by["repro_torch.engine.reemit"]
    # the first emission's pass 1 and its two reads lie before it; the
    # second emission's pass 1 and its two reads lie inside it
    p1 = by["repro_torch.sbm.pass1"]
    assert len(p1) == 2 and not _inside(p1[0], reemit)
    assert _inside(p1[1], reemit)
    reads_in = [s for s in by["repro_torch.host_read"]
                if _inside(s, reemit)]
    assert len(reads_in) == 2
    # count(): one lex-sort, one read; the itm count: one tree, one read
    (sort,) = by["repro_torch.sbm.endpoint_sort"]
    (tree,) = by["repro_torch.itm.build_tree"]
    assert len(by["repro_torch.host_read"]) == 1 + 4 + 1
    assert sort[2] <= p1[0][1] <= reemit[1] <= tree[1]
    # no stage holds another but the re-emit
    stages = [s for s in got if s[0] != "repro_torch.host_read"]
    for a in stages:
        for b in stages:
            if a is not b and _inside(a, b):
                assert b is reemit
