"""Steady-state pass: the guard, the grow-capacity bound and the live
probes — the eager counterpart of the JAX package's ``analysis/retrace.py``.

PyTorch runs eagerly, so nothing retraces.  What a retrace cost the JAX
package, new compiled code and a new buffer shape, shows in the port as
one of two events:

* a kernel library built or loaded (``kernels._build.load_log``);
* a plan resolving a capacity it has not resolved before for that buffer
  (``MatchPlan.new_capacities``): a new buffer shape, whose allocation
  and first use are what a steady state must not pay again.

``steady_state(*plans)`` counts both inside its block and raises
``SteadyStateError``, naming each plan with its new capacities and the
libraries, when the block added any.  The serving harness wraps its
steady-state ticks in it.

``audit_grow_bound`` holds a capacity resolver (pure host code) to the
``capacity="grow"`` contract: over ``adversarial_k_stream(max_k)`` (a
dense low ramp, a linear sweep, a geometric climb and a descending tail)
it may return at most ``grow_bound(max_k) = ceil(lg max_k) + 2`` distinct
capacities, else ``S_GROW_BOUND``.  ``audit_steady_probes`` runs the
``sbm`` and ``hsbm`` grow plans twice and the second pair of calls under
``steady_state``, else ``S_STEADY_STATE``.  The factories build fresh
``MatchPlan`` resolvers on the CPU: resolving touches no tensor.
"""
from __future__ import annotations

import contextlib
import math

from ..kernels import _build
from .report import Report


class SteadyStateError(AssertionError):
    """A guarded block built a library or resolved a new capacity."""


@contextlib.contextmanager
def steady_state(*plans):
    """Fail if a library is loaded, or one of ``plans`` resolves a new
    capacity, inside the block."""
    libs0 = len(_build.load_log)
    before = [(p, len(p.new_capacities)) for p in plans]
    yield
    detail = [f"{p!r} resolved new capacities "
              f"{list(p.new_capacities)[n0:]}"
              for p, n0 in before if len(p.new_capacities) > n0]
    libs = _build.load_log[libs0:]
    if libs:
        detail.append(f"kernel libraries built or loaded: {libs}")
    if detail:
        raise SteadyStateError("steady state broken: " + "; ".join(detail))


def grow_bound(max_k: int) -> int:
    """Permitted distinct capacities for a grow resolver up to ``max_k``."""
    return max(1, math.ceil(math.log2(max(max_k, 2)))) + 2


def adversarial_k_stream(max_k: int) -> list[int]:
    """Dense low ramp + linear sweep + geometric climb + descending tail.

    The linear sweep (256 evenly spaced K values) separates a doubling
    ladder (at most lg K distinct capacities) from any resolver whose
    capacity grows linearly in K, however coarsely quantized; the tail
    re-presents earlier Ks, so capacities that are not monotone surface
    as extra distinct values.  The reference's stream, value for value.
    """
    ks = list(range(1, min(max_k, 257) + 1))
    step = max(1, max_k // 256)
    ks.extend(range(step, max_k + 1, step))
    k = 256
    while k < max_k:
        k = min(k * 2 + k // 3, max_k)   # off-power-of-two growth
        ks.append(k)
    ks.extend(ks[::-3] or [1])           # descending tail (non-monotone K)
    return [min(max(k, 1), max_k) for k in ks]


def distinct_capacities(resolve, max_k: int) -> list[int]:
    """The capacities ``resolve`` returns over the adversarial stream,
    each once, in the order first returned."""
    caps: list[int] = []
    seen: set[int] = set()
    for k in adversarial_k_stream(max_k):
        cap = int(resolve(k))
        if cap not in seen:
            seen.add(cap)
            caps.append(cap)
    return caps


def audit_grow_bound(resolver_factory, *, max_k: int, target: str,
                     report: Report) -> None:
    """Check one capacity resolver against the O(lg K) bound.

    ``resolver_factory()`` returns a fresh stateful resolver
    ``f(exact_k) -> capacity`` (for the engine:
    ``MatchPlan(...)._resolve_cap``).  Every distinct capacity is a new
    buffer shape; past ``grow_bound`` a drifting K keeps allocating.
    """
    caps = distinct_capacities(resolver_factory(), max_k)
    bound = grow_bound(max_k)
    if len(caps) > bound:
        head = ", ".join(str(c) for c in caps[:12])
        more = f", … {len(caps) - 12} more" if len(caps) > 12 else ""
        report.add(
            "steady", "S_GROW_BOUND", target,
            f"{len(caps)} distinct capacities over a K-stream up to "
            f"{max_k} (bound: ceil(lg K) + 2 = {bound}); each one is a "
            f"new buffer shape — capacities: {head}{more}")
    report.note_audit("steady", f"{target} (max_k={max_k})")


def _grow_plan(backend: str = "cuda"):
    from ..core.engine import MatchPlan, MatchSpec
    spec = MatchSpec(capacity="grow", backend=backend, device="cpu")
    return MatchPlan(spec, 64, 64, 1)


# (target, factory of a fresh resolver): the engine's three grow
# resolvers, each bound to a new plan (``_resolve_cap_dev`` is the
# distributed backend's per-rank emit capacity)
RESOLVERS = (
    ("MatchPlan._resolve_cap[grow]", lambda: _grow_plan()._resolve_cap),
    ("MatchPlan._resolve_query_cap[grow]",
     lambda: _grow_plan()._resolve_query_cap),
    ("MatchPlan._resolve_cap_dev[grow]",
     lambda: _grow_plan("distributed")._resolve_cap_dev),
)


def audit_resolvers(report: Report, *, max_k: int = 1 << 20) -> None:
    """The three grow resolvers of the engine against the bound."""
    for target, factory in RESOLVERS:
        audit_grow_bound(factory, max_k=max_k, target=target,
                         report=report)


def probe_steady(report: Report, target: str, plan, call) -> None:
    """``call()`` once, then again under ``steady_state(plan)``; a broken
    steady state is ``S_STEADY_STATE``."""
    call()
    try:
        with steady_state(plan):
            call()
    except SteadyStateError as e:
        report.add("steady", "S_STEADY_STATE", target, str(e))
    report.note_audit("steady", target)


def audit_steady_probes(report: Report, S, U, *, device: str) -> None:
    """Live probe: the ``sbm`` and ``hsbm`` grow plans on ``device``,
    ``count()`` and ``pairs()`` called once, then again under
    ``steady_state``."""
    from ..core.engine import MatchPlan, MatchSpec
    for algo in ("sbm", "hsbm"):
        plan = MatchPlan(MatchSpec(algo=algo, capacity="grow",
                                   device=device), S.n, U.n, S.d)

        def call(plan=plan):
            plan.count(S, U)
            plan.pairs(S, U)
        probe_steady(report, f"{algo}/cuda/grow steady state on {device}",
                     plan, call)
