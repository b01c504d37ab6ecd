"""Steady-state guard: the eager counterpart of the JAX package's
``analysis.retrace.no_retrace``.

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
"""
from __future__ import annotations

import contextlib

from ..kernels import _build


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
