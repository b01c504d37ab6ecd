"""Named ranges of the port's stages, on the profiler's clock.

``span(name)`` is a profiler range named ``repro_torch.<name>`` while a
profiler runs, and one shared null context otherwise, so an untraced
call pays one check and records nothing.  The ranges land in the same
trace as the device operations they launch; nesting on the launching
thread is their parentage.  A range is a function-scope record
(``torch._C._profiler._RecordFunctionFast``, a ``cpu_op`` in the trace),
not a ``record_function`` user annotation: the profiler mirrors a user
annotation on the device's timeline, and where a torch build gives its
events no activity type (torch 2.11) that mirror reads as one more
kernel.  It is also the cheaper of the two under a profiler.  The stages
so marked:

* ``repro_torch.sbm.endpoint_sort``: the endpoint stream's lex-sort
  (``core/sbm.py`` ``_endpoint_stream``);
* ``repro_torch.sbm.pass1``: the two-pass emit's counting pass
  (``core/sbm.py`` ``_twopass_phase1``);
* ``repro_torch.itm.build_tree``: the interval tree's construction
  (``core/itm.py`` ``build_tree``);
* ``repro_torch.engine.reemit``: a ``pairs()`` emission run again at a
  new capacity (``core/engine.py``);
* ``repro_torch.host_read``: a count read to the host (``host_read``),
  which waits for the work queued before it.
"""
from __future__ import annotations

import contextlib

import torch

PREFIX = "repro_torch."
_OFF = contextlib.nullcontext()


def span(name: str):
    """A range named ``repro_torch.<name>`` while a profiler runs."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(PREFIX + name)
    return _OFF


def host_read(t: torch.Tensor) -> int:
    """``int(t)`` of a one-element tensor, inside ``span("host_read")``."""
    with span("host_read"):
        return int(t)
