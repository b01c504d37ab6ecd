"""Device ms a tick of the second emission: every device operation
launched inside the port's ``repro_torch.engine.reemit`` span
(``core/engine.py`` ``MatchPlan.pairs``, which emits once more under
``exact`` when K differs from the memoized capacity and under ``grow``
when K passes the cap), over the traced ticks.  A window with no such
span reads 0: a tick that emits once re-emits nothing."""
LAYER = "engine"
UNIT = "ms"
MOVES = "tick_ms"
SPAN = "engine.reemit"


def read(win):
    tr = win.trace
    if tr is None:
        return None
    if not tr.ops:
        win.note("reemit_ms: the trace holds no device operation")
        return None
    spans, _ = tr.spans_of(SPAN)
    launches, ns = tr.within(SPAN)
    if spans and not launches:
        win.note(f"reemit_ms: {spans} repro_torch.{SPAN} spans launched "
                 "nothing in the trace")
        return None
    return ns / 1e6 / tr.ticks
