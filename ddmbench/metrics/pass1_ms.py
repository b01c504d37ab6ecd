"""Device ms a tick of pass 1 of the two-pass emit: every device
operation launched inside the port's ``repro_torch.sbm.pass1`` span
(``core/sbm.py`` ``_twopass_phase1``: argsorts, gathers, four
``searchsorted``, the offset scan), both emissions of an ``exact`` tick
counted, over the traced ticks."""
LAYER = "SBM and ITM plain torch"
UNIT = "ms"
MOVES = "tick_ms"
SPAN = "sbm.pass1"


def read(win):
    tr = win.trace
    if tr is None:
        return None
    launches, ns = tr.within(SPAN)
    if not launches:
        win.note(f"pass1_ms: nothing launched inside a repro_torch.{SPAN} "
                 "span in the trace")
        return None
    return ns / 1e6 / tr.ticks
