"""Idle ms a tick inside the port's stages: the gaps with no device
operation running whose midpoint lies in one of the port's
``repro_torch.*`` spans, over the traced ticks.  The rest of
``idle_share`` lies in the harness's own code (the moves, the tick's
glue) and in the port's code that no span marks."""
LAYER = "device"
UNIT = "ms"
MOVES = "tick_ms"


def read(win):
    tr = win.trace
    if tr is None or not tr.ops:
        win.note("stage_idle_ms: the trace holds no device operation")
        return None
    return tr.idle_in_program_ns() / 1e6 / tr.ticks
