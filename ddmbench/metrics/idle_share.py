"""The share of the trace's window in which no operation ran on the
device: 100 x (1 - busy / window)."""
LAYER = "device"
UNIT = "%"
MOVES = "tick_ms"


def read(win):
    tr = win.trace
    if tr is None or not tr.busy_ns:
        win.note("idle_share: the trace holds no device operation")
        return None
    return 100.0 * (1.0 - tr.busy_ns / tr.window_ns)
