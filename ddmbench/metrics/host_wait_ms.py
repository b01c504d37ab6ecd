"""Host ms a tick inside the port's ``repro_torch.host_read`` spans: the
time the host waits for the device to finish the work a count read
depends on, and the copy; 0 where the window holds no read."""
LAYER = "engine"
UNIT = "ms"
MOVES = "tick_ms"


def read(win):
    tr = win.trace
    if tr is None:
        return None
    _, ns = tr.spans_of("host_read")
    return ns / 1e6 / tr.ticks
