"""Host reads a tick: the port's ``repro_torch.host_read`` spans (each a
count copied to the host, which waits for the device) over the traced
ticks; 0 where the window holds none."""
LAYER = "engine"
UNIT = "count"
MOVES = "tick_ms"


def read(win):
    tr = win.trace
    if tr is None:
        return None
    reads, _ = tr.spans_of("host_read")
    return reads / tr.ticks
