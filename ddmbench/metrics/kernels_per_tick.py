"""Device kernels launched a tick, every kernel in the trace's window
over its ticks: the wrappers' launches (``kernels/ops.py``,
``kernels/itm.py``, ``_build.launch``) and the library kernels around
them."""
LAYER = "kernel wrappers"
UNIT = "count"
MOVES = "tick_ms"


def read(win):
    tr = win.trace
    if tr is None:
        return None
    if not tr.kernels:
        win.note("kernels_per_tick: the trace holds no kernel")
        return None
    return len(tr.kernels) / tr.ticks
