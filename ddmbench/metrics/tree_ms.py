"""Device ms a tick of ``build_tree``: every device operation launched
inside the port's ``repro_torch.itm.build_tree`` span (``core/itm.py``:
the argsort, the gathers, the max/min levels), over the traced ticks."""
LAYER = "SBM and ITM plain torch"
UNIT = "ms"
MOVES = "tick_ms"
SPAN = "itm.build_tree"


def read(win):
    tr = win.trace
    if tr is None:
        return None
    launches, ns = tr.within(SPAN)
    if not launches:
        win.note(f"tree_ms: nothing launched inside a repro_torch.{SPAN} "
                 "span in the trace")
        return None
    return ns / 1e6 / tr.ticks
