"""Device ms a tick of the endpoint lex-sort: every device operation
launched inside the port's ``repro_torch.sbm.endpoint_sort`` span
(``core/sbm.py`` ``_endpoint_stream``: the flat endpoint stream, its two
stable argsorts and the gathers), over the traced ticks."""
LAYER = "SBM and ITM plain torch"
UNIT = "ms"
MOVES = "tick_ms"
SPAN = "sbm.endpoint_sort"


def read(win):
    tr = win.trace
    if tr is None:
        return None
    launches, ns = tr.within(SPAN)
    if not launches:
        win.note(f"lexsort_ms: nothing launched inside a repro_torch.{SPAN} "
                 "span in the trace")
        return None
    return ns / 1e6 / tr.ticks
