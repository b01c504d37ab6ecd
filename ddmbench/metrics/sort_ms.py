"""Device ms a tick in sort kernels: the endpoint lex-sort and pass 1's
stable argsorts (``core/sbm.py``), ``build_tree``'s argsort
(``core/itm.py``) and K8's query order (``kernels/itm.py``), all library
radix sorts.  The group is the sort kernels by name (cub's
``DeviceRadixSort*``, torch's in-place ``radixSortKVInPlace``,
``bitonicSort*`` and ``sortKeyValueInplace``), which ``searchsorted``
and the gathers around the sorts are not."""
LAYER = "SBM and ITM plain torch"
UNIT = "ms"
MOVES = "tick_ms"
KERNELS = ("radixsort", "bitonicsort", "sortkeyvalue")


def read(win):
    tr = win.trace
    if tr is None:
        return None
    launches, ns = tr.stage(KERNELS)
    if not launches:
        win.note(f"sort_ms: no kernel named like {KERNELS} in the trace")
        return None
    return ns / 1e6 / tr.ticks
