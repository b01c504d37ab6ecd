"""Pass-2 emits a tick: launches of the emit stage's kernels (K2, K5 or
K6) over the traced ticks.  Under the ``exact`` capacity policy
(``core/engine.py``) a tick whose K differs from the last one emits at
the old capacity and once more at the new one."""
LAYER = "engine"
UNIT = "count"
MOVES = "tick_ms"
KERNELS = ("emit_tiles_kernel", "csr_decode_kernel")


def read(win):
    tr = win.trace
    if tr is None:
        return None
    launches, _ = tr.stage(KERNELS)
    if not launches:
        win.note(f"pass2_per_tick: no kernel named like {KERNELS} in the "
                 "trace (the xla route runs no emit kernel)")
        return None
    return launches / tr.ticks
