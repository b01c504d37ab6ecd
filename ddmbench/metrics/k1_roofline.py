"""The K1 sweep stage's share of its roofline: the least time of the
sweep's work (``roofline.sweep_work``: 12 bytes an endpoint) over the
device time of the stage's kernels, a tick."""
from ddmbench import roofline

LAYER = "kernels"
UNIT = "%"
MOVES = "tick_ms"
KERNELS = ("sbm_sweep_kernel",)


def read(win):
    tr = win.trace
    if tr is None:
        return None
    launches, ns = tr.stage(KERNELS)
    if not launches:
        win.note(f"k1_roofline: no kernel named like {KERNELS} in the trace")
        return None
    return roofline.share(roofline.sweep_work(win.n, win.m),
                          ns / 1e9 / tr.ticks)
