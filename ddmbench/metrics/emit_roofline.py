"""The pass-2 emit stage's share of its roofline: the least time of one
exact enumeration's writes and reads (``roofline.emit_work`` at the
traced ticks' mean K) over the device time of the stage's kernels (K2,
K5 or K6, whichever route runs, every launch), a tick."""
from ddmbench import roofline

LAYER = "kernels"
UNIT = "%"
MOVES = "tick_ms"
KERNELS = ("emit_tiles_kernel", "csr_decode_kernel")


def read(win):
    tr = win.trace
    if tr is None:
        return None
    launches, ns = tr.stage(KERNELS)
    if not launches:
        win.note(f"emit_roofline: no kernel named like {KERNELS} in the "
                 "trace")
        return None
    k = sum(win.ks) / len(win.ks)
    return roofline.share(roofline.emit_work(win.n, win.m, k),
                          ns / 1e9 / tr.ticks)
