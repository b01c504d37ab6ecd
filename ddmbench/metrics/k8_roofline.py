"""The ITM walk stage's share of its roofline: the least time of the
count walk's work (``roofline.walk_work``: the tree's and the queries'
bounds, and 3 operations a hit at the traced ticks' mean K) over the
device time of K8's kernels, a tick.  ``count()`` builds the tree on the
subscriptions and queries every update."""
from ddmbench import roofline

LAYER = "kernels"
UNIT = "%"
MOVES = "tick_ms"
KERNELS = ("walk_per_thread", "walk_per_cta")


def read(win):
    tr = win.trace
    if tr is None:
        return None
    launches, ns = tr.stage(KERNELS)
    if not launches:
        win.note(f"k8_roofline: no kernel named like {KERNELS} in the trace")
        return None
    k = sum(win.ks) / len(win.ks)
    return roofline.share(roofline.walk_work(win.n, win.m, k),
                          ns / 1e9 / tr.ticks)
