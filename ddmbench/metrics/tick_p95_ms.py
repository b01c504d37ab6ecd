"""The 95th percentile (nearest rank) of every tick's host-clock latency
in the window: each tick its own sample, none merged."""
import math

UNIT = "ms"


def read(win):
    t = sorted(win.tick_s)
    return 1000.0 * t[math.ceil(0.95 * len(t)) - 1]
