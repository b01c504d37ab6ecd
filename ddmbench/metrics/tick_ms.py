"""Mean tick: the window's seconds x 1000 over the ticks completed in it.
A tick is the move batch written, then the match, ending in its host
read."""
UNIT = "ms"


def read(win):
    return 1000.0 * win.window_s / len(win.tick_s)
