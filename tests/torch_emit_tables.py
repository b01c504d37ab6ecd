"""Hand-made pass-1 tables for the K2/K5 tests (numpy only, no JAX)."""
import numpy as np


def zero_run_tables(seed, E=9000, n=4000, T=2048):
    """Counts, starts and permutations of E = n + m emitters with runs of
    zero-count emitters at the first emitter, inside a tile, at offsets T
    (a tile's first slot) and 2T - 1 (a tile's last slot), and trailing
    before the sentinel.  Returns int32 (counts, starts, perm_s, perm_u)
    and K."""
    rng = np.random.default_rng(seed)
    m = E - n
    counts = rng.integers(0, 4, E)
    counts[rng.random(E) < 0.5] = 0
    counts[:5] = 0                              # run at the first emitter
    counts[-40:] = 0                            # trailing before E
    counts[3000:3600] = 0                       # a run inside a tile
    # the emitter crossing slot `at` ends there; a run follows it
    for at in (T, 2 * T - 1):
        c = np.cumsum(counts)
        e = int(np.searchsorted(c, at))
        counts[e] -= c[e] - at
        counts[e + 1:e + 31] = 0
    starts = np.where(np.arange(E) < n,
                      rng.integers(0, m - counts.clip(max=m) + 1),
                      rng.integers(0, n - counts.clip(max=n) + 1))
    return (counts.astype(np.int32), starts.astype(np.int32),
            rng.permutation(n).astype(np.int32),
            rng.permutation(m).astype(np.int32), int(counts.sum()))
