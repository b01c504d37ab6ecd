"""Region sets for the hybrid (hsbm) tests, shared by the CPU parity tests
and the card tests (numpy only, no JAX), and the hybrid's pair relation by
brute force."""
import numpy as np


def blowup():
    """The reference's ``test_hsbm_geometry_blowup_guard`` inputs: one
    hot cell and a far outlier."""
    rng = np.random.default_rng(5)
    lo = np.concatenate([rng.uniform(0.0, 1.0, 4000),
                         np.array([1e6])]).astype(np.float32)[:, None]
    hi = lo + np.float32(0.5)
    return lo, hi, lo.copy(), hi.copy()


def edges(nc=16, per_edge=3):
    """Regions whose lows sit on and one float32 ulp around every cell
    edge of a 16-cell grid over [0, 1000): ``lb`` = 0 and the top = 1000
    come from anchor regions, so the edges are ``c * f32(width)``."""
    width = np.float32(1000.0 / nc * (1 + 1e-6))
    lows = []
    for c in range(1, nc):
        e = np.float32(c) * width
        lows += [np.nextafter(e, np.float32(0)), e,
                 np.nextafter(e, np.float32(2000))][:per_edge]
    lows = np.asarray(lows, np.float32)
    s_lo = np.concatenate([[0.0], lows, [990.0]]).astype(np.float32)
    u_lo = np.concatenate([[0.0], lows[::-1] - np.float32(2.5), [995.0]]
                          ).astype(np.float32)
    return (s_lo[:, None], (s_lo + 5)[:, None],
            u_lo[:, None], (u_lo + 5)[:, None])


def zero_width(n=3000, m=2500, seed=0):
    """Integer endpoints with many ties, widths 0..19: about one region
    in 20 has lo == hi."""
    rng = np.random.default_rng(seed)
    s_lo = rng.integers(0, 500, n).astype(np.float32)
    s_hi = s_lo + rng.integers(0, 20, n).astype(np.float32)
    u_lo = rng.integers(0, 500, m).astype(np.float32)
    u_hi = u_lo + rng.integers(0, 20, m).astype(np.float32)
    return s_lo[:, None], s_hi[:, None], u_lo[:, None], u_hi[:, None]


def hybrid_relation(s_lo, s_hi, u_lo, u_hi):
    """(n, m) bool: the pairs the hybrid's pass 1 counts on 1-D bounds.

    Class A: ``u.lo`` in ``[s.lo, s.hi)``; class B: ``u.lo < s.lo <
    u.hi``.  On non-empty intervals this is the overlap relation
    ``s.lo < u.hi and u.lo < s.hi``.  A zero-width U region at ``s.lo``
    of a non-empty S region is in class A and does not overlap it."""
    s_lo, s_hi = s_lo[:, None], s_hi[:, None]
    a = (u_lo[None] >= s_lo) & (u_lo[None] < s_hi)
    b = (u_lo[None] < s_lo) & (s_lo < u_hi[None])
    return a | b


def overlap_relation(s_lo, s_hi, u_lo, u_hi):
    """(n, m) bool: ``s.lo < u.hi and u.lo < s.hi`` (the brute mask)."""
    return ((s_lo[:, None] < u_hi[None]) & (u_lo[None] < s_hi[:, None]))
