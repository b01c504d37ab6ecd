"""The paper's synthetic workload (section 5, after Raczy et al.).

``n_total = N`` regions split into ``n = N // 2`` subscriptions and
``m = N - n`` updates, each of length ``l = alpha * L / N``, placed
uniformly at random on a segment of length ``L = space``; ``alpha`` is the
overlapping degree.  A copy of ``repro_torch.core.regions.paper_workload``'s
draws (the same ``np.random.default_rng`` calls in the same order, so the
same seed gives bit-equal arrays), kept here so that the yardstick does
not move with the program.
"""
from __future__ import annotations

import numpy as np

from ddmbench.workload import Workload


def make(params: dict, seed: int) -> Workload:
    n_total = int(params["n_total"])
    alpha = float(params["alpha"])
    space = float(params.get("space", 1.0e6))
    d = int(params.get("d", 1))
    n = n_total // 2
    m = n_total - n
    length = alpha * space / n_total
    rng = np.random.default_rng(seed)

    def gen(count):
        lo = rng.uniform(0.0, space - length,
                         size=(count, d)).astype(np.float32)
        # non-empty at float32: lo + length can round back onto lo
        hi = (lo.astype(np.float64) + length).astype(np.float32)
        hi = np.maximum(hi, np.nextafter(lo, np.float32(np.inf)))
        return lo, hi

    s_lo, s_hi = gen(n)
    u_lo, u_hi = gen(m)
    return Workload(s_lo, s_hi, u_lo, u_hi,
                    meta={"space": space, "length": length})
