"""The inputs a generator makes: host arrays, handed to the program and
to the reference alike."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Workload:
    """``n`` subscription and ``m`` update regions, ``(count, d)`` float32
    host arrays of half-open extents ``[lo, hi)``; ``meta`` holds what a
    move model needs of the generator (the domain, the lengths)."""

    s_lo: np.ndarray
    s_hi: np.ndarray
    u_lo: np.ndarray
    u_hi: np.ndarray
    meta: dict

    @property
    def n(self) -> int:
        return self.s_lo.shape[0]

    @property
    def m(self) -> int:
        return self.u_lo.shape[0]

    @property
    def d(self) -> int:
        return self.s_lo.shape[1]
