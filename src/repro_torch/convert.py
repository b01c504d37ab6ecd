"""Carry DDM state between the JAX package and the port.

DDM has no weights: its state is the region sets, and its result is a
pair buffer.  These helpers take the JAX package's region arrays as
numpy (what ``np.asarray`` gives for a ``repro`` region batch) into the
port, and bring a port result back to numpy, so one seed's data can go
through both packages and the outputs can be compared bit for bit.
"""
from __future__ import annotations

import numpy as np

from .core.pairs import PairsResult, to_numpy
from .core.regions import Regions, make_regions


def regions_from_numpy(lo, hi, device="cuda") -> Regions:
    """Port regions from ``(N, d)`` (or ``(N,)``) float32 numpy arrays."""
    return make_regions(np.asarray(lo, np.float32),
                        np.asarray(hi, np.float32), device)


def regions_to_numpy(R: Regions) -> tuple[np.ndarray, np.ndarray]:
    """``(lo, hi)`` as host float32 ``(N, d)`` arrays."""
    return to_numpy(R.lo), to_numpy(R.hi)


def pairs_to_numpy(result) -> np.ndarray:
    """Host int32 ``(cap, 2)`` buffer of a ``PairsResult`` or tensor."""
    if isinstance(result, PairsResult):
        return np.asarray(result)
    return to_numpy(result)
