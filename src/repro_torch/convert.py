"""Carry DDM state between the JAX package and the port.

DDM has no weights: its state is the region sets (and the interval
trees built on them), and its result is a pair buffer.  These helpers
take the JAX package's region arrays and trees as numpy (what
``np.asarray`` gives for a ``repro`` region batch or ``ITree`` field)
into the port, and bring port state and results back to numpy, so one
seed's data can go through both packages and the outputs can be compared
bit for bit.
"""
from __future__ import annotations

import numpy as np

import torch

from .core.itm import ITree
from .core.pairs import PairsResult, to_numpy
from .core.regions import Regions, make_regions, resolve_device


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


def itree_from_numpy(lo, hi, minlower, maxupper, ids,
                     device="cuda") -> ITree:
    """Port ``ITree`` from the five arrays of an interval tree (the JAX
    package's ``ITree`` fields as numpy, in that order): float32 bounds
    and int32 ids, each of length 2^h."""
    dev = resolve_device(device)
    f32 = [torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)
           for a in (lo, hi, minlower, maxupper)]
    return ITree(*f32, torch.from_numpy(np.array(ids, dtype=np.int32))
                 .to(dev))


def itree_to_numpy(tree: ITree) -> tuple[np.ndarray, ...]:
    """The five arrays of a port ``ITree`` as host numpy, field order."""
    return tuple(to_numpy(t) for t in tree)
