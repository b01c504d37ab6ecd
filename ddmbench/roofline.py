"""The yardstick of the kernel stages: the card's published peaks, and the
work each stage's data needs, counted from the cell's data alone.

A stage's roofline share is the least time its work could take on the
card, the larger of its bytes over the memory bandwidth and its
operations over the 32-bit operation rate, over the device time its
kernels took.  Each input byte is counted read once and each output byte
written once, whatever the kernels read again, so the share reads the
same work whatever implements the stage.

Peaks: NVIDIA H100 SXM5 data sheet, 80 GB HBM3 at 3.35 TB/s, 67 TFLOP/s
FP32 outside the tensor cores (counted here as 32-bit operations a
second), at the full 700 W; the run prints the card's power limit.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
OPS32_PER_S = 67e12


def least_seconds(nbytes: float = 0.0, ops: float = 0.0) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / OPS32_PER_S)


def sweep_work(n: int, m: int) -> dict:
    """The counting sweep over the lex-sorted endpoint stream (K1): for
    each of the ``2 (n + m)`` endpoints, its two int32 flags (lower or
    upper, subscription or update) read and its int32 report count
    written."""
    t = 2 * (n + m)
    return {"bytes": 12 * t, "ops": 0}


def emit_work(n: int, m: int, k: float) -> dict:
    """Pass 2 of the exact enumeration (K2, K5 or K6): the ``K`` pairs of
    two int32 ids written, and for each of the ``n + m`` emitters its
    partner permutation entry, first partner rank and count (int32 each)
    read."""
    return {"bytes": 8 * k + 12 * (n + m), "ops": 0}


def walk_work(n_tree: int, n_query: int, k: float) -> dict:
    """The interval tree walk's count (K8): the ``n_tree`` indexed
    intervals' float32 bounds and the ``n_query`` queries' bounds read,
    an int32 count a query written; and for each of the ``K`` hits its
    two bound comparisons and one add."""
    return {"bytes": 8 * n_tree + 8 * n_query + 4 * n_query, "ops": 3 * k}


def share(work: dict, device_seconds: float) -> float:
    """Percent of the roofline: least time over measured device time."""
    return 100.0 * least_seconds(work["bytes"], work["ops"]) / device_seconds
