"""Request batching: queued box queries coalesced into batched
``MatchPlan.query`` calls (the port's copy of the JAX package's
``serve/batching.py``).

Every device call is padded to exactly ``BatchPolicy.max_batch`` rows
with sentinel boxes (``lo=+inf, hi=-inf``), so one tenant's query
buffers keep one shape whatever the queue depth.  On the card the walk
is K8 (``kernels/itm.py``): a sentinel sorts last in its query order
(the argsort by lo) and the tree's root prunes it (``maxupper <= lo``),
so a pad row costs one lane and returns no hit.

Coalescing policy: a batch launches when it is full (``max_batch``
requests of one (tenant, target) stream) or when the oldest queued
request has waited ``max_delay_s``, the usual max-batch/max-delay trade
between throughput and tail latency.  Batch occupancy
(filled/max_batch) is recorded per launch so the trade is observable.
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import Future

import numpy as np

from ..core.pairs import to_numpy

TARGETS = ("sub", "upd")


@dataclasses.dataclass(frozen=True)
class BatchPolicy:
    """Knobs for the coalescing loop."""

    max_batch: int = 256      # device-call batch rows (also the pad size)
    max_delay_s: float = 2e-3  # oldest-request age that forces a launch

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_delay_s < 0:
            raise ValueError(
                f"max_delay_s must be >= 0, got {self.max_delay_s}")


@dataclasses.dataclass
class QueryRequest:
    """One queued box query against a tenant's ``target`` region set."""

    tenant: str
    target: str               # "sub" | "upd" — the set being searched
    lo: np.ndarray            # (d,)
    hi: np.ndarray            # (d,)
    future: Future
    t_submit: float


@dataclasses.dataclass(frozen=True)
class QueryResult:
    """What a completed query future resolves to."""

    ids: np.ndarray           # (k,) int32 region ids, overlap-verified
    version: int              # snapshot version the answer was read from
    staleness: int            # store_version - snapshot version at launch
    latency_s: float          # submit → resolution wall time

    def id_set(self) -> set[int]:
        return set(self.ids.astype(int).tolist())


def pad_boxes(reqs: list[QueryRequest], d: int,
              max_batch: int) -> tuple[np.ndarray, np.ndarray]:
    """(max_batch, d) query boxes, sentinel-padded to a fixed shape.

    The sentinel (``lo=+inf, hi=-inf``) makes the interval-tree root
    prune immediately (``maxupper <= q_lo``), so pad rows return zero
    hits without a dedicated masking path.
    """
    lo = np.full((max_batch, d), np.inf, np.float32)
    hi = np.full((max_batch, d), -np.inf, np.float32)
    for i, r in enumerate(reqs):
        lo[i] = r.lo
        hi[i] = r.hi
    return lo, hi


def execute_batch(svc, snap, target: str, reqs: list[QueryRequest],
                  max_batch: int,
                  store_version: int) -> list[QueryResult]:
    """Run one coalesced ``plan.query`` call and resolve every future.

    All answers come from ``snap`` (an immutable ``DDMSnapshot``): the
    store may be mid-churn, which is why the response carries
    ``version`` and ``staleness``.  The (max_batch, cap) id buffer comes
    to the host in one copy.  Returns the results (in request order) for
    metrics recording.
    """
    d = snap.s_lo.shape[1]
    q_lo, q_hi = pad_boxes(reqs, d, max_batch)
    ids, _ = svc.query_snapshot(snap, target, q_lo, q_hi)
    ids = to_numpy(ids)
    t_done = time.perf_counter()
    staleness = store_version - snap.version
    results = []
    for i, r in enumerate(reqs):
        row = ids[i]
        res = QueryResult(
            ids=row[row >= 0].astype(np.int32),
            version=snap.version,
            staleness=staleness,
            latency_s=t_done - r.t_submit)
        results.append(res)
        r.future.set_result(res)
    return results
