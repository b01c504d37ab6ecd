"""Serving observability: per-tenant counters + latency/occupancy/lag
histograms, dumped as JSON (the port's copy of the JAX package's
``serve/metrics.py``, with the same schema).

Everything here is host-side and lock-cheap: counters are plain ints
behind one lock, histograms are bounded reservoirs (the newest
``Histogram.cap`` samples) with percentiles computed on demand — the
recording path a query touches is two appends, never a sort.  The JSON
schema (``Metrics.to_json``) is the contract the ``--smoke`` output is
built from::

    {
      "tenants": {
        "<name>": {
          "counters": {"submitted": .., "completed": .., "rejected": ..,
                       "shed": .., "batches": .., "rebuilds": ..,
                       "moves": ..},
          "query_latency_us": {"count", "p50", "p99", "max", "mean"},
          "batch_occupancy":  {...},     # filled slots / max_batch
          "rebuild_lag_versions": {...}, # staleness at response time
          "rebuild_duration_us": {...},
          "gauges": {"snapshot_version": .., "snapshot_regions": ..,
                     "snapshot_bytes": ..}  # last published snapshot
        }
      }
    }

Gauges are last-write-wins scalars (the rebuild worker sets them at
every snapshot publish): ``snapshot_bytes`` is the device+host
footprint of the tenant's current ``DDMSnapshot``, so a dashboard can
watch serving memory.
"""
from __future__ import annotations

import json
import threading

import numpy as np

SUMMARY_FIELDS = ("count", "p50", "p99", "max", "mean")


class Histogram:
    """Bounded-reservoir histogram: keeps the newest ``cap`` samples
    (steady-state behavior is what the percentiles should reflect) plus
    an all-time count."""

    def __init__(self, cap: int = 65536):
        self.cap = cap
        self._vals: list[float] = []
        self._seen = 0

    def record(self, value: float) -> None:
        self._seen += 1
        self._vals.append(float(value))
        if len(self._vals) > self.cap:
            del self._vals[: len(self._vals) - self.cap]

    def summary(self) -> dict:
        if not self._vals:
            return {k: 0 for k in SUMMARY_FIELDS}
        a = np.asarray(self._vals, np.float64)
        return {
            "count": self._seen,
            "p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99)),
            "max": float(a.max()),
            "mean": float(a.mean()),
        }


COUNTERS = ("submitted", "completed", "rejected", "shed", "batches",
            "rebuilds", "moves")


class TenantMetrics:
    """One tenant's counters + histograms (guarded by the parent lock)."""

    def __init__(self):
        self.counters = {name: 0 for name in COUNTERS}
        self.gauges: dict[str, float] = {}
        self.query_latency_us = Histogram()
        self.batch_occupancy = Histogram()
        self.rebuild_lag_versions = Histogram()
        self.rebuild_duration_us = Histogram()

    def to_dict(self) -> dict:
        return {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "query_latency_us": self.query_latency_us.summary(),
            "batch_occupancy": self.batch_occupancy.summary(),
            "rebuild_lag_versions": self.rebuild_lag_versions.summary(),
            "rebuild_duration_us": self.rebuild_duration_us.summary(),
        }


class Metrics:
    """Server-wide registry: one ``TenantMetrics`` per tenant name."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tenants: dict[str, TenantMetrics] = {}

    def tenant(self, name: str) -> TenantMetrics:
        with self._lock:
            tm = self._tenants.get(name)
            if tm is None:
                tm = self._tenants[name] = TenantMetrics()
            return tm

    def bump(self, tenant: str, counter: str, by: int = 1) -> None:
        tm = self.tenant(tenant)
        with self._lock:
            tm.counters[counter] += by

    def set_gauge(self, tenant: str, gauge: str, value: float) -> None:
        """Last-write-wins scalar (snapshot version / regions / bytes)."""
        tm = self.tenant(tenant)
        with self._lock:
            tm.gauges[gauge] = value

    def to_dict(self) -> dict:
        with self._lock:
            return {"tenants": {name: tm.to_dict()
                                for name, tm in self._tenants.items()}}

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)
