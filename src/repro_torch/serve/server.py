"""``DDMServer`` — the multi-tenant async DDM serving layer (the port's
copy of the JAX package's ``serve/server.py``).

The paper frames DDM as a *service*: the HLA runtime continuously
reports subscription/update intersections while regions churn.  This
module is that serving shape on top of the engine:

* **Tenancy** — per-tenant namespaces (``add_tenant``), each with its
  own region store, bounded queues, and one memoized ``MatchPlan`` per
  ``(tenant, MatchSpec)`` via the engine's plan-cache ``key`` hook.
  Capacity autoscaling rides the plan's ``grow`` policy: per-tenant
  query capacities double-and-memoize independently.
* **Batching + admission** — ``submit`` enqueues a box query and
  returns a future; the dispatcher coalesces queued requests into
  sentinel-padded ``MatchPlan.query`` calls (one K8 walk on the card;
  fixed shapes, so no new buffer shape in steady state) under a
  max-batch/max-delay policy with
  round-robin fairness across tenants and bounded queue depth with
  explicit shed/reject semantics (``serve.admission``).
* **Double-buffered rebuilds** — ``update_regions`` churn never blocks
  readers: writers mutate the store and mark a rebuild pending; the
  rebuild worker captures the store (O(n) copy under the tenant lock),
  builds interval trees off-lock into a shadow snapshot, waits for the
  card to finish them, and publishes it with one atomic reference swap.  Every response carries the
  snapshot ``version`` and a ``staleness`` bound (store version minus
  snapshot version at launch).
* **Observability** — per-tenant counters, latency/occupancy/lag
  histograms (``serve.metrics``), dumped as JSON.

Two drive modes: ``start()``/``stop()`` run a dispatcher thread and a
rebuild thread (the async production shape); ``pump()`` drives both
paths synchronously on the caller's thread (deterministic tests, and
the ``--smoke`` harness).  In the threaded mode only the dispatcher
launches K8; the rebuild worker's tree builds are library calls.

``device`` is where tenants registered without a spec run (``cuda`` by
default); ``warm_start=True`` builds and loads the serving kernels for
it at construction (``serve.compile_cache``).
"""
from __future__ import annotations

import itertools
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from ..core.engine import MatchSpec
from ..core.regions import Regions
from .admission import AdmissionError, AdmissionPolicy
from .batching import (BatchPolicy, QueryRequest, QueryResult, TARGETS,
                       execute_batch)
from .metrics import Metrics
from .tenancy import Tenant

__all__ = ["DDMServer", "AdmissionError", "AdmissionPolicy", "BatchPolicy",
           "QueryResult"]

_SERVER_IDS = itertools.count()


class DDMServer:
    """Multi-tenant DDM serving front end (see module docstring)."""

    def __init__(self, *, batch: BatchPolicy | None = None,
                 admission: AdmissionPolicy | None = None,
                 device: str = "cuda", warm_start: bool = False):
        self.batch_policy = batch or BatchPolicy()
        self.admission_policy = admission or AdmissionPolicy()
        self.metrics = Metrics()
        self._server_id = next(_SERVER_IDS)
        self._tenants: dict[str, Tenant] = {}
        self._order: list[str] = []
        self._cursor = 0
        self._cond = threading.Condition()
        self._stop = False
        self._threads: list[threading.Thread] = []
        # test/ops injection point: fn(phase, tenant_name) called by the
        # rebuild path at "capture" (store copied, shadow build starting)
        # and "publish" (snapshot swapped in)
        self.rebuild_hook = None
        self.device = device
        if warm_start:
            from . import compile_cache
            compile_cache.enable(device)

    # -- tenancy -------------------------------------------------------------
    def add_tenant(self, name: str, S: Regions, U: Regions, *,
                   spec: MatchSpec | None = None,
                   cap_hint: int = 64) -> Tenant:
        """Register a namespace with its own regions, plan, and queues.

        With no ``spec`` the tenant runs the service's default plan (itm,
        grow capacity floored at ``cap_hint``) on the server's device."""
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already registered")
        if spec is None:
            spec = MatchSpec(algo="itm", capacity="grow",
                             max_pairs=cap_hint, device=self.device)
        t = Tenant(name, S, U, spec=spec, cap_hint=cap_hint,
                   admission=self.admission_policy,
                   plan_key=("serve", self._server_id, name))
        with self._cond:
            self._tenants[name] = t
            self._order.append(name)
        self.metrics.tenant(name)
        self._record_snapshot_gauges(name, t.live)
        return t

    def _record_snapshot_gauges(self, name: str, snap) -> None:
        """Memory/version accounting for the tenant's live snapshot."""
        self.metrics.set_gauge(name, "snapshot_version", snap.version)
        self.metrics.set_gauge(name, "snapshot_regions",
                               snap.S.n + snap.U.n)
        self.metrics.set_gauge(name, "snapshot_bytes", snap.nbytes)

    def tenant(self, name: str) -> Tenant:
        t = self._tenants.get(name)
        if t is None:
            raise ValueError(
                f"unknown tenant {name!r}; registered: "
                f"{sorted(self._tenants)}")
        return t

    # -- read path -----------------------------------------------------------
    def submit(self, tenant: str, target: str, lo, hi) -> Future:
        """Enqueue one box query; the future resolves to a
        ``QueryResult`` (or raises ``AdmissionError`` if shed)."""
        if target not in TARGETS:
            raise ValueError(f"target must be one of {TARGETS}, "
                             f"got {target!r}")
        t = self.tenant(tenant)
        d = t.svc.d
        req = QueryRequest(
            tenant=tenant, target=target,
            lo=np.asarray(lo, np.float32).reshape(d),
            hi=np.asarray(hi, np.float32).reshape(d),
            future=Future(), t_submit=time.perf_counter())
        try:
            evicted = t.queues[target].offer(req)
        except AdmissionError:
            self.metrics.bump(tenant, "rejected")
            raise
        if evicted is not None:
            self.metrics.bump(tenant, "shed")
            evicted.future.set_exception(AdmissionError(
                tenant, "evicted by drop_oldest shed",
                self.admission_policy.max_queue,
                self.admission_policy.max_queue))
        self.metrics.bump(tenant, "submitted")
        with self._cond:
            self._cond.notify_all()
        return req.future

    def query(self, tenant: str, target: str, lo, hi,
              timeout: float = 30.0) -> QueryResult:
        """Submit + wait.  With no dispatcher thread running, drives one
        synchronous ``pump`` so single-threaded callers just work."""
        fut = self.submit(tenant, target, lo, hi)
        if not self._threads:
            self.pump(rebuilds=False)
        return fut.result(timeout=timeout)

    # -- write path ----------------------------------------------------------
    def update_regions(self, tenant: str, kind: str, idx, new_lo,
                       new_hi) -> int:
        """Apply one churn batch to a tenant's store (validated,
        last-write-wins) and schedule a shadow rebuild.  Readers keep
        answering from the published snapshot — this call never blocks
        them, and never waits for the rebuild itself."""
        t = self.tenant(tenant)
        moved = t.apply_moves(kind, idx, new_lo, new_hi)
        if moved:
            self.metrics.bump(tenant, "moves", by=moved)
            with self._cond:
                self._cond.notify_all()
        return moved

    # -- dispatch internals --------------------------------------------------
    def _rr_order(self) -> list[str]:
        """Round-robin rotation: each call starts one tenant later, so
        no tenant is permanently first in line for batch slots."""
        with self._cond:
            order = list(self._order)
            if not order:
                return order
            start = self._cursor % len(order)
            self._cursor += 1
        return order[start:] + order[:start]

    def _launch(self, t: Tenant, target: str,
                reqs: list[QueryRequest]) -> None:
        snap = t.live                       # atomic reference read
        results = execute_batch(t.svc, snap, target, reqs,
                                self.batch_policy.max_batch,
                                t.store_version)
        tm = self.metrics.tenant(t.name)
        self.metrics.bump(t.name, "completed", by=len(reqs))
        self.metrics.bump(t.name, "batches")
        tm.batch_occupancy.record(len(reqs) / self.batch_policy.max_batch)
        for r in results:
            tm.query_latency_us.record(r.latency_s * 1e6)
        tm.rebuild_lag_versions.record(results[0].staleness if results
                                       else 0)

    def _dispatch_once(self, force: bool) -> int:
        """One fairness round over every (tenant, target) stream.

        ``force`` launches any non-empty queue (the pump path);
        otherwise a stream launches only when full or when its oldest
        request has aged past ``max_delay_s``.  Returns requests served.
        """
        served = 0
        now = time.perf_counter()
        pol = self.batch_policy
        for name in self._rr_order():
            t = self._tenants[name]
            for target in TARGETS:
                q = t.queues[target]
                depth = len(q)
                if depth == 0:
                    continue
                if not force and depth < pol.max_batch:
                    oldest = q.oldest_submit_time()
                    if oldest is None or now - oldest < pol.max_delay_s:
                        continue
                reqs = q.take(pol.max_batch)
                if reqs:
                    self._launch(t, target, reqs)
                    served += len(reqs)
        return served

    def _rebuild_once(self) -> bool:
        """Rebuild + publish at most one tenant's shadow snapshot."""
        for name in self._rr_order():
            t = self._tenants[name]
            view = t.capture_for_rebuild()
            if view is None:
                continue
            if self.rebuild_hook is not None:
                self.rebuild_hook("capture", name)
            t0 = time.perf_counter()
            snap = view.build()             # off-lock: readers unblocked
            if snap.S.device.type == "cuda":
                # publish finished trees only: the dispatcher thread may
                # launch on another stream than this one
                torch.cuda.current_stream(snap.S.device).synchronize()
            dt = time.perf_counter() - t0
            t.publish(snap)
            if self.rebuild_hook is not None:
                self.rebuild_hook("publish", name)
            tm = self.metrics.tenant(name)
            self.metrics.bump(name, "rebuilds")
            tm.rebuild_duration_us.record(dt * 1e6)
            self._record_snapshot_gauges(name, snap)
            return True
        return False

    # -- synchronous drive (deterministic tests, smoke harness) --------------
    def pump(self, *, queries: bool = True, rebuilds: bool = True) -> int:
        """Drive the serving loops on the caller's thread until idle:
        drain every queue (forced launches), then run every pending
        rebuild.  Returns the number of requests served."""
        served = 0
        if queries:
            while True:
                n = self._dispatch_once(force=True)
                served += n
                if n == 0:
                    break
        if rebuilds:
            while self._rebuild_once():
                pass
        return served

    # -- async drive ---------------------------------------------------------
    def start(self) -> None:
        """Spawn the dispatcher and rebuild-worker threads."""
        if self._threads:
            return
        self._stop = False
        for fn, tag in ((self._dispatch_loop, "dispatch"),
                        (self._rebuild_loop, "rebuild")):
            th = threading.Thread(target=fn, name=f"ddm-serve-{tag}",
                                  daemon=True)
            th.start()
            self._threads.append(th)

    def stop(self, drain: bool = True) -> None:
        """Stop the worker threads; ``drain`` serves whatever is queued
        (and finishes pending rebuilds) before returning."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        for th in self._threads:
            th.join(timeout=30.0)
        self._threads = []
        if drain:
            self.pump()

    def _wait_tick(self) -> bool:
        """Sleep until new work may exist; False when stopping."""
        timeout = min(max(self.batch_policy.max_delay_s / 2, 5e-4), 0.05)
        with self._cond:
            if self._stop:
                return False
            self._cond.wait(timeout=timeout)
            return not self._stop

    def _dispatch_loop(self) -> None:
        while self._wait_tick():
            self._dispatch_once(force=False)
        self._dispatch_once(force=True)     # final drain on stop

    def _rebuild_loop(self) -> None:
        while self._wait_tick():
            while self._rebuild_once():
                pass
        while self._rebuild_once():
            pass

    # -- observability -------------------------------------------------------
    def metrics_dict(self) -> dict:
        return self.metrics.to_dict()

    def metrics_json(self, indent: int = 2) -> str:
        return self.metrics.to_json(indent=indent)
