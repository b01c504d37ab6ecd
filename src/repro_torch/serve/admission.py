"""Admission control: bounded per-tenant queues with explicit shed
semantics (the port's copy of the JAX package's ``serve/admission.py``).

A production matcher under churn cannot let a slow tenant grow an
unbounded backlog — memory and tail latency both blow up.  Each tenant
gets one bounded FIFO; when it is full the ``shed`` policy decides what
gives:

``reject``       refuse the *new* request (``AdmissionError`` raised at
                 ``submit`` time) — callers get backpressure immediately.
``drop_oldest``  evict the oldest queued request (its future fails with
                 ``AdmissionError``) and admit the new one — freshest
                 work wins, the paper's DDS-style "latest sample"
                 semantics for interactive simulation.

Both paths are *explicit*: a shed request is never silently lost — it
is counted (``rejected``/``shed``) and its future carries the error.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque

SHED_POLICIES = ("reject", "drop_oldest")


class AdmissionError(RuntimeError):
    """A request was refused or evicted by admission control."""

    def __init__(self, tenant: str, reason: str, depth: int, bound: int):
        self.tenant = tenant
        self.reason = reason
        self.depth = depth
        self.bound = bound
        super().__init__(
            f"tenant {tenant!r}: {reason} (queue depth {depth} at "
            f"bound {bound})")


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Knobs for one server's admission control."""

    max_queue: int = 1024     # per-tenant pending-request bound
    shed: str = "reject"      # what gives when the queue is full

    def __post_init__(self):
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.shed not in SHED_POLICIES:
            raise ValueError(
                f"shed must be one of {SHED_POLICIES}, got {self.shed!r}")


class TenantQueue:
    """One tenant's bounded FIFO of pending requests.

    ``offer`` enforces the admission policy; ``take`` hands up to
    ``limit`` requests to the batcher.  All methods are thread-safe
    under the queue's own lock; the server's condition variable handles
    cross-thread wakeups.
    """

    def __init__(self, tenant: str, policy: AdmissionPolicy):
        self.tenant = tenant
        self.policy = policy
        self._lock = threading.Lock()
        self._q: deque = deque()

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)

    def offer(self, request):
        """Admit ``request`` or apply the shed policy.

        Returns the evicted request under ``drop_oldest`` (the caller
        fails its future), ``None`` when nothing was shed.  Raises
        ``AdmissionError`` under ``reject`` when full.
        """
        with self._lock:
            if len(self._q) < self.policy.max_queue:
                self._q.append(request)
                return None
            if self.policy.shed == "reject":
                raise AdmissionError(self.tenant, "queue full, rejecting",
                                     len(self._q), self.policy.max_queue)
            evicted = self._q.popleft()
            self._q.append(request)
            return evicted

    def take(self, limit: int) -> list:
        """Pop up to ``limit`` requests FIFO (the batcher's drain)."""
        out = []
        with self._lock:
            while self._q and len(out) < limit:
                out.append(self._q.popleft())
        return out

    def oldest_submit_time(self):
        """Submit timestamp of the head request (None when empty) —
        drives the batcher's max-delay coalescing decision."""
        with self._lock:
            return self._q[0].t_submit if self._q else None
