"""Per-tenant namespaces: region store, plan, queues, and the double
buffer (the port's copy of the JAX package's ``serve/tenancy.py``).

A tenant owns one ``DDMService`` (the authoritative region store +
validation + version counter), one memoized ``MatchPlan`` keyed
``(server_id, tenant, MatchSpec)`` through the engine's plan-cache
keying hook (so two tenants with identical specs never share grow
capacities), two bounded request queues (one per query target), and
the double buffer itself:

``live``     the published immutable ``DDMSnapshot`` readers query —
             swapped atomically (a Python reference assignment), never
             mutated.
``pending``  the store version a rebuild has been requested for; the
             rebuild worker captures the store under ``lock``, builds
             trees off-lock into the shadow, and publishes.

Writers (``apply_moves``) touch only the store; readers touch only
``live``; the single rebuild path is what moves data between them, so a
query observes the captured region set in full — old or new, never a
torn mix.

Move batches are padded to power-of-two sizes (repeat-last-move
padding, which the service's last-write-wins dedup collapses to a
no-op), as in the reference, so a churn stream with drifting batch
sizes sees O(lg B) batch shapes, mirroring the engine's grow policy.
"""
from __future__ import annotations

import threading

import numpy as np

from ..core.dynamic import DDMService, DDMSnapshot
from ..core.engine import MatchSpec
from ..core.regions import Regions
from .admission import AdmissionPolicy, TenantQueue
from .batching import TARGETS


def pad_moves_pow2(idx: np.ndarray, lo: np.ndarray, hi: np.ndarray):
    """Pad a move batch to the next power of two by repeating its last
    entry — identical store effect (last-write-wins dedup), one shape
    per pow2 bucket instead of one per distinct batch size."""
    b = idx.shape[0]
    if b == 0:
        return idx, lo, hi
    cap = 1 << max(b - 1, 0).bit_length() if b > 1 else 1
    if cap == b:
        return idx, lo, hi
    pad = cap - b
    return (np.concatenate([idx, np.repeat(idx[-1:], pad)]),
            np.concatenate([lo, np.repeat(lo[-1:], pad, axis=0)]),
            np.concatenate([hi, np.repeat(hi[-1:], pad, axis=0)]))


class Tenant:
    """One namespace's full serving state (see module docstring)."""

    def __init__(self, name: str, S: Regions, U: Regions, *,
                 spec: MatchSpec | None = None, cap_hint: int = 64,
                 admission: AdmissionPolicy, plan_key):
        self.name = name
        self.svc = DDMService(S, U, cap_hint=cap_hint, spec=spec,
                              plan_key=plan_key)
        self.lock = threading.Lock()        # guards store mutation+capture
        self.queues = {t: TenantQueue(name, admission) for t in TARGETS}
        # the double buffer: readers take `live` by reference (atomic
        # under the GIL), the rebuild worker swaps a fresh snapshot in
        self.live: DDMSnapshot = self.svc.snapshot()
        self.pending_version: int | None = None

    @property
    def plan(self):
        return self.svc.plan

    @property
    def store_version(self) -> int:
        return self.svc.version

    @property
    def staleness(self) -> int:
        """Applied-but-unpublished update batches (the response bound)."""
        return self.svc.version - self.live.version

    def queue_depth(self) -> int:
        return sum(len(q) for q in self.queues.values())

    # -- write path ----------------------------------------------------------
    def apply_moves(self, kind: str, idx, new_lo, new_hi) -> int:
        """Validate + apply one churn batch; marks a rebuild pending.

        Never touches ``live`` — readers keep answering from the
        published snapshot until the rebuild worker swaps.
        """
        idx = np.atleast_1d(np.asarray(idx))
        new_lo = np.asarray(new_lo, np.float32).reshape(idx.shape[0], -1)
        new_hi = np.asarray(new_hi, np.float32).reshape(idx.shape[0], -1)
        if np.issubdtype(idx.dtype, np.integer):
            idx, new_lo, new_hi = pad_moves_pow2(idx, new_lo, new_hi)
        with self.lock:
            moved = self.svc.apply_moves(kind, idx, new_lo, new_hi)
            if moved:
                self.pending_version = self.svc.version
        return moved

    # -- rebuild path (the shadow side of the double buffer) -----------------
    def capture_for_rebuild(self):
        """Store view for the rebuild worker (None when already fresh)."""
        with self.lock:
            if self.svc.version == self.live.version:
                self.pending_version = None
                return None
            return self.svc.capture()

    def publish(self, snap: DDMSnapshot) -> None:
        """Atomically swap the shadow snapshot in (monotone versions)."""
        with self.lock:
            if snap.version >= self.live.version:
                self.live = snap
            if (self.pending_version is not None
                    and snap.version >= self.pending_version):
                self.pending_version = None
