"""Dynamic DDM service — paper §3 "dynamic interval management", batched
and d-dimensional, as the port's counterpart of the JAX package's
``core/dynamic.py``.

HLA federates move and resize regions every tick; rerunning the full
match is wasteful.  When regions of one kind move, only their overlaps
change, and those are found by querying the interval tree of the
*opposite* kind, which the move does not touch.  So one tick is one
batched ``MatchPlan.query`` over the moved regions' old and new extents,
and the pair deltas are a set difference of the two answers.

As in the reference:

* **d dimensions** by match-then-verify: the tree indexes dimension 0
  and the walk's candidates are checked on dimensions 1+ by gathers;
* **batched churn**: ``update_regions`` takes a whole batch of moves of
  one kind; duplicate indices keep the last write, and the deltas equal
  applying the moves one by one;
* **deferred rebuild** instead of AVL delete and reinsert: a move marks
  its own kind's tree stale, and the tree is rebuilt (a sort and a
  gather) when the next query needs it.

The overlap *ledger* is a host set of (s, u) id pairs, and the deltas are
computed on int64 keys ``s * m + u``.  Host copies of the coordinates are
float32 numpy; the regions and trees the queries read are tensors on the
plan's device (``spec.device``, ``cuda`` by default).  The query answers
are reduced to their hits on that device before they reach the host, so
a tick moves O(hits) to the host, not the (queries, cap) id buffer.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from . import itm
from .engine import MatchPlan, MatchSpec, build_plan
from .pairs import to_numpy
from .regions import Regions


def describe_move_index_errors(idx: np.ndarray, lo: np.ndarray,
                               hi: np.ndarray, n: int, kind: str,
                               max_report: int = 5) -> list[str]:
    """Human-readable problems in a batched ``update_regions`` request.

    The engine-side companion of ``engine.describe_pair_range_errors``:
    instead of letting a bad index silently wrap (numpy's negative
    indexing) or fail deep inside a device gather, every problem class
    names up to ``max_report`` offending batch slots with their values
    and the valid range.
    """
    def _offenders(slots, fmt):
        shown = ", ".join(fmt(int(t)) for t in slots[:max_report])
        more = (f", … {len(slots) - max_report} more"
                if len(slots) > max_report else "")
        return shown + more

    problems: list[str] = []
    bad = np.nonzero((idx < 0) | (idx >= n))[0]
    if bad.size:
        problems.append(
            f"{bad.size} {kind} move index(es) outside [0, {n}): "
            + _offenders(bad, lambda t: f"slot {t}: idx={int(idx[t])}"))
    finite = np.isfinite(lo).all(axis=-1) & np.isfinite(hi).all(axis=-1)
    bad_f = np.nonzero(~finite)[0]
    if bad_f.size:
        problems.append(
            f"{bad_f.size} move(s) with non-finite extents: "
            + _offenders(bad_f, lambda t: f"slot {t}: lo={lo[t].tolist()}, "
                                          f"hi={hi[t].tolist()}"))
    return problems


def _regions(lo: np.ndarray, hi: np.ndarray, device) -> Regions:
    return Regions(torch.from_numpy(lo).to(device),
                   torch.from_numpy(hi).to(device))


@dataclasses.dataclass(frozen=True)
class DDMSnapshot:
    """Immutable, self-contained view of one region-store version.

    Holds its *own copies* of the coordinates (host and device) plus both
    interval trees, so queries against a snapshot are stable under later
    ``update_regions`` churn: a reader sees the captured region set in
    full, never a torn mix of old and new extents.
    """

    version: int
    s_lo: np.ndarray
    s_hi: np.ndarray
    u_lo: np.ndarray
    u_hi: np.ndarray
    S: Regions
    U: Regions
    tree_S: itm.ITree
    tree_U: itm.ITree

    def target(self, kind: str) -> tuple[itm.ITree, Regions]:
        """(tree, regions) pair for querying the ``kind`` set."""
        if kind == "sub":
            return self.tree_S, self.S
        return self.tree_U, self.U

    @property
    def nbytes(self) -> int:
        """Total host + device bytes this snapshot pins: the host
        coordinate copies, the device regions and both trees."""
        host = (self.s_lo, self.s_hi, self.u_lo, self.u_hi)
        dev = (self.S.lo, self.S.hi, self.U.lo, self.U.hi,
               *self.tree_S, *self.tree_U)
        return int(sum(a.nbytes for a in host)
                   + sum(t.numel() * t.element_size() for t in dev))

    def oracle_ids(self, kind: str, q_lo, q_hi) -> set[int]:
        """Brute-force ids of the ``kind`` set overlapping one box —
        the reference a served answer must match exactly."""
        lo, hi = (self.s_lo, self.s_hi) if kind == "sub" \
            else (self.u_lo, self.u_hi)
        q_lo = np.asarray(q_lo, np.float32).reshape(-1)
        q_hi = np.asarray(q_hi, np.float32).reshape(-1)
        ok = np.all((lo < q_hi[None, :]) & (q_lo[None, :] < hi), axis=-1)
        return set(np.nonzero(ok)[0].astype(int).tolist())


@dataclasses.dataclass(frozen=True)
class StoreView:
    """Cheap coordinate copy of a store at one version (capture phase).

    ``DDMService.capture()`` runs in O(n) copy time; ``build()`` does the
    O(n lg n) tree construction, on ``device``, with no lock held.
    """

    version: int
    s_lo: np.ndarray
    s_hi: np.ndarray
    u_lo: np.ndarray
    u_hi: np.ndarray
    device: Any = "cuda"

    def build(self) -> DDMSnapshot:
        S = _regions(self.s_lo, self.s_hi, self.device)
        U = _regions(self.u_lo, self.u_hi, self.device)
        return DDMSnapshot(
            version=self.version,
            s_lo=self.s_lo, s_hi=self.s_hi,
            u_lo=self.u_lo, u_hi=self.u_hi,
            S=S, U=U,
            tree_S=itm.build_tree(S), tree_U=itm.build_tree(U))


class DDMService:
    """Stateful pub/sub matching service over d-dimensional regions.

    Each tick's batched tree query runs through a ``MatchPlan`` built
    from ``spec`` (default: ITM with the grow-by-doubling capacity policy
    on ``cuda``), so the service shares the engine's query path and its
    memoized capacity.  ``cap_hint`` floors the per-query id capacity
    unless the spec pins ``max_pairs``.  The plan's ``device`` is where
    the regions, trees and queries live.  A spec with
    ``backend="distributed"`` runs every tick's query sharded over the
    ranks of ``spec.group``; every rank must then drive the service alike.
    """

    def __init__(self, S: Regions, U: Regions, cap_hint: int = 64,
                 spec: MatchSpec | None = None, plan_key: Any = None):
        if S.d != U.d:
            raise ValueError(f"S and U must share d, got {S.d} and {U.d}")
        self.d = S.d
        self.s_lo = to_numpy(S.lo).astype(np.float32)   # (n, d) copies
        self.s_hi = to_numpy(S.hi).astype(np.float32)
        self.u_lo = to_numpy(U.lo).astype(np.float32)   # (m, d)
        self.u_hi = to_numpy(U.hi).astype(np.float32)
        self._tree_S = None
        self._tree_U = None
        self.version = 0            # bumped once per applied move batch
        self.cap_hint = cap_hint
        if spec is None:
            spec = MatchSpec(algo="itm", capacity="grow",
                             max_pairs=cap_hint)
        elif spec.max_pairs is None:
            spec = dataclasses.replace(spec, max_pairs=cap_hint)
        self.spec = spec
        if plan_key is None:
            # per-service plan: its grow capacity tracks THIS service
            self.plan = MatchPlan(spec, S.n, U.n, self.d)
        else:
            self.plan = build_plan(spec, S.n, U.n, self.d, key=plan_key)
        self.device = self.plan.device
        self.pairs: set[tuple[int, int]] = set()

    # -- tree cache ---------------------------------------------------------
    def _S(self) -> Regions:
        return _regions(self.s_lo, self.s_hi, self.device)

    def _U(self) -> Regions:
        return _regions(self.u_lo, self.u_hi, self.device)

    def tree_S(self) -> itm.ITree:
        if self._tree_S is None:
            self._tree_S = itm.build_tree(self._S())
        return self._tree_S

    def tree_U(self) -> itm.ITree:
        if self._tree_U is None:
            self._tree_U = itm.build_tree(self._U())
        return self._tree_U

    # -- snapshots ----------------------------------------------------------
    def capture(self) -> StoreView:
        """O(n) coordinate copy of the store at its current version."""
        return StoreView(self.version,
                         self.s_lo.copy(), self.s_hi.copy(),
                         self.u_lo.copy(), self.u_hi.copy(), self.device)

    def snapshot(self) -> DDMSnapshot:
        """Capture + build in one step."""
        return self.capture().build()

    def _as_queries(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def query_snapshot(self, snap: DDMSnapshot, kind: str, q_lo, q_hi):
        """Batched verified ids of the ``kind`` set overlapping each of
        the (b, d) query boxes, answered *entirely from* ``snap``.
        Returns ``(ids (b, cap) −1-padded, counts (b,))`` on the plan's
        device."""
        tree, opp = snap.target(kind)
        return self.plan.query(tree, opp, self._as_queries(q_lo),
                               self._as_queries(q_hi))

    # -- batched verified overlap query --------------------------------------
    def _overlap_hits(self, kind: str, q_lo: np.ndarray,
                      q_hi: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """``(query rows, ids)``, int64, of every region of the OPPOSITE
        kind overlapping one of the b query boxes on all d dimensions
        (one ``MatchPlan.query``; the hits are selected on the device)."""
        if kind == "sub":
            tree, opp = self.tree_U(), self._U()
        else:
            tree, opp = self.tree_S(), self._S()
        empty = np.zeros(0, np.int64)
        if q_lo.shape[0] == 0 or opp.n == 0:
            return empty, empty
        ids, _ = self.plan.query(tree, opp, self._as_queries(q_lo),
                                 self._as_queries(q_hi))
        # blocks of rows below 2^30 slots: b * cap passes 2^31 at the
        # service's sizes, and each block's mask stays small
        step = max(1, (1 << 30) // ids.shape[1])
        rows, hits = [], []
        for r0 in range(0, ids.shape[0], step):
            blk = ids[r0:r0 + step]
            r, c = torch.nonzero(blk >= 0, as_tuple=True)
            rows.append(to_numpy(r) + r0)
            hits.append(to_numpy(blk[r, c]).astype(np.int64))
        return np.concatenate(rows), np.concatenate(hits)

    # -- full match (service bring-up) ---------------------------------------
    def connect(self) -> set[tuple[int, int]]:
        """Initial full match; populates the overlap ledger (one batched
        tree query over all update regions)."""
        u, s = self._overlap_hits("upd", self.u_lo, self.u_hi)
        self.pairs = set(zip(s.tolist(), u.tolist()))
        return self.pairs

    # -- move-batch validation ------------------------------------------------
    def _prepare_moves(self, kind: str, idx, new_lo, new_hi):
        """Validate + dedup one batched move request.

        Raises ``ValueError`` naming the offending batch slots and the
        valid index range (``describe_move_index_errors``).  Duplicate
        indices keep the last occurrence ("last write wins").
        """
        if kind not in ("sub", "upd"):
            raise ValueError(f"kind must be 'sub' or 'upd', got {kind!r}")
        idx = np.atleast_1d(np.asarray(idx))
        if not np.issubdtype(idx.dtype, np.integer):
            raise ValueError(
                f"move indices must be integers, got dtype {idx.dtype} "
                f"(shape {idx.shape})")
        idx = idx.astype(np.int64)
        new_lo = np.asarray(new_lo, np.float32).reshape(idx.shape[0], self.d)
        new_hi = np.asarray(new_hi, np.float32).reshape(idx.shape[0], self.d)
        n = (self.s_lo if kind == "sub" else self.u_lo).shape[0]
        problems = describe_move_index_errors(idx, new_lo, new_hi, n, kind)
        if problems:
            raise ValueError(
                f"invalid update_regions batch (b={idx.shape[0]}): "
                + "; ".join(problems))
        if idx.shape[0] == 0:
            return idx, new_lo, new_hi
        _, last = np.unique(idx[::-1], return_index=True)
        keep = np.sort(idx.shape[0] - 1 - last)
        return idx[keep], new_lo[keep], new_hi[keep]

    def _apply(self, kind: str, idx, new_lo, new_hi) -> None:
        """Write a validated move batch into the store (version bump +
        deferred tree invalidation)."""
        own_lo, own_hi = ((self.s_lo, self.s_hi) if kind == "sub"
                          else (self.u_lo, self.u_hi))
        own_lo[idx] = new_lo
        own_hi[idx] = new_hi
        self.version += 1
        if kind == "sub":
            self._tree_S = None            # deferred rebuild
        else:
            self._tree_U = None

    def apply_moves(self, kind: str, idx, new_lo, new_hi) -> int:
        """Validated coordinate update *without* delta reporting; returns
        the number of distinct regions moved."""
        idx, new_lo, new_hi = self._prepare_moves(kind, idx, new_lo, new_hi)
        if idx.shape[0] == 0:
            return 0
        self._apply(kind, idx, new_lo, new_hi)
        return int(idx.shape[0])

    # -- the dynamic operation (paper §3), batched -----------------------------
    def update_regions(self, kind: str, idx, new_lo, new_hi):
        """Move/resize a batch of regions of one kind in a single tick.

        ``idx`` is (b,) region indices; ``new_lo``/``new_hi`` are (b, d)
        (or (b,) when d == 1).  Returns ``(added, removed)``, the exact
        net pair deltas, identical to applying the b single-region
        updates in sequence.  A zero-churn batch is a no-op returning two
        empty sets.  Bad batches raise ``ValueError``.
        """
        idx, new_lo, new_hi = self._prepare_moves(kind, idx, new_lo, new_hi)
        if idx.shape[0] == 0:
            return set(), set()
        b = idx.shape[0]

        own_lo, own_hi = ((self.s_lo, self.s_hi) if kind == "sub"
                          else (self.u_lo, self.u_hi))
        # one batched query for all old extents AND all new extents
        q_lo = np.concatenate([own_lo[idx], new_lo])
        q_hi = np.concatenate([own_hi[idx], new_hi])
        rows, other = self._overlap_hits(kind, q_lo, q_hi)

        self._apply(kind, idx, new_lo, new_hi)

        # vectorized delta: encode (s, u) as s*m + u in int64, set-diff
        m = max(self.u_lo.shape[0], 1)
        moved = idx[rows % b]
        keys = moved * m + other if kind == "sub" else other * m + moved
        old_keys, new_keys = keys[rows < b], keys[rows >= b]
        added_k = np.setdiff1d(new_keys, old_keys)
        removed_k = np.setdiff1d(old_keys, new_keys)
        added = set(zip((added_k // m).tolist(), (added_k % m).tolist()))
        removed = set(zip((removed_k // m).tolist(),
                          (removed_k % m).tolist()))
        self.pairs |= added
        self.pairs -= removed
        return added, removed

    # -- single-region compatibility wrapper -----------------------------------
    def update_region(self, kind: str, idx: int, new_lo, new_hi):
        """Move/resize one region; returns (added, removed) pair deltas."""
        return self.update_regions(
            kind, np.asarray([idx]),
            np.asarray(new_lo, np.float32).reshape(1, self.d),
            np.asarray(new_hi, np.float32).reshape(1, self.d))
