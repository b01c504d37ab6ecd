"""MatchSpec → MatchPlan engine — one plan/execute API for the port.

The port's counterpart of the JAX package's ``core/engine.py``, for the
sort-based family (``sbm``, ``sbm_chunked``, ``sbm_binary``), the hybrid
grid+SBM (``hsbm``), the interval tree (``itm``) and the paper's two
baselines, brute force (``bfm``) and the grid (``gbm``):

    spec = MatchSpec(algo="sbm")                 # backend="cuda", device="cuda"
    plan = build_plan(spec, n_sub=S.n, n_upd=U.n, d=S.d)
    k = plan.count(S, U)                         # exact K, int64-safe
    res, k = plan.pairs(S, U)                    # PairsResult, −1-padded
    mask = plan.mask(S, U)                       # (n, m) bool
    ids, cnt = plan.query(tree, opp, q_lo, q_hi)   # dynamic service path

Backends
--------
``cuda``   the counterpart of ``pallas``: sorts and searchsorted are
           library calls; the SBM sweep (``count``, K1), the pass-2 emit
           (``pairs`` of sbm and hsbm: K2, K5 or K6 by emit route), the BFM tile
           count and mask (K3, K4) and the interval tree walk (K8) are
           hand-written kernels (``kernels/``).  The default.
``torch``  the counterpart of ``xla``: the plain tensor code of
           ``core.sbm``, ``core.itm``, ``core.brute`` and ``core.grid``
           on any device.
``distributed``  multi-rank parallel SBM on ``torch.distributed`` (paper
           §4, ``core.distributed``): ``count()`` (sample sort, the
           exclusive combine, seeded sweeps through K1), ``pairs()``
           (per-rank exact counts and slot-bound emit through K2, a
           ``ShardedPairs``) and ``query()`` (rows sharded, tree
           replicated, K8 per rank).  Every rank calls the plan with the
           same replicated inputs and gets the same result; the process
           group is ``spec.group`` (``None``: the default group), NCCL for
           ``device="cuda"`` and gloo for ``device="cpu"``.  Count and
           pairs take the sbm family; ``mask()`` raises.

``device`` names where the plan's buffers live and where its inputs
must be; it defaults to ``cuda``, and ``cuda`` without a card raises
``RuntimeError``.  The CUDA kernel wrappers run their plain versions
for tensors on the CPU, so a ``device="cpu"`` plan exercises the
``cuda`` backend's control flow with the kernels' plain versions.

``pairs()`` returns a ``core.pairs.PairsResult``: ``DensePairs`` on
every path but the ``csr`` emit route, which returns the lazy
``kernels.ops.CSRPairs`` view (O(n+m) device memory, windows decoded on
demand).  ``gbm`` counts on its grid (1-D; d > 1 counts through pairs)
and enumerates through BFM, as the reference does; ``mask()`` is BFM's
mask for every algorithm.  ``hsbm`` measures its grid geometry on the
host per call (``core.grid.hsbm_geometry``, one copy of the dim-0
bounds to the host), counts from its pass 1 alone on both backends,
and emits through the plain hybrid pass 2 (``torch``) or the sbm emit
routes on its emitter-slot tables (``cuda``).

Capacity policies (buffer sizing for ``pairs()``)
-------------------------------------------------
``exact``  run the counting pass first, size the buffer to exactly K.
``fixed``  caller-supplied ``max_pairs``; truncation reports the true K.
``grow``   power-of-two buffer, re-emitted doubled on overflow and
           memoized.  Floored at ``max_pairs`` when given.
``query()`` sizes its per-query id buffer the same way: the largest
dim-0 count (``exact``), ``max_pairs`` (``fixed``), or a memoized power
of two floored at ``max_pairs`` (``grow``, the ``DDMService`` default).

ITM counts on a tree built on the smaller set (``swap="auto"``, or the
side ``swap`` names) and enumerates on a tree built on S, querying every
update region, as the reference does.

d > 1 enumerates dim-0 candidates with the 1-D path, sized exactly by
the binary-search per-subscription counts, and filters dimensions
1..d-1 (``sbm_verify_dims``); the candidates must be dense, so ``csr``
is rejected for d > 1.  Zero-region inputs give K = 0, an all-−1 buffer
and an all-False mask without launching a kernel.

PyTorch runs eagerly, so there is no jit cache and no trace counter;
what stands in for a retrace is a capacity a plan resolves for the
first time (a new buffer shape), which ``new_capacities`` logs for
``repro_torch.analysis.steady``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from ..spans import host_read, span
from . import brute, grid, itm, sbm
from .pairs import DensePairs, PairsResult, ShardedPairs, to_numpy
from .regions import Regions, resolve_device

ALGOS = ("bfm", "gbm", "sbm", "sbm_chunked", "sbm_binary", "hsbm", "itm")
BACKENDS = ("torch", "cuda", "distributed")
CAPACITY_POLICIES = ("exact", "fixed", "grow")
SWAPS = ("auto", "S", "U")
EMIT_ROUTES = ("auto", "resident", "streaming", "csr", "xla")
_SBM_FAMILY = ("sbm", "sbm_chunked", "sbm_binary")


def _pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length() if x > 1 else 1


@dataclasses.dataclass(frozen=True)
class MatchSpec:
    """Frozen, hashable description of *how* to match.

    ``algo``/``backend``/``capacity`` select the path; ``max_pairs`` is
    the fixed cap or grow floor; the rest are per-algorithm knobs with
    the reference's meanings; ``device`` is where the plan runs and
    ``group`` the ``torch.distributed`` process group of the distributed
    backend (``None``: the default group).
    """

    algo: str = "sbm"
    backend: str = "cuda"
    capacity: str = "exact"
    d: int | None = None           # declared dimensionality (optional)
    max_pairs: int | None = None   # fixed cap / grow floor
    tile: int = 4096               # BFM torch-backend U-tile
    ncells: int = 3000             # GBM grid cells
    p: int = 8                     # chunked-SBM segments
    swap: str = "auto"             # ITM build side for count()
    ts: int = 256                  # BFM kernel K3 tile sizes
    tu: int = 256
    block: int = 4096              # streaming emit (K5) slots per CTA
    emit_route: str = "auto"       # pass-2 route (kernels.ops)
    emit_budget: int | None = None  # emit L2 byte budget (None=default)
    hsbm_ncells: int | None = None  # hsbm grid override (None=measured)
    overprovision: float = 2.5     # distributed bucket slack
    group: Any = None              # torch.distributed group (distributed)
    device: str = "cuda"

    def __post_init__(self):
        if self.algo not in ALGOS:
            raise ValueError(f"algo must be one of {ALGOS}, got {self.algo}")
        if self.backend not in BACKENDS:
            raise ValueError(
                f"backend must be one of {BACKENDS}, got {self.backend}")
        if self.capacity not in CAPACITY_POLICIES:
            raise ValueError(
                f"capacity must be one of {CAPACITY_POLICIES}, "
                f"got {self.capacity}")
        if self.capacity == "fixed" and self.max_pairs is None:
            raise ValueError("capacity='fixed' requires max_pairs")
        if self.emit_route not in EMIT_ROUTES:
            raise ValueError(f"emit_route must be one of {EMIT_ROUTES}, "
                             f"got {self.emit_route}")
        if self.swap not in SWAPS:
            raise ValueError(f"swap must be one of {SWAPS}, got {self.swap}")
        if self.d is not None and self.d < 1:
            raise ValueError(f"d must be >= 1, got {self.d}")
        if self.emit_route == "csr" and self.d is not None and self.d > 1:
            raise ValueError(_csr_dense_message(self.d))


def _csr_dense_message(d: int) -> str:
    return ("emit_route='csr' returns a lazy CSRPairs view, but d > 1 "
            "verification gathers from a dense dim-0 candidate buffer; "
            f"use emit_route='auto'/'streaming'/'xla' for d={d}")


class MatchPlan:
    """Matcher for one ``(spec, n_sub, n_upd, d)`` problem shape.

    Holds the resolved device and the memoized capacities of the
    ``exact``/``grow`` policies (``pairs()``, the d > 1 candidates and
    ``query()``).  ``new_capacities``, an insertion-ordered dict, gains
    the key ``(buffer, capacity)`` each time a resolver returns a
    capacity this plan has not returned before for that buffer: a new
    buffer shape, which
    ``repro_torch.analysis.steady`` forbids in steady state.
    """

    def __init__(self, spec: MatchSpec, n_sub: int, n_upd: int, d: int):
        if d < 1:
            raise ValueError(f"d must be >= 1, got {d}")
        if spec.d is not None and spec.d != d:
            raise ValueError(
                f"spec declares d={spec.d} but the plan is built for "
                f"d={d}")
        if spec.emit_route == "csr" and d > 1:
            raise ValueError(_csr_dense_message(d))
        self.spec = spec
        self.device = resolve_device(spec.device)
        self.n_sub = int(n_sub)
        self.n_upd = int(n_upd)
        self.d = int(d)
        self._cap: int | None = None        # memoized output capacity
        self._cand_cap: int | None = None   # memoized dim-0 candidate cap
        self._cap_dev: int | None = None    # memoized per-rank emit cap
        self._query_cap = max(spec.max_pairs or 1, 1)   # query() grow cap
        self.new_capacities: dict[tuple[str, int], None] = {}

    def __repr__(self) -> str:
        s = self.spec
        return (f"MatchPlan(algo={s.algo}, backend={s.backend}, "
                f"capacity={s.capacity}, n_sub={self.n_sub}, "
                f"n_upd={self.n_upd}, d={self.d}, device={self.device})")

    # -- plumbing -----------------------------------------------------------
    def _check(self, S: Regions, U: Regions):
        if (S.n, U.n) != (self.n_sub, self.n_upd) or S.d != self.d:
            raise ValueError(
                f"plan compiled for (n_sub={self.n_sub}, n_upd={self.n_upd},"
                f" d={self.d}); got (n_sub={S.n}, n_upd={U.n}, d={S.d})")
        for name, R in (("S", S), ("U", U)):
            if R.device.type != self.device.type:
                raise ValueError(
                    f"{name} lives on {R.device} but the plan runs on "
                    f"{self.device}; build the regions with "
                    f"device={self.device.type!r}")

    def _note(self, buffer: str, cap: int) -> int:
        """Log ``cap`` in ``new_capacities`` when it is new for ``buffer``."""
        self.new_capacities.setdefault((buffer, cap))
        return cap

    def _resolve_cap(self, exact_k: int) -> int:
        """Output-buffer capacity under the plan's policy."""
        pol = self.spec.capacity
        if pol == "fixed":
            return self._note("pairs", max(self.spec.max_pairs, 1))
        if pol == "exact":
            self._cap = max(exact_k, 1)
        else:
            cap = _pow2(max(exact_k, self.spec.max_pairs or 1, 1))
            self._cap = max(self._cap or 1, cap)
        return self._note("pairs", self._cap)

    def _resolve_cand_cap(self, exact_c: int) -> int:
        """Dim-0 candidate capacity (must hold EVERY dim-0 overlap)."""
        if self.spec.capacity == "grow":
            self._cand_cap = max(self._cand_cap or 1, _pow2(max(exact_c, 1)))
        else:
            self._cand_cap = max(exact_c, 1)
        return self._note("candidates", self._cand_cap)

    def _resolve_cap_dev(self, need: int) -> int:
        """Per-rank emit-buffer capacity of the distributed backend.

        ``need`` is the largest per-rank dim-0 pair total.  ``grow``
        memoizes a monotone power of two; ``fixed`` at d == 1 takes
        ``max_pairs`` per rank (the assembled prefix is still the first
        ``max_pairs`` pairs a global emit would keep); everything else
        sizes exactly (d > 1 must hold every dim-0 candidate).
        """
        need = max(need, 1)
        if self.spec.capacity == "grow":
            self._cap_dev = max(self._cap_dev or 1, _pow2(need))
            return self._note("cap_dev", self._cap_dev)
        if self.spec.capacity == "fixed" and self.d == 1:
            return self._note("cap_dev", max(self.spec.max_pairs, 1))
        return self._note("cap_dev", need)

    def _project(self, R: Regions) -> Regions:
        return Regions(R.lo[:, :1], R.hi[:, :1])

    # -- counting -----------------------------------------------------------
    def count(self, S: Regions, U: Regions) -> int:
        """Exact number of overlapping (subscription, update) pairs."""
        self._check(S, U)
        if S.n == 0 or U.n == 0:
            return 0
        if self.spec.backend == "distributed":
            if self.d == 1:
                return self._count_distributed(S, U)
            # d > 1 falls through to match-then-verify, whose
            # _pairs_impl takes the sharded emit
        elif self.spec.algo == "bfm":
            return self._count_bfm(S, U)
        elif self.d == 1:
            return self._count_1d(S, U)
        # d > 1: counting needs pair identity (match-then-verify); the
        # count is exact regardless of the 1-slot output buffer.
        _, k = self._pairs_impl(S, U, out_cap=1)
        return k

    def _count_bfm(self, S: Regions, U: Regions) -> int:
        spec = self.spec
        if spec.backend == "cuda":
            from ..kernels import ops
            return ops.bfm_count_cuda(S, U, ts=spec.ts, tu=spec.tu)
        return brute.bfm_count(S, U, tile=spec.tile)

    def _count_1d(self, S: Regions, U: Regions) -> int:
        spec = self.spec
        algo = spec.algo
        args = (S.lo[:, 0], S.hi[:, 0], U.lo[:, 0], U.hi[:, 0])
        if algo == "hsbm":
            return self._count_hsbm(S, U)
        if spec.backend == "cuda" and algo in ("sbm", "sbm_chunked"):
            from ..kernels import ops
            return ops.sbm_count_cuda(S, U)
        if algo == "sbm":
            return sbm._total(sbm._sweep_contribs(*args))
        if algo == "sbm_chunked":
            return sbm._total(sbm._chunked_contribs(*args, p=spec.p))
        if algo == "sbm_binary":
            return sbm._total(sbm.sbm_count_per_sub(S, U))
        if algo == "itm":
            build_on_S = (S.n <= U.n if spec.swap == "auto"
                          else spec.swap == "S")
            T = itm.build_tree(S if build_on_S else U)
            Q = U if build_on_S else S
            return sbm._total(self._itm_counts(T, Q.lo[:, 0], Q.hi[:, 0]))
        if algo == "gbm":
            return grid.gbm_count(S, U, ncells=spec.ncells)
        raise AssertionError(algo)

    def _count_hsbm(self, S: Regions, U: Regions) -> int:
        """Exact K from the hybrid pass 1 alone (no emission), the same
        arithmetic on both backends: its unclipped per-emitter counts
        summed in int64."""
        b, g, lb, width = sbm.hsbm_inputs(S, U, self.spec.hsbm_ncells)
        counts = sbm._hsbm_phase1(*b, lb, width, max_pairs=1,
                                  **g.statics())[3]
        return sbm._total(counts)

    def _require_sbm_family(self) -> None:
        if self.spec.algo not in _SBM_FAMILY:
            raise ValueError(
                "distributed backend implements parallel SBM; "
                f"algo={self.spec.algo!r} is not supported")

    def _count_distributed(self, S: Regions, U: Regions) -> int:
        from .distributed import _distributed_count
        self._require_sbm_family()
        return _distributed_count(S, U, group=self.spec.group,
                                  overprovision=self.spec.overprovision)

    # -- pair enumeration ---------------------------------------------------
    def pairs(self, S: Regions, U: Regions):
        """Enumerate overlaps: ``(PairsResult, count)``.

        The buffer's capacity is resolved by the plan's policy; ``count``
        (also ``result.count``) is the exact K even when a fixed buffer
        truncates.  The result is a ``DensePairs``, or the lazy
        ``CSRPairs`` view on the ``csr`` emit route.
        """
        self._check(S, U)
        spec = self.spec
        if S.n == 0 or U.n == 0:
            cap = self._resolve_cap(0)
            return DensePairs(torch.full((cap, 2), -1, dtype=torch.int32,
                                         device=self.device), 0), 0
        if spec.capacity == "exact":
            # the counting pass runs only when no capacity is memoized
            # yet; later calls emit directly and re-emit once if K drifted
            cap = self._cap
            if cap is None:
                cap = self._resolve_cap(self.count(S, U))
            pairs, k = self._pairs_impl(S, U, out_cap=cap)
            if max(k, 1) != cap:
                cap = self._resolve_cap(k)
                with span("engine.reemit"):
                    pairs, k = self._pairs_impl(S, U, out_cap=cap)
            return _wrap_pairs(pairs, k)
        if spec.capacity == "fixed":
            pairs, k = self._pairs_impl(S, U,
                                        out_cap=self._resolve_cap(0))
            return _wrap_pairs(pairs, k)
        # grow-by-doubling: every path reports the exact K, so at most
        # one re-execution with the doubled (power-of-two) buffer
        cap = self._resolve_cap(0)
        pairs, k = self._pairs_impl(S, U, out_cap=cap)
        if k > cap:
            cap = self._resolve_cap(k)
            with span("engine.reemit"):
                pairs, k = self._pairs_impl(S, U, out_cap=cap)
        return _wrap_pairs(pairs, k)

    def _pairs_impl(self, S: Regions, U: Regions, out_cap: int):
        """(pairs, exact K) with a caller-resolved output capacity."""
        if self.spec.backend == "distributed":
            return self._pairs_distributed(S, U, out_cap)
        if self.spec.algo in ("bfm", "gbm"):
            # GBM degenerates to BFM for enumeration (paper: per-cell
            # matching IS brute force; pair identity needs no grid)
            return self._pairs_bfm(S, U, out_cap)
        dim0 = {"itm": self._pairs_itm_dim0,
                "hsbm": self._pairs_hsbm_dim0}.get(self.spec.algo,
                                                    self._pairs_sbm_dim0)
        cand, k = dim0(S, U, out_cap if self.d == 1
                       else self._cand_bound(S, U))
        if self.d == 1:
            return cand, k
        pairs, count = sbm_verify_dims(S, U, cand, max_pairs=out_cap)
        return pairs, int(count)

    def _cand_bound(self, S: Regions, U: Regions) -> int:
        """Exact dim-0 candidate count (binary-search per-sub counts)."""
        c = sbm.sbm_count_per_sub(self._project(S), self._project(U))
        return self._resolve_cand_cap(sbm._total(c))

    def _pairs_bfm(self, S: Regions, U: Regions, out_cap: int):
        if self.spec.backend == "cuda":
            from ..kernels import ops
            return ops.bfm_pairs_cuda(S, U, out_cap)
        return brute.bfm_pairs(S, U, out_cap)

    def _pairs_sbm_dim0(self, S: Regions, U: Regions, cap: int):
        spec = self.spec
        S0, U0 = self._project(S), self._project(U)
        if spec.backend == "cuda":
            from ..kernels import ops
            return ops.twopass_pairs_cuda(S0, U0, cap, route=spec.emit_route,
                                          block=spec.block,
                                          budget=spec.emit_budget,
                                          dense_only=self.d > 1)
        return sbm.sbm_pairs(S0, U0, cap)

    def _pairs_hsbm_dim0(self, S: Regions, U: Regions, cap: int):
        spec = self.spec
        S0, U0 = self._project(S), self._project(U)
        if spec.backend == "cuda":
            from ..kernels import ops
            return ops.hsbm_pairs_cuda(S0, U0, cap, ncells=spec.hsbm_ncells,
                                       route=spec.emit_route,
                                       block=spec.block,
                                       budget=spec.emit_budget,
                                       dense_only=self.d > 1)
        return sbm.hsbm_pairs(S0, U0, cap, ncells=spec.hsbm_ncells)

    def _pairs_distributed(self, S: Regions, U: Regions, out_cap: int):
        """Sharded two-pass emit with per-rank slot-bound buffers.

        Pass 1 (``distributed._dist_pairs_pass1``) sorts both lo streams
        by the distributed sample sort with an index payload and counts
        the rank's emitter chunk exactly; the exact K and the largest
        per-rank total come back from one collective, and the total sizes
        the per-rank capacity (``_resolve_cap_dev``).  Pass 2 decodes the
        rank's ``cap_dev`` slots with K2; d > 1 filters dimensions 1+ and
        compacts locally, and K is then the sum of the verified totals.
        The ranks' buffers and totals are gathered here, with every rank
        taking part, into a ``ShardedPairs``.
        """
        from . import distributed as dist_mod
        self._require_sbm_family()
        spec = self.spec
        p1, k0, need = dist_mod._dist_pairs_pass1(
            S, U, overprovision=spec.overprovision, group=spec.group)
        cap_dev = self._resolve_cap_dev(need)
        rows, ver = dist_mod._dist_pairs_emit(p1, S.n + U.n, cap_dev=cap_dev)
        if self.d > 1:
            rows, ver = sbm_verify_dims(S, U, rows, max_pairs=cap_dev)
        bufs = dist_mod._all_gather(rows, spec.group).reshape(-1, 2)
        vers = dist_mod._all_gather(
            torch.tensor([ver], dtype=torch.int64, device=self.device),
            spec.group).reshape(-1).tolist()
        k = k0 if self.d == 1 else sum(vers)
        return ShardedPairs(bufs, vers, out_cap, k), k

    # -- ITM: the tree walk, K8 on the cuda and distributed backends ----------
    def _itm_order(self, q_lo):
        """K8's query order, sorted once for a count walk and a pairs walk
        of the same queries; ``None`` where no kernel runs."""
        if self.spec.backend == "cuda" and q_lo.is_cuda:
            from ..kernels import itm as itm_kernel
            return itm_kernel.query_order(q_lo)
        return None

    def _itm_counts(self, tree, q_lo, q_hi, order=None) -> torch.Tensor:
        if self.spec.backend == "cuda":
            from ..kernels import ops
            return ops.itm_query_counts_cuda(tree, q_lo, q_hi, order)
        return itm.itm_query_counts(tree, q_lo, q_hi)

    def _itm_pairs(self, tree, q_lo, q_hi, cap: int, order=None):
        if self.spec.backend == "cuda":
            from ..kernels import ops
            return ops.itm_query_pairs_cuda(tree, q_lo, q_hi, cap, order)
        return itm.itm_query_pairs(tree, q_lo, q_hi, cap)

    def _pairs_itm_dim0(self, S: Regions, U: Regions, cap: int):
        """Dim-0 pairs from a tree on S, every update region a query:
        ``(pairs (cap, 2) in (update, DFS) order, exact K)``."""
        T = itm.build_tree(self._project(S))
        u_lo, u_hi = U.lo[:, 0], U.hi[:, 0]
        order = self._itm_order(u_lo)
        counts = self._itm_counts(T, u_lo, u_hi, order)
        per_q = max(host_read(counts.max()), 1)
        if self.spec.capacity == "grow":   # bound the buffer shapes
            per_q = _pow2(per_q)
        ids, _ = self._itm_pairs(T, u_lo, u_hi, per_q, order)
        return itm_flatten_pairs(ids, cap), sbm._total(counts)

    def emit_route(self) -> str | None:
        """The pass-2 route ``pairs()`` takes on the cuda backend.

        The spec's pinned ``emit_route``, or the byte-budget policy
        (``kernels.ops.choose_emit_route``) applied to this plan's
        problem shape under ``emit_budget``.  ``None`` for the torch
        backend and for algorithms that do not reach the two-pass emit.
        For d > 1 ``auto`` never resolves to ``csr``.  For ``hsbm`` under
        ``auto`` it is ``None``: the route follows the grid geometry
        measured at each call (``kernels.ops.last_emit_route()`` names
        the route a call took).
        """
        spec = self.spec
        if (spec.backend != "cuda"
                or spec.algo not in _SBM_FAMILY + ("hsbm",)):
            return None
        if spec.emit_route != "auto":
            return spec.emit_route
        if spec.algo == "hsbm":
            return None
        from ..kernels import ops
        return ops.choose_emit_route(self.n_sub, self.n_upd,
                                     budget=spec.emit_budget,
                                     dense_only=self.d > 1)

    def validate_pairs(self, pairs, count: int | None = None) -> None:
        """Host-side sanity check of a ``pairs()`` result buffer.

        Raises ``ValueError`` naming the offending slots, their (s, u)
        values, the valid ranges, and this plan's ``repr()``.  A pad row
        is all −1; any partially-padded row is also an error.
        """
        if isinstance(pairs, PairsResult):
            problems: list[str] = []
            non_pad = 0
            cap = pairs.cap
            for w0, win in pairs.windows():
                errs = describe_pair_range_errors(win, self.n_upd,
                                                  self.n_sub)
                problems.extend(f"{e} [window at slot {w0}]"
                                for e in errs)
                non_pad += int(np.sum(win[:, 0] >= 0))
        else:
            arr = to_numpy(pairs)
            problems = describe_pair_range_errors(arr, self.n_upd,
                                                  self.n_sub)
            non_pad = int(np.sum(arr[:, 0] >= 0))
            cap = arr.shape[0]
        if count is not None:
            want = min(count, cap)
            if non_pad != want:
                problems.append(
                    f"buffer holds {non_pad} non-pad rows but the "
                    f"reported count is {count} (capacity {cap})")
        if problems:
            raise ValueError("invalid pair buffer: "
                             + "; ".join(problems) + f"; plan={self!r}")

    # -- masks --------------------------------------------------------------
    def mask(self, S: Regions, U: Regions) -> torch.Tensor:
        """(n, m) boolean overlap mask (algorithm-independent)."""
        self._check(S, U)
        if self.spec.backend == "distributed":
            raise NotImplementedError(
                "distributed backend supports count/pairs/query; a dense "
                "(n, m) mask is not sharded — use backend='torch'/'cuda'")
        if S.n == 0 or U.n == 0:
            return torch.zeros((S.n, U.n), dtype=torch.bool,
                               device=self.device)
        if self.spec.backend == "cuda":
            from ..kernels import ops
            return ops.bfm_mask_cuda(S, U)
        return brute.bfm_mask(S, U)

    # -- dynamic-service batched query (paper §3) ---------------------------
    def query(self, tree: itm.ITree, opp: Regions, q_lo, q_hi):
        """Verified d-dim overlap ids for a batch of query boxes.

        ``tree`` indexes dim 0 of the ``opp`` regions; ``q_lo``/``q_hi``
        are (b, d).  Returns ``(ids (b, cap) −1-padded, counts (b,))``,
        int32, with ``cap`` resolved by the capacity policy (``grow``
        memoizes a power of two, the ``DDMService`` path).  The walk is
        K8 on the cuda backend; dims 1+ are verified by gathers.  Under
        ``backend="distributed"`` the rows are sharded over the ranks
        (K8 on each), the tree and ``opp`` are replicated, one
        ``all_reduce(MAX)`` of the dim-0 counts sizes ``cap``, and every
        rank gets the whole answer; integer query dtypes raise
        ``TypeError``.
        """
        b = int(q_lo.shape[0])
        if b == 0 or opp.n == 0:
            return (torch.full((b, 1), -1, dtype=torch.int32,
                               device=self.device),
                    torch.zeros((b,), dtype=torch.int32, device=self.device))
        for name, x in (("tree", tree.lo), ("opp", opp.lo), ("q_lo", q_lo),
                        ("q_hi", q_hi)):
            if x.device.type != self.device.type:
                raise ValueError(f"{name} lives on {x.device} but the plan "
                                 f"runs on {self.device}")
        if self.spec.backend == "distributed":
            return self._query_distributed(tree, opp, q_lo, q_hi)
        q_lo, q_hi = q_lo.float(), q_hi.float()
        order = self._itm_order(q_lo[:, 0])
        counts0 = self._itm_counts(tree, q_lo[:, 0], q_hi[:, 0], order)
        cap = self._resolve_query_cap(int(counts0.max()))
        if self.spec.backend == "cuda":
            from ..kernels import ops
            return ops.itm_query_pairs_dd_cuda(tree, opp.lo, opp.hi, q_lo,
                                               q_hi, cap, order)
        return itm.itm_query_pairs_dd(tree, opp.lo, opp.hi, q_lo, q_hi, cap)

    def _resolve_query_cap(self, need: int) -> int:
        """Per-query id-buffer capacity under the plan's policy."""
        need = max(need, 1)
        pol = self.spec.capacity
        if pol == "fixed":
            return self._note("query", max(self.spec.max_pairs, 1))
        if pol == "exact":
            return self._note("query", need)
        self._query_cap = max(self._query_cap, _pow2(need))
        return self._note("query", self._query_cap)

    def _query_distributed(self, tree: itm.ITree, opp: Regions, q_lo, q_hi):
        from . import distributed as dist_mod
        group = dist_mod.resolve_group(self.spec.group, self.device)
        rows = dist_mod._query_rows(q_lo, q_hi, group=group)
        cap = self._resolve_query_cap(
            dist_mod._dist_query_counts(tree, rows, group=group))
        return dist_mod._dist_query(tree, opp.lo, opp.hi, rows, cap=cap,
                                    group=group)


# ---------------------------------------------------------------------------
# engine-level helpers
# ---------------------------------------------------------------------------

def _wrap_pairs(pairs, k: int):
    """Uniform ``(PairsResult, count)`` return for ``pairs()``."""
    if isinstance(pairs, PairsResult):
        return pairs, k
    return DensePairs(pairs, k), k


def select_rows(rows: torch.Tensor, keep: torch.Tensor,
                cap: int) -> torch.Tensor:
    """Rows where ``keep`` holds, in order, −1-padded (or cut) to ``cap``."""
    sel = torch.nonzero(keep).flatten()[:cap]
    out = torch.full((cap,) + tuple(rows.shape[1:]), -1, dtype=rows.dtype,
                     device=rows.device)
    out[:sel.shape[0]] = rows[sel]
    return out


def itm_flatten_pairs(ids: torch.Tensor, cap: int) -> torch.Tensor:
    """Flatten a (b, per_q) walk buffer into (id, query) rows, int32
    (cap, 2), in query order then DFS order, −1-padded (or cut)."""
    q = torch.arange(ids.shape[0], dtype=torch.int32, device=ids.device)
    rows = torch.stack([ids.flatten(),
                        q[:, None].expand(ids.shape).flatten()], dim=1)
    return select_rows(rows, (ids >= 0).flatten(), cap)


def describe_pair_range_errors(arr: np.ndarray, m: int,
                               n: int | None = None,
                               max_report: int = 5) -> list[str]:
    """Human-readable index-range problems in a −1-padded pair buffer.

    ``arr`` is a host (cap, 2) int array; ``m``/``n`` are the update/
    subscription set sizes.  Returns one message per problem class,
    each naming up to ``max_report`` offending slots with their (s, u)
    values and the valid range.
    """
    def _offenders(slots):
        shown = ", ".join(
            f"slot {int(t)}: (s={int(arr[t, 0])}, u={int(arr[t, 1])})"
            for t in slots[:max_report])
        more = f", … {len(slots) - max_report} more" \
            if len(slots) > max_report else ""
        return shown + more

    problems: list[str] = []
    non_pad = arr[:, 0] >= 0
    bad_u = np.nonzero(non_pad & ((arr[:, 1] < 0) | (arr[:, 1] >= m)))[0]
    if bad_u.size:
        problems.append(
            f"{bad_u.size} update index(es) outside [0, {m}): "
            + _offenders(bad_u))
    if n is not None:
        bad_s = np.nonzero(non_pad & (arr[:, 0] >= n))[0]
        if bad_s.size:
            problems.append(
                f"{bad_s.size} subscription index(es) outside [0, {n}): "
                + _offenders(bad_s))
    half_pad = np.nonzero(~non_pad & (arr[:, 1] >= 0))[0]
    if half_pad.size:
        problems.append(
            f"{half_pad.size} half-padded row(s) (s is −1 pad but u is "
            "not): " + _offenders(half_pad))
    return problems


def sbm_verify_dims(S: Regions, U: Regions, cand: torch.Tensor,
                    max_pairs: int):
    """Filter dim-0 candidate pairs on dimensions 1..d-1, recompact.

    Returns ``(pairs, count)``: the surviving candidates in candidate
    order, −1-padded to ``max_pairs``, and their exact number.
    """
    s_idx, u_idx = cand[:, 0].long(), cand[:, 1].long()
    valid = s_idx >= 0
    si = s_idx.clamp(min=0)
    ui = u_idx.clamp(min=0)
    ok = ((S.lo[si, 1:] < U.hi[ui, 1:])
          & (U.lo[ui, 1:] < S.hi[si, 1:])).all(dim=-1)
    ok &= valid
    return select_rows(cand, ok, max_pairs), host_read(ok.sum())


@functools.lru_cache(maxsize=256)
def build_plan(spec: MatchSpec, n_sub: int, n_upd: int, d: int,
               key: Any = None) -> MatchPlan:
    """Build ``spec`` for a problem shape; memoized on all arguments.

    Returns the same ``MatchPlan`` (with its resolved capacities) for
    repeated identical requests.  ``key`` is a namespace hook: callers
    whose memoized capacities must not be shared across otherwise
    identical requests pass a distinct hashable key.
    """
    return MatchPlan(spec, n_sub, n_upd, d)
