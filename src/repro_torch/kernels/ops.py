"""Public wrappers that put the CUDA kernels on the engine's paths.

The port's counterpart of the JAX package's ``kernels/ops.py``:

* BFM: ``bfm_count_cuda`` (kernel K3, tile counts summed in int64 on
  the device), ``bfm_mask_cuda`` (K4) and ``bfm_pairs_cuda`` (K4, then
  the library's row-major compaction, which the reference left to XLA);
* SBM: ``sbm_count_cuda`` (K1) and ``twopass_pairs_cuda``, whose pass 2
  takes one of four routes: ``resident`` (K2), ``streaming`` (K5),
  ``csr`` (a lazy ``CSRPairs`` view decoded by K6) or ``xla`` (the plain
  torch pass 2, ``core.sbm.sbm_pairs``);
* hsbm: ``hsbm_pairs_cuda``, the same four routes on the hybrid's
  emitter-slot tables (``HsbmCSRPairs`` on csr);
* ITM: ``itm_query_counts_cuda``, ``itm_query_pairs_cuda`` and
  ``itm_query_pairs_dd_cuda``, the tree walk in K8 (the reference's
  vmapped ``while_loop``); the dims-1+ verify stays gathers and compares,
  as the reference leaves it to XLA.

Sorts, searchsorted, the offset scan and the table compaction around the
kernels stay library calls, as they were XLA outside Pallas in the
reference.  The kernels run for regions on the card; regions on the CPU
take the kernels' plain versions.

Emit-route policy for Hopper.  On the TPU the routes were forced by an
8 MiB VMEM budget; on the card every route runs at any size int32 slot
ids allow, so the policy is about where the tables are served from.
The budget is the H100's 50 MB L2 (``EMIT_L2_TABLE_BUDGET``, which tests
monkeypatch).  ``resident`` (K2) searches and gathers all five pass-1
tables at random, 16 B per emitter: chosen while they fit, up to
n + m ≈ 3.1e6.  ``streaming`` (K5) stages its table window per CTA in
shared memory and gathers only the two permutations at random, 4 B per
emitter: chosen while they fit, up to n + m ≈ 1.25e7.  Past that the
quadratic-K regime holds the O(K) buffer too, so ``csr`` returns the
O(n + m) view instead; callers that need a dense buffer (the engine's
d > 1 verify pass) get ``xla``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import brute, itm, sbm
from ..core.engine import EMIT_ROUTES
from ..core.pairs import PairsResult
from ..core.regions import Regions
from . import bfm as bfm_kernel
from . import emit as emit_kernel
from . import itm as itm_kernel
from . import sbm_sweep as sweep_kernel

# the H100's L2, the cache that serves the emit tables (bytes)
EMIT_L2_TABLE_BUDGET = 50 * 10 ** 6

# last route taken by twopass_pairs_cuda (None before any call / after
# an empty-set short-circuit), so tests can see which path ran
_LAST_EMIT_ROUTE: str | None = None


def last_emit_route() -> str | None:
    return _LAST_EMIT_ROUTE


# ---------------------------------------------------------------------------
# BFM: kernels K3 and K4
# ---------------------------------------------------------------------------

def _pad_regions(lo, hi, mult: int):
    """Pad (N, d) bounds to a multiple of ``mult`` rows with regions that
    match nothing (lo = +inf, hi = -inf)."""
    pad = (-lo.shape[0]) % mult
    if pad:
        lo = torch.cat([lo, lo.new_full((pad, lo.shape[1]), float("inf"))])
        hi = torch.cat([hi, hi.new_full((pad, hi.shape[1]), float("-inf"))])
    return lo, hi


def bfm_count_cuda(S: Regions, U: Regions, *, ts: int = 256,
                   tu: int = 256) -> int:
    """Total K via the K3 tile-count kernel (any d, any n/m), exact int64."""
    if S.n == 0 or U.n == 0:
        return 0
    s_lo, s_hi = _pad_regions(S.lo, S.hi, ts)
    u_lo, u_hi = _pad_regions(U.lo, U.hi, tu)
    tiles = bfm_kernel.bfm_tile_counts(s_lo, s_hi, u_lo, u_hi, ts=ts, tu=tu)
    return sbm._total(tiles)


def bfm_mask_cuda(S: Regions, U: Regions) -> torch.Tensor:
    """(n, m) bool overlap mask via the K4 kernel."""
    if S.n == 0 or U.n == 0:
        return torch.zeros((S.n, U.n), dtype=torch.bool, device=S.device)
    return bfm_kernel.bfm_mask(S.lo, S.hi, U.lo, U.hi)


def bfm_pairs_cuda(S: Regions, U: Regions, max_pairs: int):
    """Enumerate overlapping pairs from the K4 mask (any d).

    Returns ``(pairs int32 (max_pairs, 2) −1-padded, exact count)``, in
    row-major mask order.  The compaction is the library's nonzero.
    """
    if S.n == 0 or U.n == 0:
        return torch.full((max_pairs, 2), -1, dtype=torch.int32,
                          device=S.device), 0
    if S.n * U.n > np.iinfo(np.int32).max:
        # the reference ravels the mask to flat int32 indices, which
        # alias past INT32_MAX; the port keeps its bound and message so
        # both packages take the same inputs on this path
        raise ValueError(
            f"bfm pair enumeration ravels an (n, m) = ({S.n}, {U.n}) "
            f"mask to flat int32 indices; n*m = {S.n * U.n} exceeds "
            f"INT32_MAX = {np.iinfo(np.int32).max}. Use the sbm/itm "
            "two-pass emit path at this scale (MatchSpec(algo='sbm')).")
    return brute.compact_mask_pairs(bfm_mask_cuda(S, U), max_pairs)


# ---------------------------------------------------------------------------
# SBM: kernel K1, and the pass-2 routes K2 / K5 / K6
# ---------------------------------------------------------------------------

def _sweep(s_lo, s_hi, u_lo, u_hi) -> torch.Tensor:
    """Per-endpoint sweep counts: library lex-sort, then kernel K1."""
    is_lo, is_upd = sbm._endpoint_stream(s_lo, s_hi, u_lo, u_hi)
    return sweep_kernel.sbm_sweep(is_lo, is_upd)


def sbm_count_cuda(S: Regions, U: Regions) -> int:
    """Total K via sort + the K1 sweep kernel (1-D regions), exact int64."""
    assert S.d == 1
    if S.n == 0 or U.n == 0:
        return 0
    c = _sweep(S.lo[:, 0], S.hi[:, 0], U.lo[:, 0], U.hi[:, 0])
    return sbm._total(c)


def emit_route_bytes(n: int, m: int) -> dict:
    """Bytes each dense pass-2 route reads at random, and so wants in L2.

    ``resident``: offsets (n+m+1), counts and starts (n+m each) and the
    two permutations (n + m), int32.  ``streaming``: the permutations
    only; the packed table streams through shared memory per tile.
    (``csr`` decodes windows on demand and needs no budget.)
    """
    e = n + m
    return {"resident": 4 * ((e + 1) + 2 * e + e), "streaming": 4 * e}


def choose_emit_route(n: int, m: int, *, budget: int | None = None,
                      dense_only: bool = False) -> str:
    """The first dense route whose ``emit_route_bytes`` fit ``budget``.

    ``resident``, then ``streaming``, then ``csr``, or ``xla`` when
    ``dense_only`` (the caller needs a dense buffer).  ``budget=None``
    reads ``EMIT_L2_TABLE_BUDGET``.
    """
    budget = EMIT_L2_TABLE_BUDGET if budget is None else budget
    need = emit_route_bytes(n, m)
    if need["resident"] <= budget:
        return "resident"
    if need["streaming"] <= budget:
        return "streaming"
    return "xla" if dense_only else "csr"


class CSRPairs(PairsResult):
    """Lazy ``PairsResult`` over the CSR emit form — decode on demand.

    Holds only pass 1's packed compacted table and the two sort
    permutations on the device (O(n+m) words, never O(K)).
    ``decode(start, stop)`` writes just that slot window through kernel
    K6 (its plain version for CPU tensors), bit-identical to the dense
    buffer's same slice, −1 pads past the true count included.
    ``windows()``, ``to_dense()`` and ``__array__`` come from
    ``PairsResult``; large-K callers iterate ``windows()``.
    """

    def __init__(self, tab, perm_s, perm_u, *, cap: int, count: int,
                 device=None):
        self.tab = tab
        self.perm_s = perm_s
        self.perm_u = perm_u
        self.cap = int(cap)
        self.count = int(count)
        self.device = tab.device if tab is not None else torch.device(device)

    @classmethod
    def empty(cls, cap: int, device) -> "CSRPairs":
        """All-pad view (empty region sets)."""
        return cls(None, None, None, cap=cap, count=0, device=device)

    @property
    def nbytes(self) -> int:
        """Device bytes actually held (the compressed form)."""
        if self.tab is None:
            return 0
        return 4 * (self.tab.numel() + self.perm_s.numel()
                    + self.perm_u.numel())

    def decode(self, start: int = 0, stop: int | None = None):
        stop = self._check_window(start, stop)
        if self.tab is None:
            return torch.full((stop - start, 2), -1, dtype=torch.int32,
                              device=self.device)
        return emit_kernel.csr_decode_window(self.tab, self.perm_s,
                                             self.perm_u, start, stop - start)

    def __repr__(self) -> str:
        return (f"CSRPairs(cap={self.cap}, count={self.count}, "
                f"nbytes={self.nbytes}, dense_nbytes={self.dense_nbytes})")


def _phase1(S: Regions, U: Regions, max_pairs: int):
    return sbm._twopass_phase1(S.lo[:, 0], S.hi[:, 0], U.lo[:, 0],
                               U.hi[:, 0], max_pairs)


def twopass_pairs_csr(S: Regions, U: Regions, max_pairs: int):
    """CSR emit route: ``(CSRPairs view, exact count)``.

    Same count and truncation contract as the dense routes; the dense
    ``(max_pairs, 2)`` buffer is never materialized.
    """
    assert S.d == 1
    if S.n == 0 or U.n == 0:
        return CSRPairs.empty(max_pairs, S.device), 0
    perm_s, perm_u, starts, counts, offs, cnt_a, cnt_b = _phase1(
        S, U, max_pairs)
    tab = emit_kernel.pack_emitter_tables(offs, counts, starts, n=S.n,
                                          m=U.n)
    count = sbm._total(cnt_a) + sbm._total(cnt_b)
    return CSRPairs(tab, perm_s, perm_u, cap=max_pairs, count=count), count


def _check_route(route: str, dense_only: bool) -> None:
    if route not in EMIT_ROUTES:
        raise ValueError(f"route must be one of {EMIT_ROUTES}, got {route}")
    if dense_only and route == "csr":
        raise ValueError(
            "emit_route='csr' returns a lazy CSRPairs view, but this "
            "caller needs a dense candidate buffer (d > 1 verify path); "
            "pin 'streaming'/'xla' or leave 'auto'")


def _dense_pass2(route: str, offs, counts, starts, perm_s, perm_u, *,
                 max_pairs: int, block: int) -> torch.Tensor:
    """Pass 2 on the ``resident`` (K2) or ``streaming`` (K5) route."""
    if route == "resident":
        return emit_kernel.twopass_emit(offs, counts, starts, perm_s,
                                        perm_u, max_pairs=max_pairs)
    bl = emit_kernel.lane_pad(block)
    tab = emit_kernel.pack_emitter_tables(
        offs, counts, starts, n=perm_s.shape[0], m=perm_u.shape[0],
        min_len=emit_kernel.stream_window(bl))
    return emit_kernel.twopass_emit_streaming(tab, perm_s, perm_u,
                                              max_pairs=max_pairs, block=bl)


def twopass_pairs_cuda(S: Regions, U: Regions, max_pairs: int, *,
                       route: str = "auto",
                       block: int = emit_kernel.DEF_BLOCK,
                       budget: int | None = None, dense_only: bool = False):
    """Exact 1-D pair enumeration, pass 2 in one of the emit kernels.

    Same contract as ``core.sbm.sbm_pairs``: ``(pairs, exact count)``;
    truncation still reports the true K.  ``pairs`` is a dense int32
    ``(max_pairs, 2)`` −1-padded tensor on the regions' device on the
    resident/streaming/xla routes and a lazy ``CSRPairs`` view (same
    decoded contents) on the csr route.  ``route="auto"`` applies
    ``choose_emit_route``; a pinned route bypasses the policy.
    ``dense_only=True`` keeps ``auto`` off csr and rejects a pinned csr.
    ``block`` is K5's tile of slots.
    """
    global _LAST_EMIT_ROUTE
    assert S.d == 1
    _check_route(route, dense_only)
    if S.n == 0 or U.n == 0:
        _LAST_EMIT_ROUTE = None
        return torch.full((max_pairs, 2), -1, dtype=torch.int32,
                          device=S.device), 0
    if route == "auto":
        route = choose_emit_route(S.n, U.n, budget=budget,
                                  dense_only=dense_only)
    _LAST_EMIT_ROUTE = route
    if route == "xla":
        return sbm.sbm_pairs(S, U, max_pairs)
    if route == "csr":
        return twopass_pairs_csr(S, U, max_pairs)
    perm_s, perm_u, starts, counts, offs, cnt_a, cnt_b = _phase1(
        S, U, max_pairs)
    pairs = _dense_pass2(route, offs, counts, starts, perm_s, perm_u,
                         max_pairs=max_pairs, block=block)
    return pairs, sbm._total(cnt_a) + sbm._total(cnt_b)


# ---------------------------------------------------------------------------
# hsbm: the hybrid's emitter-slot tables through K2 / K5 / K6
# ---------------------------------------------------------------------------

class HsbmCSRPairs(CSRPairs):
    """``CSRPairs`` over the hybrid pass 1, decoding to region ids.

    The packed table and the "permutations" (the shifted id tables
    ``sid + n_a``, ``uid + n_b``) live in the hybrid's emitter-slot
    space; ``decode`` runs K6 (its plain version for CPU tensors) and
    then ``kernels.emit.remap_slot_pairs``, so every window equals the
    same slice of the hybrid's plain pass 2, −1 pads included.
    """

    def __init__(self, tab, perm_s, perm_u, *, sid, uid, cap: int,
                 count: int):
        super().__init__(tab, perm_s, perm_u, cap=cap, count=count)
        self.sid = sid
        self.uid = uid

    @property
    def nbytes(self) -> int:
        """The compressed form plus the id tables it decodes through."""
        return super().nbytes + 4 * (self.sid.numel() + self.uid.numel())

    def decode(self, start: int = 0, stop: int | None = None):
        out = super().decode(start, stop)
        return emit_kernel.remap_slot_pairs(out, self.sid, self.uid)


def hsbm_pairs_cuda(S: Regions, U: Regions, max_pairs: int, *,
                    ncells: int | None = None, route: str = "auto",
                    block: int = emit_kernel.DEF_BLOCK,
                    budget: int | None = None, dense_only: bool = False):
    """Hybrid grid+SBM pair enumeration through the emit kernels.

    ``twopass_pairs_cuda``'s contract and route policy, with the
    hybrid's flattened emitter tables in the place of the n and m
    emitters: ``choose_emit_route`` sees the padded table sizes
    ``n_emit_s``/``n_emit_u``, and K2, K5 and K6 get the shifted id
    tables in the permutations' place, then ``remap_slot_pairs`` maps
    their slot-space output to region ids (``HsbmCSRPairs`` on csr).
    ``xla`` is the plain hybrid pass 2.  The geometry is measured on the
    host (``core.sbm.hsbm_inputs``); ``ncells`` overrides its cell count.
    """
    global _LAST_EMIT_ROUTE
    assert S.d == 1
    _check_route(route, dense_only)
    if S.n == 0 or U.n == 0:
        _LAST_EMIT_ROUTE = None
        return torch.full((max_pairs, 2), -1, dtype=torch.int32,
                          device=S.device), 0
    b, g, lb, width = sbm.hsbm_inputs(S, U, ncells)
    n_a, n_b = g.n_emit_s, g.n_emit_u
    if route == "auto":
        route = choose_emit_route(n_a, n_b, budget=budget,
                                  dense_only=dense_only)
    _LAST_EMIT_ROUTE = route
    if route == "xla":
        pairs, counts = sbm._hsbm_emit(*b, lb, width, max_pairs=max_pairs,
                                       **g.statics())
        return pairs, sbm._total(counts)
    sid, uid, starts, counts, offs = sbm._hsbm_phase1(
        *b, lb, width, max_pairs=max_pairs, **g.statics())
    count = sbm._total(counts)
    ps, pu = sid + n_a, uid + n_b
    if route == "csr":
        tab = emit_kernel.pack_emitter_tables(offs, counts, starts, n=n_a,
                                              m=n_b)
        return HsbmCSRPairs(tab, ps, pu, sid=sid, uid=uid, cap=max_pairs,
                            count=count), count
    slots = _dense_pass2(route, offs, counts, starts, ps, pu,
                         max_pairs=max_pairs, block=block)
    return emit_kernel.remap_slot_pairs(slots, sid, uid), count


# ---------------------------------------------------------------------------
# ITM: kernel K8
# ---------------------------------------------------------------------------

def itm_query_counts_cuda(tree: itm.ITree, q_lo, q_hi,
                          order=None) -> torch.Tensor:
    """Per-query overlap counts, int32 (b,), via K8's count instance;
    ``order`` is K8's query order (``kernels.itm.query_order``), sorted
    here when not given."""
    return itm_kernel.itm_walk(tree, q_lo, q_hi, order=order)[1]


def itm_query_pairs_cuda(tree: itm.ITree, q_lo, q_hi, cap: int,
                         order=None):
    """``(ids int32 (b, cap), counts int32 (b,))`` via K8: each query's
    first ``cap`` hits in DFS order, −1 padded; counts go on past cap."""
    return itm_kernel.itm_walk(tree, q_lo, q_hi, cap, order=order)


def itm_query_pairs_dd_cuda(tree: itm.ITree, o_lo, o_hi, q_lo, q_hi,
                            cap: int, order=None):
    """``core.itm.itm_query_pairs_dd`` with the dim-0 walk in K8."""
    ids, _ = itm_query_pairs_cuda(tree, q_lo[:, 0], q_hi[:, 0], cap, order)
    return itm.verify_dims(ids, o_lo, o_hi, q_lo, q_hi)
