"""Sort-Based Matching — paper Algorithms 4/6/7, as plain torch.

The port's counterpart of the JAX package's ``core/sbm.py``: 1-D flat
SBM and the hybrid grid+SBM (``hsbm_pairs``).  For counting, the sweep's active sets collapse to integers, so the sweep is
a prefix sum over the lex-sorted endpoint stream:

* ``sbm_count_sweep``   — one lex-sort + one cumsum;
* ``sbm_count_chunked`` — the explicit P-segment form of Alg. 6/7;
* ``sbm_count_binary``  — Li et al.'s two sorted arrays + searchsorted,
  which also gives per-subscription counts.

Pair enumeration is the exact two-pass count-then-emit: pass 1
(``_twopass_phase1``) gives per-emitter counts and saturated slot
offsets, pass 2 (``_twopass_slots``) writes each output slot's pair.
Everything here runs on whatever device its tensors live on; it is the
``backend="torch"`` path and the plain version the CUDA kernels are
held against (``kernels/ref.py``).

Bit-identity with the JAX package rests on sorting exactly as it does:
``jnp.argsort`` and ``jnp.lexsort`` are stable, ``torch.argsort`` is
not unless asked, so every sort here passes ``stable=True``.  The
hybrid's per-cell key sort is unstable in the reference, so its slot
order is not defined there; the port sorts stably, and hsbm pairs agree
with the reference as sets, with K and the per-cell counts exact.

Endpoint ordering: half-open intervals require upper endpoints to be
processed *before* lower endpoints at equal coordinate, so ``[a,b)`` and
``[b,c)`` never match.  Precondition: regions are non-empty
(``lo < hi``), as in the paper.
"""
from __future__ import annotations

import torch

from ..spans import host_read, span
from . import grid
from .regions import Regions

_I32 = torch.int32


def _lexsort2(secondary: torch.Tensor, primary: torch.Tensor):
    """``jnp.lexsort((secondary, primary))``: order by ``primary``, ties
    by ``secondary``, ties of both in input order (two stable sorts)."""
    o1 = torch.argsort(secondary, stable=True)
    return o1[torch.argsort(primary[o1], stable=True)]


# ---------------------------------------------------------------------------
# endpoint stream construction and the counting sweep
# ---------------------------------------------------------------------------

def _endpoints_flat(s_lo, s_hi, u_lo, u_hi):
    """Unsorted endpoint stream of one dimension in host order (S lows, S
    highs, U lows, U highs): ``(v, is_lo, is_upd)``, int32 flags."""
    v = torch.cat([s_lo, s_hi, u_lo, u_hi])
    n, m = s_lo.shape[0], u_lo.shape[0]
    dev = v.device
    ones = torch.ones(2 * max(n, m), dtype=_I32, device=dev)
    zeros = torch.zeros_like(ones)
    is_lo = torch.cat([ones[:n], zeros[:n], ones[:m], zeros[:m]])
    is_upd = torch.cat([zeros[:2 * n], ones[:2 * m]])
    return v, is_lo, is_upd


def _endpoint_stream(s_lo, s_hi, u_lo, u_hi):
    """Lex-sorted endpoint stream of one dimension: ``(is_lo, is_upd)``,
    int32 ``(2(n+m),)`` in sweep order (value asc, hi before lo)."""
    with span("sbm.endpoint_sort"):
        v, is_lo, is_upd = _endpoints_flat(s_lo, s_hi, u_lo, u_hi)
        order = _lexsort2(is_lo, v)
        return is_lo[order], is_upd[order]


def _stream_contribs(is_lo, is_upd):
    """Per-endpoint report counts of the sweep over a lex-sorted stream.

    At each *upper* endpoint the sweep reports the region against every
    active region of the opposite kind (Alg. 4 lines 12/18): the current
    active count of that kind, an inclusive prefix sum of ±1 deltas.
    This is kernel K1's plain version (``kernels.ref.sbm_sweep``).
    """
    is_hi = 1 - is_lo
    is_sub = 1 - is_upd
    upd_active = (torch.cumsum(is_upd * is_lo, 0)
                  - torch.cumsum(is_upd * is_hi, 0))
    sub_active = (torch.cumsum(is_sub * is_lo, 0)
                  - torch.cumsum(is_sub * is_hi, 0))
    return (is_hi * (is_sub * upd_active + is_upd * sub_active)).to(_I32)


def _sweep_contribs(s_lo, s_hi, u_lo, u_hi) -> torch.Tensor:
    """Per-endpoint report counts of the SBM sweep (int32, (2(n+m),))."""
    return _stream_contribs(*_endpoint_stream(s_lo, s_hi, u_lo, u_hi))


def _total(c: torch.Tensor) -> int:
    """Exact int64 sum of per-item counts as a python int, read to the
    host through ``spans.host_read``."""
    return host_read(c.sum(dtype=torch.int64))


def sbm_count_sweep(S: Regions, U: Regions) -> int:
    """Total K by the sweep-as-prefix-sum formulation (1-D regions)."""
    assert S.d == 1, "sbm_count_sweep is the 1-D primitive"
    return _total(_sweep_contribs(S.lo[:, 0], S.hi[:, 0],
                                  U.lo[:, 0], U.hi[:, 0]))


# ---------------------------------------------------------------------------
# Alg. 6/7 structure made explicit: P segments, local scans, prefix combine
# ---------------------------------------------------------------------------

def _chunked_contribs(s_lo, s_hi, u_lo, u_hi, p: int) -> torch.Tensor:
    """Counting SBM with the paper's explicit 3-step structure (Alg. 7).

    Step ①: each of the ``p`` segments scans its ±1 deltas locally.
    Step ②: exclusive scan over the segment totals.
    Step ③: local sweeps seeded with those initial counts.
    Identical output to ``_sweep_contribs``.
    """
    is_lo, is_upd = _endpoint_stream(s_lo, s_hi, u_lo, u_hi)
    tot = is_lo.shape[0]
    if tot == 0:
        return is_lo
    pad = (-tot) % p
    dev = is_lo.device
    # sentinel endpoints: sub-lo at the stream end contribute nothing
    is_lo = torch.cat([is_lo, torch.ones(pad, dtype=_I32, device=dev)])
    is_upd = torch.cat([is_upd, torch.zeros(pad, dtype=_I32, device=dev)])
    seg = is_lo.shape[0] // p
    is_lo = is_lo.reshape(p, seg)
    is_upd = is_upd.reshape(p, seg)
    is_hi, is_sub = 1 - is_lo, 1 - is_upd

    d_upd = is_upd * (is_lo - is_hi)
    d_sub = is_sub * (is_lo - is_hi)
    upd_local = torch.cumsum(d_upd, 1)                     # step ①
    sub_local = torch.cumsum(d_sub, 1)
    zero = torch.zeros(1, dtype=upd_local.dtype, device=dev)
    upd_carry = torch.cat([zero, torch.cumsum(upd_local[:-1, -1], 0)])
    sub_carry = torch.cat([zero, torch.cumsum(sub_local[:-1, -1], 0)])
    upd_active = upd_local + upd_carry[:, None]            # step ②③
    sub_active = sub_local + sub_carry[:, None]
    contrib = is_hi * (is_sub * upd_active + is_upd * sub_active)
    return contrib.reshape(-1)[:tot].to(_I32)


def sbm_count_chunked(S: Regions, U: Regions, p: int = 8) -> int:
    assert S.d == 1
    return _total(_chunked_contribs(S.lo[:, 0], S.hi[:, 0],
                                    U.lo[:, 0], U.hi[:, 0], p))


# ---------------------------------------------------------------------------
# Binary-search variant (Li et al. [38]) — per-region counts
# ---------------------------------------------------------------------------

def sbm_count_per_sub(S: Regions, U: Regions) -> torch.Tensor:
    """K_s for every subscription region (1-D regions), int32 (n,).

    K_s = |{u : u.lo < s.hi}| − |{u : u.hi ≤ s.lo}|  (non-empty intervals).
    """
    s_lo, s_hi = S.lo[:, 0].contiguous(), S.hi[:, 0].contiguous()
    u_lo = torch.sort(U.lo[:, 0]).values
    u_hi = torch.sort(U.hi[:, 0]).values
    below = torch.searchsorted(u_lo, s_hi, right=False)
    gone = torch.searchsorted(u_hi, s_lo, right=True)
    return (below - gone).to(_I32)


def sbm_count_binary(S: Regions, U: Regions) -> int:
    return _total(sbm_count_per_sub(S, U))


# ---------------------------------------------------------------------------
# Pair enumeration — exact two-pass count-then-emit
# ---------------------------------------------------------------------------
#
# Every overlap (s, u) of non-empty half-open intervals falls into exactly
# one of two classes:
#
#   A: u.lo ∈ [s.lo, s.hi)  — in lo-sorted U the range [aA_s, rA_s).
#   B: u.lo < s.lo < u.hi   — in lo-sorted S the range [bB_u, cB_u).
#
# Both are searchsorted ranges, so pass 1 yields exact per-emitter
# counts, a scan yields output offsets, and pass 2 emits every pair into
# its slot in parallel.  The scan saturates at max_pairs so slot
# arithmetic stays in int32 past the buffer; the exact K is the int64
# sum of the unclipped counts.

def _twopass_phase1(s_lo, s_hi, u_lo, u_hi, max_pairs: int):
    """Pass 1 of count-then-emit: per-emitter counts and slot offsets.

    Returns ``(perm_s, perm_u, starts, counts, offs, cnt_a, cnt_b)``, all
    int32: ``starts``/``counts`` are the concatenated per-emitter input
    offsets and unclipped pair counts (n class-A emitters, then m
    class-B), ``offs`` the (n+m+1,) exclusive-scan output offsets
    saturated at ``max_pairs``.
    """
    with span("sbm.pass1"):
        s_lo, s_hi = s_lo.contiguous(), s_hi.contiguous()
        u_lo, u_hi = u_lo.contiguous(), u_hi.contiguous()
        perm_u = torch.argsort(u_lo, stable=True)
        perm_s = torch.argsort(s_lo, stable=True)
        u_lo_sorted = u_lo[perm_u]
        s_lo_sorted = s_lo[perm_s]

        aA = torch.searchsorted(u_lo_sorted, s_lo, right=False)
        rA = torch.searchsorted(u_lo_sorted, s_hi, right=False)
        bB = torch.searchsorted(s_lo_sorted, u_lo, right=True)
        cB = torch.searchsorted(s_lo_sorted, u_hi, right=False)
        # the clamp guards the offsets against degenerate (lo == hi)
        # intervals, which break the precondition but must not corrupt
        # emission for the well-formed regions
        cnt_a = (rA - aA).clamp_(min=0).to(_I32)
        cnt_b = (cB - bB).clamp_(min=0).to(_I32)

        starts = torch.cat([aA, bB]).to(_I32)
        counts = torch.cat([cnt_a, cnt_b])
        # saturating scan: int64 cumsum clamped at the limit equals the
        # reference's min(a + b, lim) scan for counts >= 0
        incl = torch.cumsum(counts, 0,
                            dtype=torch.int64).clamp_(max=max_pairs)
        offs = torch.cat([torch.zeros(1, dtype=_I32, device=counts.device),
                          incl.to(_I32)])
        return (perm_s.to(_I32), perm_u.to(_I32), starts, counts, offs,
                cnt_a, cnt_b)


def _twopass_slots(offs, counts, starts, perm_s, perm_u, *, max_pairs: int):
    """Pass 2 on pass-1 tables: the ``(max_pairs, 2)`` int32 buffer.

    This is kernel K2's plain version (``kernels.ref.twopass_emit``):
    ``_twopass_window`` over slots ``[0, max_pairs)``.
    """
    return _twopass_window(offs, counts, starts, perm_s, perm_u, 0,
                           max_pairs)


def _twopass_window(offs, counts, starts, perm_s, perm_u, start: int,
                    stop: int):
    """Slots ``[start, stop)`` of pass 2, from the uncompacted tables.

    Slot ``t`` belongs to the last emitter ``e`` with ``offs[e] <= t``;
    its rank is ``j = t − offs[e]``; the partner comes from ``perm_u``
    (class A, ``e < n``) or ``perm_s`` (class B); ranks at or past the
    emitter's count give the −1 pad.  n and m are the permutations'
    lengths.
    """
    n, m = perm_s.shape[0], perm_u.shape[0]
    t = torch.arange(start, stop, dtype=_I32, device=offs.device)
    e = (torch.searchsorted(offs, t, right=True) - 1).clamp_(max=n + m - 1)
    j = t - offs[e]
    valid = (j >= 0) & (j < counts[e])
    is_a = e < n
    e_a = e.clamp(max=n - 1)
    e_b = (e - n).clamp_(0, m - 1)
    u_from_a = perm_u[(starts[e_a] + j).clamp_(0, m - 1).long()]
    s_from_b = perm_s[(starts[n + e_b] + j).clamp_(0, n - 1).long()]
    s_idx = torch.where(valid, torch.where(is_a, e_a.to(_I32), s_from_b), -1)
    u_idx = torch.where(valid, torch.where(is_a, u_from_a, e_b.to(_I32)), -1)
    return torch.stack([s_idx, u_idx], 1).to(_I32)


def _packed_window(tab, perm_s, perm_u, start: int, stop: int):
    """Slots ``[start, stop)`` of pass 2, from the compacted packed table.

    ``tab`` is ``kernels.emit.pack_emitter_tables``' int32 (4, E_pad)
    table (saturated offsets, counts, start ranks, original emitter ids;
    pads at offset INT32_MAX, count 0).  The owner of slot ``t`` is the
    last entry with offset ``<= t``; the rest is ``_twopass_window``'s
    rule, and the output is bit-identical to it.  This is the plain
    version of kernels K5 and K6 (``kernels.ref.twopass_emit_streaming``
    and ``kernels.ref.csr_decode_window``).
    """
    n, m = perm_s.shape[0], perm_u.shape[0]
    t = torch.arange(start, stop, dtype=_I32, device=tab.device)
    k = (torch.searchsorted(tab[0], t, right=True) - 1).clamp_(min=0)
    j = t - tab[0][k]
    e = tab[3][k]
    valid = (j >= 0) & (j < tab[1][k])
    r = tab[2][k] + j
    u_from_a = perm_u[r.clamp(0, m - 1).long()]
    s_from_b = perm_s[r.clamp(0, n - 1).long()]
    is_a = e < n
    s_idx = torch.where(valid, torch.where(is_a, e, s_from_b), -1)
    u_idx = torch.where(valid, torch.where(is_a, u_from_a, e - n), -1)
    return torch.stack([s_idx, u_idx], 1).to(_I32)


def _twopass_emit(s_lo, s_hi, u_lo, u_hi, max_pairs: int):
    """Both passes: ``(pairs, cnt_a, cnt_b)``."""
    perm_s, perm_u, starts, counts, offs, cnt_a, cnt_b = _twopass_phase1(
        s_lo, s_hi, u_lo, u_hi, max_pairs)
    pairs = _twopass_slots(offs, counts, starts, perm_s, perm_u,
                           max_pairs=max_pairs)
    return pairs, cnt_a, cnt_b


def sbm_pairs(S: Regions, U: Regions, max_pairs: int):
    """Enumerate 1-D overlaps exactly via two-pass count-then-emit.

    Returns ``(pairs, count)``: ``pairs`` is int32 (max_pairs, 2) padded
    with −1; ``count`` is the exact total K as a python int.  If
    ``count > max_pairs`` the buffer holds the first ``max_pairs`` pairs
    in emission order.  Empty S or U returns an all-−1 buffer, count 0.
    """
    assert S.d == 1
    if S.n == 0 or U.n == 0:
        return torch.full((max_pairs, 2), -1, dtype=_I32,
                          device=S.device), 0
    pairs, cnt_a, cnt_b = _twopass_emit(
        S.lo[:, 0], S.hi[:, 0], U.lo[:, 0], U.hi[:, 0], max_pairs)
    return pairs, _total(cnt_a) + _total(cnt_b)


# ---------------------------------------------------------------------------
# Hybrid grid+SBM (hsbm) — bucketed pass 1 feeding the same emit machinery
# ---------------------------------------------------------------------------
#
# Pass 1 of the flat path sorts every region globally.  The hybrid buckets
# regions by the grid cell of their lo (cell width >= the longest region,
# ``grid.hsbm_geometry``) and runs the class A / class B searchsorted
# ranges per cell, over (ncells, cap) rows:
#
#   * a pair's max(lo) cell is the partner's own cell or the one right of
#     it, so each cell's emitter table is [natives | boundary suffix]: the
#     suffix repeats the tail of cell c-1 whose regions can reach cell c;
#   * a pair is counted where the *partner* is native, exactly once.
#
# The per-emitter counts then feed the flat path's offset scan and pass 2:
# the plain slot loop below, or K2 / K5 / K6 (``kernels.ops``) with the
# shifted id tables in the permutations' place.

_I32_MAX = 2 ** 31 - 1


def _sortable_bits(x: torch.Tensor) -> torch.Tensor:
    """Monotone float32 -> int32 map (IEEE-754 total order): the
    reference's ``INT32_MIN - b`` for negative patterns ``b``, written as
    ``-(b & INT32_MAX)`` so nothing overflows; -0.0 and +0.0 both map to 0."""
    b = x.contiguous().view(_I32)
    return torch.where(b < 0, -(b & _I32_MAX), b)


def _hsbm_side_tables(lo, hi, lb, width, ncells: int, cap: int, suf: int):
    """Bucket one side into per-cell sorted tables.

    Returns ``(nat_bits, emit_bits, emit_ids)``: ``nat_bits`` is the
    (ncells, cap) sortable-bits lo table of each cell's natives (pads
    INT32_MAX, at the row end); ``emit_bits``/``emit_ids`` append ``suf``
    boundary-suffix columns repeated from the tail of the previous cell
    (ids are region indices, -1 pads).  ``lb``/``width`` are float32
    tensors on ``lo``'s device: the cell is ``floor((lo - lb) / width)``
    in float32, as ``grid.hsbm_geometry`` measured it.
    """
    n = lo.shape[0]
    dev = lo.device
    key, perm = torch.sort(_sortable_bits(lo), stable=True)
    cells = torch.floor((lo[perm] - lb) / width).to(_I32).clamp_(0,
                                                                 ncells - 1)
    perm = perm.to(_I32)
    # cells is monotone in sorted lo, so per-cell runs are contiguous
    starts = torch.searchsorted(
        cells, torch.arange(ncells, dtype=_I32, device=dev), out_int32=True)
    occ = torch.cat([starts[1:], starts.new_full((1,), n)]) - starts
    j = torch.arange(cap, dtype=_I32, device=dev)[None, :]
    nat_valid = j < occ[:, None]
    gi = (starts[:, None] + j).clamp_(0, n - 1)
    nat_bits = torch.where(nat_valid, key[gi], _I32_MAX)
    nat_ids = torch.where(nat_valid, perm[gi], -1)
    # boundary suffix: the last ``suf`` natives of cell c-1 (none for 0)
    k = torch.arange(suf, dtype=_I32, device=dev)[None, :]
    pocc = torch.roll(occ, 1)
    pocc[0] = 0
    pstart = torch.roll(starts, 1)
    pstart[0] = 0
    s_exists = ((pocc[:, None] - suf + k >= 0)
                & (torch.arange(ncells, device=dev)[:, None] > 0))
    sgi = (pstart[:, None] + pocc[:, None] - suf + k).clamp_(0, n - 1)
    sp_bits = torch.where(s_exists, key[sgi], _I32_MAX)
    sp_ids = torch.where(s_exists, perm[sgi], -1)
    return (nat_bits, torch.cat([nat_bits, sp_bits], 1),
            torch.cat([nat_ids, sp_ids], 1))


def _hsbm_phase1(s_lo, s_hi, u_lo, u_hi, lb, width, *, ncells: int,
                 cap_s: int, suf_s: int, cap_u: int, suf_u: int,
                 max_pairs: int):
    """Hybrid pass 1: per-emitter counts and slot offsets.

    Emitters are the flattened per-cell tables, S side first:
    ``n_emit_s = ncells·(cap_s+suf_s)`` class-A emitters (each scans a
    window of its cell's U natives), then ``n_emit_u`` class-B emitters
    (a window of S natives).  Returns ``(sid, uid, starts, counts,
    offs)``, int32: ``sid``/``uid`` map emitter rows to region indices
    (-1 pads), ``starts`` are window starts in the opposite side's
    flattened table, ``counts`` the unclipped per-emitter counts and
    ``offs`` the (E+1,) exclusive offsets saturated at ``max_pairs``
    (every entry, the first included; an int64 cumsum, so no int32 wrap
    past 2^30 as in the reference's ``min(a + b, lim)`` scan).
    """
    n, m = s_lo.shape[0], u_lo.shape[0]
    dev = s_lo.device
    s_nat, s_emit, s_ids = _hsbm_side_tables(s_lo, s_hi, lb, width, ncells,
                                             cap_s, suf_s)
    u_nat, u_emit, u_ids = _hsbm_side_tables(u_lo, u_hi, lb, width, ncells,
                                             cap_u, suf_u)

    def ss(rows, vals, right=False):
        return torch.searchsorted(rows, vals, right=right, out_int32=True)

    # class A: u.lo in [s.lo, s.hi) — a window of U natives per S emitter
    s_emit_hi = torch.where(s_ids >= 0, s_hi[s_ids.clamp(0, n - 1)],
                            float("inf"))
    aA = ss(u_nat, s_emit)
    cnt_a = (ss(u_nat, _sortable_bits(s_emit_hi)) - aA).clamp_(min=0)
    # class B: u.lo < s.lo < u.hi — right side excludes s.lo == u.lo
    u_emit_hi = torch.where(u_ids >= 0, u_hi[u_ids.clamp(0, m - 1)],
                            float("-inf"))
    bB = ss(s_nat, u_emit, right=True)
    cnt_b = (ss(s_nat, _sortable_bits(u_emit_hi)) - bB).clamp_(min=0)
    # window starts into the opposite side's flattened emitter table (row
    # stride natives + suffix); windows only cover the native prefix
    rows = torch.arange(ncells, dtype=_I32, device=dev)[:, None]
    starts = torch.cat([(aA + rows * (cap_u + suf_u)).reshape(-1),
                        (bB + rows * (cap_s + suf_s)).reshape(-1)])
    counts = torch.cat([cnt_a.reshape(-1), cnt_b.reshape(-1)])
    incl = torch.cumsum(counts, 0, dtype=torch.int64).clamp_(max=max_pairs)
    offs = torch.cat([torch.zeros(1, dtype=_I32, device=dev), incl.to(_I32)])
    return s_ids.reshape(-1), u_ids.reshape(-1), starts, counts, offs


def _hsbm_emit(s_lo, s_hi, u_lo, u_hi, lb, width, *, ncells: int,
               cap_s: int, suf_s: int, cap_u: int, suf_u: int,
               max_pairs: int):
    """Plain pass 2 of the hybrid: ``(pairs (max_pairs, 2), counts)``.

    The flat path's slot arithmetic (``_twopass_window``), with emitter
    and partner identities read through ``sid``/``uid``; ``counts`` is
    the unclipped per-emitter vector for the exact int64 K.
    """
    sid, uid, starts, counts, offs = _hsbm_phase1(
        s_lo, s_hi, u_lo, u_hi, lb, width, ncells=ncells, cap_s=cap_s,
        suf_s=suf_s, cap_u=cap_u, suf_u=suf_u, max_pairs=max_pairs)
    n_a, n_b = sid.shape[0], uid.shape[0]
    t = torch.arange(max_pairs, dtype=_I32, device=offs.device)
    e = (torch.searchsorted(offs, t, right=True, out_int32=True)
         - 1).clamp_(max=n_a + n_b - 1)
    j = t - offs[e]
    valid = (j >= 0) & (j < counts[e])
    is_a = e < n_a
    r = starts[e] + j
    s_idx = torch.where(is_a, sid[e.clamp(max=n_a - 1)],
                        sid[r.clamp(0, n_a - 1)])
    u_idx = torch.where(is_a, uid[r.clamp_(0, n_b - 1)],
                        uid[(e - n_a).clamp_(0, n_b - 1)])
    pairs = torch.stack([torch.where(valid, s_idx, -1),
                         torch.where(valid, u_idx, -1)], 1)
    return pairs, counts


def hsbm_inputs(S: Regions, U: Regions, ncells: int | None = None):
    """Dim-0 bounds of S and U, the measured ``grid.HsbmGeometry`` and
    its ``(lb, width)`` as float32 tensors on the regions' device.

    One copy of the four bound vectors to the host feeds the NumPy
    geometry; one copy back carries ``lb`` and ``width``.
    """
    b = (S.lo[:, 0], S.hi[:, 0], U.lo[:, 0], U.hi[:, 0])
    host = torch.cat(b).cpu().numpy()
    n, m = S.n, U.n
    g = grid.hsbm_geometry(host[:n], host[n:2 * n], host[2 * n:2 * n + m],
                           host[2 * n + m:], ncells=ncells)
    lw = torch.tensor([g.lb, g.width], dtype=torch.float32, device=S.device)
    return b, g, lw[0], lw[1]


def hsbm_pairs(S: Regions, U: Regions, max_pairs: int,
               ncells: int | None = None):
    """Enumerate 1-D overlaps through the hybrid grid+SBM (plain pass 2).

    Same contract as ``sbm_pairs`` (-1-padded buffer, exact K), another
    pass 1 and a cell-major emission order.  The geometry is measured on
    the host per call; ``ncells`` overrides the heuristic cell count.
    """
    assert S.d == 1
    if S.n == 0 or U.n == 0:
        return torch.full((max_pairs, 2), -1, dtype=_I32,
                          device=S.device), 0
    b, g, lb, width = hsbm_inputs(S, U, ncells)
    pairs, counts = _hsbm_emit(*b, lb, width, max_pairs=max_pairs,
                               **g.statics())
    return pairs, _total(counts)
