"""Sort-Based Matching — paper Algorithms 4/6/7, as plain torch.

The port's counterpart of the JAX package's ``core/sbm.py`` (1-D flat
SBM; the hybrid grid+SBM waits for ROADMAP Queue 1 item 7).  For
counting, the sweep's active sets collapse to integers, so the sweep is
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
not unless asked, so every sort here passes ``stable=True``.

Endpoint ordering: half-open intervals require upper endpoints to be
processed *before* lower endpoints at equal coordinate, so ``[a,b)`` and
``[b,c)`` never match.  Precondition: regions are non-empty
(``lo < hi``), as in the paper.
"""
from __future__ import annotations

import torch

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

def _endpoint_stream(s_lo, s_hi, u_lo, u_hi):
    """Lex-sorted endpoint stream of one dimension: ``(is_lo, is_upd)``,
    int32 ``(2(n+m),)`` in sweep order (value asc, hi before lo)."""
    v = torch.cat([s_lo, s_hi, u_lo, u_hi])
    n, m = s_lo.shape[0], u_lo.shape[0]
    dev = v.device
    ones = torch.ones(2 * max(n, m), dtype=_I32, device=dev)
    zeros = torch.zeros_like(ones)
    is_lo = torch.cat([ones[:n], zeros[:n], ones[:m], zeros[:m]])
    is_upd = torch.cat([zeros[:2 * n], ones[:2 * m]])
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
    """Exact int64 sum of per-item counts as a python int."""
    return int(c.sum(dtype=torch.int64))


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
    incl = torch.cumsum(counts, 0, dtype=torch.int64).clamp_(max=max_pairs)
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
