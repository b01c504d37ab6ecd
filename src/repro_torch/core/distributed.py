"""Multi-rank parallel SBM — paper §4 on ``torch.distributed``.

The port's counterpart of the JAX package's ``core/distributed.py``.  The
reference runs each step under ``shard_map`` over a 1-D device mesh; here
every rank of a process group runs the same steps on its own part of the
work, SPMD style.  Every rank calls the plan with the same replicated
``S``, ``U`` or query batch, as ``shard_map`` receives global arrays, and
every rank returns the same answer.

  step ⓪  **distributed sample sort**: endpoints are bucketed by
          value-range splitters (quantiles of a *strided* sample of the
          whole stream, ``sample_splitters``, computed on the host by
          every rank alike) and exchanged with one ``all_to_all_single``
          a payload; each rank then lex-sorts its value-range segment.
          Lanes are ``cap`` slots per (src, dst) with a validity payload,
          as in the reference, so overflow is detected and raised on
          every rank alike;
  step ①  the segment's ±1 delta totals;
  step ②  the exclusive combine: one ``all_gather`` of the two totals
          (and the overflow flag), summed over the lower ranks;
  step ③  the seeded local sweep: kernel K1 over the segment, plus the
          two carries times the segment's hi endpoints of each kind; the
          rank's int64 partial K goes through one ``all_reduce(SUM)``.

Pair enumeration (``_dist_pairs_pass1`` + ``_dist_pairs_emit``) reuses
the sample sort with an index payload for each side's lo-sorted stream
(the segments go through one ``all_gather`` and are compacted, as the
reference re-replicates them), gives each rank a contiguous chunk of the
n+m emitters (class A: one per subscription; class B: one per update,
``sbm._twopass_phase1``), counts them exactly, and decodes the rank's
``cap_dev`` slots with kernel K2 on full-length tables in which the
emitters outside the chunk have count 0.  The engine gathers the
per-rank buffers into a ``core.pairs.ShardedPairs``.

Queries (``_dist_query_counts`` / ``_dist_query``) shard the batch's rows
over the ranks; the tree and the opposite kind's regions are
replicated, each rank walks its rows with kernel K8, and the rows come
back to every rank with one ``all_gather``.  The padding rows are ±inf
sentinels, so integer query dtypes raise ``TypeError`` up front.

Collectives are used in list form only (``all_to_all_single``,
``all_gather`` with a list, ``all_reduce``).  The kernels run through
their wrappers, which launch them for CUDA tensors and run their plain
versions for CPU tensors; the group must be NCCL for the one and gloo
for the other.  Nothing falls back to a single-device path.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .regions import Regions
from .sbm import _endpoints_flat, _lexsort2

_I32 = torch.int32
_I64 = torch.int64
# the collective backend each plan device needs
_BACKEND_FOR = {"cuda": "nccl", "cpu": "gloo"}
_OVERFLOW = "distributed SBM bucket overflow; raise overprovision"


def resolve_group(group, device: torch.device):
    """The process group the plan runs on, checked against ``device``.

    ``None`` is the default group.  Raises ``RuntimeError`` when
    ``torch.distributed`` has no process group (there is no silent
    single-rank path) and ``ValueError`` when the group's backend does
    not serve tensors on ``device`` (NCCL for ``cuda``, gloo for
    ``cpu``), before any collective runs.
    """
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "backend='distributed' needs an initialized process group: "
            "call torch.distributed.init_process_group(...) on every rank "
            "first (NCCL for device='cuda', gloo for device='cpu')")
    want = _BACKEND_FOR.get(device.type)
    backend = str(dist.get_backend(group))
    if want is None or want not in backend:
        raise ValueError(
            f"the process group's backend is {backend!r}, but the plan runs "
            f"on {device}, which needs {want!r}")
    return group


def _topology(group, device: torch.device) -> tuple[object, int, int]:
    """``(group, nshards, me)`` of a checked group."""
    group = resolve_group(group, device)
    return group, dist.get_world_size(group), dist.get_rank(group)


def sample_splitters(v, tot: int, nshards: int,
                     max_sample: int = 65536) -> torch.Tensor:
    """Bucket splitters from an evenly strided sample of the whole stream.

    The reference's host computation, exactly: every ``tot //
    max_sample``-th value (at least every one), finite values only, a
    float64 ``np.quantile`` at ``nshards - 1`` evenly spaced levels, cast
    to float32.  The sample spans the whole host-ordered stream, so
    sorted or clustered inputs still split evenly.  Every rank computes
    the same splitters from the same replicated stream.  Returns float32
    ``(nshards - 1,)`` on ``v``'s device (the CPU for array-likes).
    """
    device = v.device if isinstance(v, torch.Tensor) else "cpu"
    qs = np.zeros((max(nshards - 1, 0),), np.float32)
    if nshards > 1 and tot > 0:
        stride = max(tot // max_sample, 1)
        part = v[:tot:stride]
        if isinstance(part, torch.Tensor):
            part = part.cpu().numpy()
        sample = np.asarray(part, dtype=np.float64)
        sample = sample[np.isfinite(sample)]
        if sample.size:
            qs = np.quantile(
                sample, np.linspace(0, 1, nshards + 1)[1:-1]
            ).astype(np.float32)
    return torch.from_numpy(qs).to(device)


def bucket_cap(tot: int, nshards: int, overprovision: float) -> int:
    """Static per-(src, dst) lane capacity of the sample-sort exchange:
    ``tot / nshards`` values a destination spread over ``nshards`` source
    lanes, times ``overprovision``, plus a floor of 16."""
    per_dev = -(-max(tot, 1) // nshards)
    return int(per_dev * overprovision / nshards) + 16


def _interleave(x: torch.Tensor, nshards: int) -> torch.Tensor:
    """Deal a padded stream round-robin over the ranks: chunk p of the
    result is ``x[p::nshards]``, a sample of the whole stream, so no
    rank's sends concentrate in one bucket."""
    return x.reshape(-1, nshards).t().reshape(-1)


def _local(x: torch.Tensor, fill, nshards: int, me: int) -> torch.Tensor:
    """Rank ``me``'s contiguous chunk of ``x`` padded with ``fill`` to a
    multiple of ``nshards`` and interleaved (the reference's shard)."""
    pad = (-x.shape[0]) % nshards
    if pad:
        x = torch.cat([x, x.new_full((pad,), fill)])
    chunk = x.shape[0] // nshards
    return _interleave(x, nshards)[me * chunk:(me + 1) * chunk]


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (same shape on all), stacked in rank order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts)


def _bucket_exchange(splitters, v, payloads, *, cap: int, nshards: int,
                     group):
    """Step ⓪: bucket by splitters, one ``all_to_all_single`` a payload.

    ``payloads`` is a list of ``(tensor, fill)`` carried alongside ``v``;
    by convention the last is the validity (1 real, 0 pad), which sends
    invalid slots to bucket ``nshards - 1``.  Each bucket's values keep
    their order (a stable sort by bucket) and fill its ``cap``-slot lane;
    what overflows is dropped and flagged.  Returns ``(received,
    overflow)``: ``received`` holds one ``(nshards * cap,)`` tensor per
    input (``v`` first) in lane order, source rank by source rank, and
    ``overflow`` is a bool tensor.
    """
    valid = payloads[-1][0]
    if nshards > 1:
        bucket = torch.searchsorted(splitters, v, right=True)
    else:
        bucket = torch.zeros(v.shape, dtype=_I64, device=v.device)
    bucket = torch.where(valid > 0, bucket, nshards - 1)
    order = torch.argsort(bucket, stable=True)
    b_sorted = bucket[order]
    starts = torch.searchsorted(
        b_sorted, torch.arange(nshards, dtype=_I64, device=v.device))
    rank = torch.arange(b_sorted.shape[0], device=v.device) - starts[b_sorted]
    overflow = ((rank >= cap) & (valid[order] > 0)).any()
    ok = rank < cap
    slot = (b_sorted * cap + rank)[ok]
    src = order[ok]

    def xchg(x, fill):
        send = x.new_full((nshards * cap,), fill)
        send[slot] = x[src]
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        return recv

    received = [xchg(v, float("inf"))]
    received.extend(xchg(x, fill) for x, fill in payloads)
    return received, overflow


# ---------------------------------------------------------------------------
# counting: sample sort, exclusive combine, seeded sweep through K1
# ---------------------------------------------------------------------------

def _segment(S: Regions, U: Regions, *, nshards: int, me: int, cap: int,
             group):
    """Steps ⓪–①: the rank's lex-sorted segment of the endpoint stream.

    Returns ``(is_lo, is_upd, overflow)``: contiguous int32 flags of the
    valid endpoints the rank received, in sweep order (value ascending,
    hi before lo at ties).  The invalid slots are dropped before the sort:
    a valid endpoint at +inf ties with the padding.
    """
    v, is_lo, is_upd = _endpoints_flat(S.lo[:, 0], S.hi[:, 0], U.lo[:, 0],
                                       U.hi[:, 0])
    tot = v.shape[0]
    splitters = sample_splitters(v, tot, nshards)
    valid = torch.ones(tot, dtype=_I32, device=v.device)
    loc = [_local(x, fill, nshards, me) for x, fill in
           ((v, float("inf")), (is_lo, 0), (is_upd, 0), (valid, 0))]
    (rv, rlo, rupd, rval), overflow = _bucket_exchange(
        splitters, loc[0], [(loc[1], 0), (loc[2], 0), (loc[3], 0)],
        cap=cap, nshards=nshards, group=group)
    keep = rval > 0
    rv, rlo, rupd = rv[keep], rlo[keep], rupd[keep]
    order = _lexsort2(rlo, rv)
    return rlo[order].contiguous(), rupd[order].contiguous(), overflow


def seeded_sweep(is_lo: torch.Tensor, is_upd: torch.Tensor, carry_upd: int,
                 carry_sub: int) -> torch.Tensor:
    """Step ③: a segment's K seeded with the active counts before it.

    ``_shard_body``'s ``hi·(sub·(upd_local + carry_upd) + upd·(sub_local +
    carry_sub))`` summed, expanded: K1 over the segment (its active counts
    start at 0 and may go negative, since a hi can reach a later rank
    than its lo) summed in int64, plus ``carry_upd`` times the segment's
    subscription hi endpoints and ``carry_sub`` times its update hi
    endpoints.  Returns an int64 scalar tensor.
    """
    from ..kernels import sbm_sweep as sweep_kernel
    is_hi = 1 - is_lo
    upd_hi = (is_hi * is_upd).sum(dtype=_I64)
    sub_hi = is_hi.sum(dtype=_I64) - upd_hi
    local = sweep_kernel.sbm_sweep(is_lo, is_upd).sum(dtype=_I64)
    return local + carry_upd * sub_hi + carry_sub * upd_hi


def _distributed_count(S: Regions, U: Regions, group=None,
                       overprovision: float = 2.5) -> int:
    """Total K by multi-rank parallel SBM (1-D regions), on every rank.

    Raises ``OverflowError`` on every rank when a bucket lane of any rank
    overflowed (raise ``overprovision``).
    """
    if S.d != 1:
        raise ValueError(f"the distributed count is 1-D, got d={S.d}")
    group, nshards, me = _topology(group, S.device)
    tot = 2 * (S.n + U.n)
    cap = bucket_cap(tot, nshards, overprovision)
    is_lo, is_upd, overflow = _segment(S, U, nshards=nshards, me=me,
                                       cap=cap, group=group)
    sign = 2 * is_lo - 1
    upd_tot = (sign * is_upd).sum(dtype=_I64)
    sub_tot = sign.sum(dtype=_I64) - upd_tot
    totals = _all_gather(torch.stack([upd_tot, sub_tot, overflow.to(_I64)]),
                         group).tolist()
    if any(row[2] for row in totals):
        raise OverflowError(_OVERFLOW)
    carry_upd = sum(row[0] for row in totals[:me])
    carry_sub = sum(row[1] for row in totals[:me])
    part = seeded_sweep(is_lo, is_upd, carry_upd, carry_sub).reshape(1)
    dist.all_reduce(part, op=dist.ReduceOp.SUM, group=group)
    return int(part)


# ---------------------------------------------------------------------------
# pair enumeration: distributed sorts, chunked exact counts, K2 per rank
# ---------------------------------------------------------------------------

def _dist_lo_sort(v: torch.Tensor, *, splitters, cap: int, nshards: int,
                  me: int, group):
    """Distributed sample sort of one side's lo endpoints: the permutation.

    The rank buckets its chunk with the row index riding along, exchanges,
    sorts its segment stably (invalid slots keyed to +inf, so valid ones
    come first) and marks the invalid ids −1.  One ``all_gather`` brings
    every rank's segment; concatenated in rank order the valid ids are
    the value-sorted order, which the compaction keeps.  Returns ``(perm
    (nv,) int32, overflow)``; ``v[perm]`` is ascending.
    """
    nv = v.shape[0]
    ids = torch.arange(nv, dtype=_I32, device=v.device)
    valid = torch.ones(nv, dtype=_I32, device=v.device)
    (rv, rid, rval), overflow = _bucket_exchange(
        splitters, _local(v, float("inf"), nshards, me),
        [(_local(ids, 0, nshards, me), 0),
         (_local(valid, 0, nshards, me), 0)],
        cap=cap, nshards=nshards, group=group)
    ok = rval > 0
    loc = torch.argsort(torch.where(ok, rv, float("inf")), stable=True)
    seg = torch.where(ok[loc], rid[loc], -1)
    segs = _all_gather(seg, group).reshape(-1)
    return segs[segs >= 0].contiguous(), overflow


def _chunk_bounds(n_emit: int, nshards: int, me: int) -> tuple[int, int]:
    """Rank ``me``'s emitters ``[c0, c1)``: the reference's chunk of the
    emitters padded to a multiple of ``nshards`` (pads count zero)."""
    chunk = -(-n_emit // nshards)
    c0 = min(me * chunk, n_emit)
    return c0, min(c0 + chunk, n_emit)


class Pass1(NamedTuple):
    """One rank's pass-1 state: the two sort permutations (int32,
    replicated) and its emitter chunk ``[c0, c1)`` with each emitter's
    input start and exact dim-0 count (int32)."""

    perm_s: torch.Tensor
    perm_u: torch.Tensor
    c0: int
    c1: int
    start: torch.Tensor
    cnt: torch.Tensor


def _chunk_ranges(S: Regions, U: Regions, perm_s, perm_u, c0: int,
                  c1: int) -> Pass1:
    """Pass-1 ranges of the emitters ``[c0, c1)``.

    Class A (emitter ``e < n``, subscription e) counts updates whose lo
    falls in ``[s.lo, s.hi)``; class B (update ``e - n``) counts
    subscriptions whose lo lies strictly inside it.  Both are searchsorted
    ranges over the lo-sorted streams, as in ``sbm._twopass_phase1``.
    """
    n = S.n
    s_sorted = S.lo[:, 0][perm_s.long()].contiguous()
    u_sorted = U.lo[:, 0][perm_u.long()].contiguous()
    emit_lo = torch.cat([S.lo[:, 0], U.lo[:, 0]])[c0:c1].contiguous()
    emit_hi = torch.cat([S.hi[:, 0], U.hi[:, 0]])[c0:c1].contiguous()
    is_b = torch.arange(c0, c1, device=emit_lo.device) >= n
    aA = torch.searchsorted(u_sorted, emit_lo)
    rA = torch.searchsorted(u_sorted, emit_hi)
    bB = torch.searchsorted(s_sorted, emit_lo, right=True)
    cB = torch.searchsorted(s_sorted, emit_hi)
    start = torch.where(is_b, bB, aA)
    cnt = (torch.where(is_b, cB, rA) - start).clamp_(min=0)
    return Pass1(perm_s, perm_u, c0, c1, start.to(_I32), cnt.to(_I32))


def _dist_pairs_pass1(S: Regions, U: Regions, *, overprovision: float,
                      group):
    """Distributed sorts and the rank's exact per-emitter counts.

    Returns ``(pass1, k0, need)``: the rank's ``Pass1``, the exact dim-0 K
    (int64 sum over every rank) and the largest per-rank total, which
    sizes the per-rank emit buffers.  One ``all_gather`` carries each
    rank's total and overflow flag, so an overflow raises
    ``OverflowError`` on every rank.
    """
    group, nshards, me = _topology(group, S.device)
    sides = []
    for R in (S, U):
        v = R.lo[:, 0].contiguous()
        sides.append(_dist_lo_sort(
            v, splitters=sample_splitters(v, R.n, nshards),
            cap=bucket_cap(R.n, nshards, overprovision), nshards=nshards,
            me=me, group=group))
    (perm_s, ovf_s), (perm_u, ovf_u) = sides
    c0, c1 = _chunk_bounds(S.n + U.n, nshards, me)
    p1 = _chunk_ranges(S, U, perm_s, perm_u, c0, c1)
    stats = _all_gather(torch.stack([(ovf_s | ovf_u).to(_I64),
                                     p1.cnt.sum(dtype=_I64)]),
                        group).tolist()
    if any(row[0] for row in stats):
        raise OverflowError(_OVERFLOW)
    return p1, sum(row[1] for row in stats), max(row[1] for row in stats)


def chunk_tables(p1: Pass1, n_emit: int, cap_dev: int):
    """K2's tables for a rank's chunk, at the full ``n_emit = n + m``
    length: ``(offs (n_emit+1,), counts (n_emit,), starts (n_emit,))``,
    int32.  Emitters outside the chunk count 0; the offsets are the
    chunk's own, an int64 cumsum with every entry clamped at ``cap_dev``
    (the reference's int32 ``min(a + b, cap_dev)`` scan can wrap once
    ``cap_dev >= 2^30``), 0 before the chunk and its total after it."""
    dev = p1.cnt.device
    counts = torch.zeros(n_emit, dtype=_I32, device=dev)
    starts = torch.zeros(n_emit, dtype=_I32, device=dev)
    counts[p1.c0:p1.c1] = p1.cnt
    starts[p1.c0:p1.c1] = p1.start
    offs = torch.zeros(n_emit + 1, dtype=_I32, device=dev)
    incl = torch.cumsum(p1.cnt, 0, dtype=_I64).clamp_(max=cap_dev)
    offs[p1.c0 + 1:p1.c1 + 1] = incl.to(_I32)
    if p1.c1 > p1.c0:
        offs[p1.c1 + 1:] = offs[p1.c1]
    return offs, counts, starts


def _dist_pairs_emit(p1: Pass1, n_emit: int, *, cap_dev: int):
    """The rank's slot-bound emit: ``(rows (cap_dev, 2) int32, total)``.

    K2 decodes exactly the rank's ``cap_dev`` slots from ``chunk_tables``:
    slot t → (emitter, rank, partner), the function of the reference's
    ``_pairs_emit_body``; slots at or past the chunk's clamped total are
    −1.  ``total`` (a python int) is that clamped total.
    """
    from ..kernels import emit as emit_kernel
    offs, counts, starts = chunk_tables(p1, n_emit, cap_dev)
    rows = emit_kernel.twopass_emit(offs, counts, starts, p1.perm_s,
                                    p1.perm_u, max_pairs=cap_dev)
    return rows, int(offs[-1])


# ---------------------------------------------------------------------------
# queries: rows sharded over the ranks, tree replicated, K8 per rank
# ---------------------------------------------------------------------------

def _require_float_queries(fn: str, **named):
    """The sharded batch is padded with ±inf sentinels, which integer
    dtypes do not have: reject them up front, as the reference does."""
    for name, a in named.items():
        if not a.dtype.is_floating_point:
            raise TypeError(
                f"{fn}: query coordinates must be a floating dtype "
                f"(the sharded batch is padded with ±inf sentinels), "
                f"got {name} with dtype {a.dtype} — cast "
                "the query boxes to float32/float64 before plan.query()")


class QueryRows(NamedTuple):
    """A rank's rows of a sharded query batch: float32 ``(chunk, d)``
    bounds (pad rows lo = +inf, hi = −inf, pruned at the root), K8's
    query order of them (``None`` off the card), and the batch size."""

    lo: torch.Tensor
    hi: torch.Tensor
    order: torch.Tensor | None
    b: int


def _query_rows(q_lo, q_hi, *, group) -> QueryRows:
    """The rank's chunk of the ``(b, d)`` query boxes, padded to a
    multiple of the group size with impossible boxes."""
    _require_float_queries("_dist_query", q_lo=q_lo, q_hi=q_hi)
    nshards, me = dist.get_world_size(group), dist.get_rank(group)
    b = q_lo.shape[0]
    q_lo, q_hi = q_lo.float(), q_hi.float()
    pad = (-b) % nshards
    if pad:
        d = q_lo.shape[1]
        q_lo = torch.cat([q_lo, q_lo.new_full((pad, d), float("inf"))])
        q_hi = torch.cat([q_hi, q_hi.new_full((pad, d), float("-inf"))])
    chunk = q_lo.shape[0] // nshards
    lo = q_lo[me * chunk:(me + 1) * chunk]
    hi = q_hi[me * chunk:(me + 1) * chunk]
    order = None
    if lo.is_cuda:
        from ..kernels import itm as itm_kernel
        order = itm_kernel.query_order(lo[:, 0])
    return QueryRows(lo, hi, order, b)


def _dist_query_counts(tree, rows: QueryRows, *, group) -> int:
    """The largest dim-0 count of any query of the batch: the rank's rows
    through K8's count walk, then one ``all_reduce(MAX)``.  That one
    reduction sizes the shared query capacity."""
    from ..kernels import ops
    counts = ops.itm_query_counts_cuda(tree, rows.lo[:, 0], rows.hi[:, 0],
                                       rows.order)
    need = counts.max().to(_I64).reshape(1)
    dist.all_reduce(need, op=dist.ReduceOp.MAX, group=group)
    return int(need)


def _dist_query(tree, o_lo, o_hi, rows: QueryRows, *, cap: int, group):
    """Verified d-dim query of the whole batch on every rank: the rank's
    rows through K8's pairs walk and the dims-1+ verify, then one
    ``all_gather`` each of the ids and the counts.  Returns ``(ids (b,
    cap) int32 −1-padded, counts (b,) int32)``."""
    from ..kernels import ops
    ids, cnt = ops.itm_query_pairs_dd_cuda(tree, o_lo, o_hi, rows.lo,
                                           rows.hi, cap, rows.order)
    ids = _all_gather(ids, group).reshape(-1, cap)[:rows.b]
    cnt = _all_gather(cnt, group).reshape(-1)[:rows.b]
    return ids, cnt
