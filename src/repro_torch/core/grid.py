"""Grid-Based Matching (GBM) — paper Algorithm 3, race-free form, in torch.

The port's counterpart of the GBM part of the JAX package's
``core/grid.py`` (the hybrid grid+SBM geometry waits for ROADMAP Queue 1
item 7).  As there:

* the scatter race on per-cell lists becomes a two-pass bucketing:
  expand (region → overlapped cell) incidences, stable-sort by cell,
  per-cell offsets by ``searchsorted``;
* the duplicate-report problem becomes the first-overlapped-cell test:
  a pair (s, u) counts only in the cell holding ``max(s.lo, u.lo)``.

Per-cell matching is the brute-force compare.  Capacities (max cells per
region, max regions per cell) are measured on the host.  Cell indices
come from float32 arithmetic on float32 ``lb``/``width`` tensors, exactly
as the reference computes them, so both packages bucket identically.
This is plain torch on any device; the reference has no kernel here.
"""
from __future__ import annotations

import numpy as np
import torch

from .regions import Regions

_I32 = torch.int32


def _cell_of(x, lb, width, ncells: int):
    c = torch.floor((x - lb) / width).to(_I32)
    return c.clamp(0, ncells - 1)


def _cell_spans(lo, hi, lb, width, ncells: int):
    """First/last grid cell overlapped by each 1-D region (inclusive)."""
    c0 = _cell_of(lo, lb, width, ncells)
    # floor((hi-lb)/width) >= cell(x) for every x < hi, and the boundary
    # cell (hi exactly on an edge) contains no point of [lo, hi)
    ch = torch.floor((hi - lb) / width).to(_I32)
    on_edge = (lb + ch.to(lo.dtype) * width) >= hi
    c1 = torch.minimum(torch.maximum(ch - on_edge.to(_I32), c0),
                       torch.full_like(c0, ncells - 1))
    return c0, c1


def _bucketize(lo, hi, lb, width, ncells: int, max_span: int, cap: int):
    """(ncells, cap) member-index table (−1 padded) via sort-by-cell."""
    n = lo.shape[0]
    dev = lo.device
    c0, c1 = _cell_spans(lo, hi, lb, width, ncells)
    k = torch.arange(max_span, dtype=_I32, device=dev)[None, :]
    cells = c0[:, None] + k                            # (n, max_span)
    cells = torch.where(cells <= c1[:, None], cells,
                        torch.full_like(cells, ncells))  # overflow bucket
    ridx = torch.arange(n, dtype=_I32, device=dev)[:, None].expand_as(cells)
    flat_c = cells.reshape(-1)
    flat_r = ridx.reshape(-1)
    order = torch.argsort(flat_c, stable=True)
    sc, sr = flat_c[order], flat_r[order]
    starts = torch.searchsorted(
        sc, torch.arange(ncells, dtype=_I32, device=dev), right=False)
    rank = (torch.arange(sc.shape[0], device=dev)
            - starts[sc.clamp(max=ncells - 1).long()])
    ok = (sc < ncells) & (rank >= 0) & (rank < cap)
    # dropped entries land in an extra row/column that is cut off
    cell_idx = torch.where(ok, sc.long(), ncells)
    rank_idx = torch.where(ok, rank, cap)
    table = torch.full((ncells + 1, cap + 1), -1, dtype=_I32, device=dev)
    table[cell_idx, rank_idx] = sr
    return table[:ncells, :cap]


def _gbm_cell_counts(S: Regions, U: Regions, lb, width, ncells: int,
                     cap_s: int, cap_u: int, span_s: int, span_u: int,
                     chunk: int) -> torch.Tensor:
    """Overlap counts per chunk of ``chunk`` cells, int64 (ncells/chunk,)."""
    s_lo, s_hi = S.lo[:, 0], S.hi[:, 0]
    u_lo, u_hi = U.lo[:, 0], U.hi[:, 0]
    ts = _bucketize(s_lo, s_hi, lb, width, ncells, span_s, cap_s)
    tu = _bucketize(u_lo, u_hi, lb, width, ncells, span_u, cap_u)
    nchunks = ncells // chunk
    ts = ts.reshape(nchunks, chunk, cap_s)
    tu = tu.reshape(nchunks, chunk, cap_u)
    cell_ids = torch.arange(ncells, dtype=_I32,
                            device=s_lo.device).reshape(nchunks, chunk)
    out = []
    for tsc, tuc, cid in zip(ts, tu, cell_ids):
        si, ui = tsc.clamp(min=0).long(), tuc.clamp(min=0).long()
        sl, sh, ul, uh = s_lo[si], s_hi[si], u_lo[ui], u_hi[ui]
        ov = ((sl[:, :, None] < uh[:, None, :])
              & (ul[:, None, :] < sh[:, :, None]))
        # first-overlapped-cell dedup: count only where the cell owns
        # max(s.lo, u.lo)
        own = _cell_of(torch.maximum(sl[:, :, None], ul[:, None, :]),
                       lb, width, ncells) == cid[:, None, None]
        ok = ov & own & (tsc >= 0)[:, :, None] & (tuc >= 0)[:, None, :]
        out.append(ok.sum())
    return torch.stack(out)


def _capacities(lo, hi, lb, width, ncells: int):
    """Host-side pre-pass: max cells per region, max regions per cell."""
    c0, c1 = _cell_spans(lo, hi, lb, width, ncells)
    c0n, c1n = c0.cpu().numpy(), c1.cpu().numpy()
    span = int((c1n - c0n).max()) + 1
    # occupancy per cell via difference array
    diff = np.bincount(c0n, minlength=ncells + 1).astype(np.int64)
    diff -= np.bincount(np.minimum(c1n + 1, ncells), minlength=ncells + 1)
    occ = np.cumsum(diff[:ncells])
    return span, max(int(occ.max()), 1)


def gbm_count(S: Regions, U: Regions, ncells: int = 3000,
              chunk: int | None = None) -> int:
    """Total K via grid matching.  ``ncells`` is the paper's tuning knob."""
    if S.d != 1:
        raise ValueError(f"gbm_count matches 1-D regions, got d={S.d}")
    lb = float(min(S.lo.min(), U.lo.min()))
    ub = float(max(S.hi.max(), U.hi.max()))
    width = max((ub - lb) / ncells, 1e-30)
    lb_t = torch.tensor(lb, dtype=torch.float32, device=S.device)
    width_t = torch.tensor(width, dtype=torch.float32, device=S.device)
    span_s, cap_s = _capacities(S.lo[:, 0], S.hi[:, 0], lb_t, width_t,
                                ncells)
    span_u, cap_u = _capacities(U.lo[:, 0], U.hi[:, 0], lb_t, width_t,
                                ncells)
    if chunk is None:
        # keep the (chunk, cap_s, cap_u) compare block around ~2^22 elems
        chunk = max(1, min(ncells, (1 << 22) // max(cap_s * cap_u, 1)))
    while ncells % chunk:
        chunk -= 1
    counts = _gbm_cell_counts(S, U, lb_t, width_t, ncells, cap_s, cap_u,
                              span_s, span_u, chunk)
    return int(counts.sum())
