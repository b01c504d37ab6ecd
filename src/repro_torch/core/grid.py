"""Grid-Based Matching (GBM) — paper Algorithm 3, race-free form, in torch.

The port's counterpart of the JAX package's ``core/grid.py``: GBM, and
the host-measured geometry of the hybrid grid+SBM (``hsbm_geometry``).
For GBM, as there:

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

import dataclasses

import numpy as np
import torch

from ..spans import host_read
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
    return host_read(counts.sum())


# ---------------------------------------------------------------------------
# Hybrid grid+SBM (hsbm) geometry — host-side measurement
# ---------------------------------------------------------------------------
#
# The hybrid replaces flat SBM's global pass-1 sorts by a coarse grid
# bucketing and per-cell sorts (``core.sbm._hsbm_phase1``).  The grid is
# only a pre-filter: matching within and across cell boundaries stays
# SBM's searchsorted-range argument, so hsbm is exact like SBM.  The
# geometry (cell count, per-cell capacity, boundary-suffix width) is
# measured on the host from the data, in NumPy, exactly as the reference
# measures it, and rounded to coarse quanta so that same-distribution
# data keeps its buffer shapes.

_HSBM_TARGET_OCC = 1280     # aim for ~this many regions per cell pair
_HSBM_MAX_NCELLS = 1 << 16


@dataclasses.dataclass(frozen=True)
class HsbmGeometry:
    """Grid geometry of the hybrid pass 1.

    ``ncells``/``cap_s``/``cap_u``/``suf_s``/``suf_u`` size the per-cell
    tables (python ints); ``lb``/``width`` are the grid origin and cell
    width (python floats, handed to the device as float32 scalars).
    """

    ncells: int
    cap_s: int
    suf_s: int
    cap_u: int
    suf_u: int
    lb: float
    width: float

    @property
    def n_emit_s(self) -> int:
        """Rows of the padded S emitter table (natives + spill suffix)."""
        return self.ncells * (self.cap_s + self.suf_s)

    @property
    def n_emit_u(self) -> int:
        return self.ncells * (self.cap_u + self.suf_u)

    def statics(self) -> dict:
        return dict(ncells=self.ncells, cap_s=self.cap_s, suf_s=self.suf_s,
                    cap_u=self.cap_u, suf_u=self.suf_u)


def _pow2_ceil(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


def hsbm_geometry(s_lo, s_hi, u_lo, u_hi,
                  ncells: int | None = None) -> HsbmGeometry:
    """Measure the hybrid grid geometry on the host (NumPy inputs).

    ``ncells=None`` picks pow2_ceil((n+m)/1280) cells, clamped so each
    cell is at least one max-region-length wide (then a region's lo-cell
    and the cell left of it are the only cells whose natives can reach
    it, which the boundary suffix of ``sbm._hsbm_side_tables`` relies
    on).  Per-cell native capacity is measured with the float32
    arithmetic the device uses (the same cell for every region); the
    spill-suffix width in float64 with slack, so rounding can only widen
    it.  Bit-equal to the reference's ``grid.hsbm_geometry``.
    """
    s_lo = np.asarray(s_lo, np.float32)
    s_hi = np.asarray(s_hi, np.float32)
    u_lo = np.asarray(u_lo, np.float32)
    u_hi = np.asarray(u_hi, np.float32)
    n, m = s_lo.shape[0], u_lo.shape[0]
    lb = float(min(s_lo.min(), u_lo.min()))
    top = float(max(s_hi.max(), u_hi.max()))
    max_len64 = float(max((s_hi.astype(np.float64) - s_lo).max(),
                          (u_hi.astype(np.float64) - u_lo).max()))
    if ncells is None:
        ncells = _pow2_ceil(max(1, (n + m) // _HSBM_TARGET_OCC))
    span_bound = (max(1, int((top - lb) / max_len64))
                  if max_len64 > 0 and top > lb else 1)
    nc = max(1, min(int(ncells), span_bound, _HSBM_MAX_NCELLS))
    slack = max(abs(lb), abs(top)) * 2.0 ** -20 + 1e-300

    def one_side(lo, width):
        c = np.floor((lo - np.float32(lb)) / np.float32(width))
        c = np.minimum(c.astype(np.int64), nc - 1)
        occ = np.bincount(c, minlength=nc)
        cap = max(64, -(-int(occ.max()) // 64) * 64)
        # a region native to cell c-1 can reach cell c iff lo >= cell c's
        # left edge - max_len; count those per cell, with float64 slack
        thresh = (lb + (c + 1) * width) - max_len64 - slack
        sufc = np.bincount(c[lo.astype(np.float64) >= thresh], minlength=nc)
        suf = max(8, -(-int(sufc.max()) // 8) * 8)
        return cap, suf

    while True:
        # the (1 + 1e-6) guard keeps floor((top - lb)/width) <= nc when
        # the division is redone in float32 on the device
        width = (top - lb) / nc * (1 + 1e-6) if top > lb else 1.0
        cap_s, suf_s = one_side(s_lo, width)
        cap_u, suf_u = one_side(u_lo, width)
        rows = nc * (cap_s + suf_s + cap_u + suf_u)
        # blow-up guard: on skewed data the per-cell maximum times ncells
        # can dwarf n+m; halve the grid until the emitter tables stay
        # within 4x the input (which also keeps shifted ids in int32)
        if nc == 1 or rows <= max(4 * (n + m), 1 << 16):
            break
        nc //= 2
    return HsbmGeometry(nc, cap_s, suf_s, cap_u, suf_u, lb, width)
