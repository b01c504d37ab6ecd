"""Brute-Force Matching (BFM) — paper Algorithm 2, as plain torch.

The port's counterpart of the JAX package's ``core/brute.py``.  The
paper's doubly-nested ``Intersect-1D`` loop becomes a broadcast compare;
``U`` is processed in tiles so the (n × tile) overlap mask is the only
O(n·m) intermediate of the count.  This is the ``backend="torch"`` path
on any device; the hand-written CUDA kernels for the same computation
are K3 and K4 (``kernels/bfm.py``).
"""
from __future__ import annotations

import torch

from ..spans import host_read
from .regions import Regions

_I32 = torch.int32


def _mask_block(s_lo, s_hi, u_lo, u_hi) -> torch.Tensor:
    """(n, m) overlap mask for d-dim regions. Inputs (n,d)/(m,d)."""
    ok = ((s_lo[:, None, :] < u_hi[None, :, :])
          & (u_lo[None, :, :] < s_hi[:, None, :]))
    return ok.all(dim=-1)


def bfm_mask(S: Regions, U: Regions) -> torch.Tensor:
    """Full (n, m) boolean overlap mask (small problems / oracle)."""
    return _mask_block(S.lo, S.hi, U.lo, U.hi)


def bfm_count_per_sub(S: Regions, U: Regions, tile: int = 4096
                      ) -> torch.Tensor:
    """Per-subscription overlap counts K_s, int32 (n,), in U-tiles.

    U is padded to a tile multiple with regions that match nothing
    (lo = +inf, hi = -inf).  The caller sums in int64.
    """
    m, d = U.n, U.d
    pad = (-m) % tile
    u_lo = torch.cat([U.lo, U.lo.new_full((pad, d), float("inf"))])
    u_hi = torch.cat([U.hi, U.hi.new_full((pad, d), float("-inf"))])
    counts = torch.zeros(S.n, dtype=_I32, device=S.device)
    for j in range(0, m + pad, tile):
        mask = _mask_block(S.lo, S.hi, u_lo[j:j + tile], u_hi[j:j + tile])
        counts += mask.sum(dim=1, dtype=_I32)
    return counts


def bfm_count(S: Regions, U: Regions, tile: int = 4096) -> int:
    """Total number of overlapping (s, u) pairs (python int, exact)."""
    return host_read(bfm_count_per_sub(S, U, tile=tile).sum(dtype=torch.int64))


def compact_mask_pairs(mask: torch.Tensor, max_pairs: int):
    """Row-major nonzero of an (n, m) mask: ``(pairs, count)``.

    ``pairs`` is int32 (max_pairs, 2), the first ``max_pairs`` overlaps
    as (s, u) in row-major order (``torch.nonzero`` keeps the order of
    ``jnp.nonzero``), −1 padded; ``count`` is the exact K.
    """
    m = mask.shape[1]
    flat = torch.nonzero(mask.reshape(-1)).flatten()
    count = int(flat.shape[0])
    flat = flat[:max_pairs]
    out = torch.full((max_pairs, 2), -1, dtype=_I32, device=mask.device)
    out[:flat.shape[0], 0] = (flat // m).to(_I32)
    out[:flat.shape[0], 1] = (flat % m).to(_I32)
    return out, count


def bfm_pairs(S: Regions, U: Regions, max_pairs: int):
    """Enumerate overlapping pairs into a static-capacity buffer.

    Returns ``(pairs, count)``: ``pairs`` is int32 (max_pairs, 2) filled
    with (s_idx, u_idx) in row-major mask order and padded with −1;
    ``count`` is the true number of overlaps (may exceed max_pairs).
    """
    return compact_mask_pairs(bfm_mask(S, U), max_pairs)
