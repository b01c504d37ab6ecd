"""The plain reference that the port's answers are judged by.

Plain torch on any device, written apart from the port: it imports
nothing of ``repro_torch`` (nor JAX, nor the JAX package) and takes
nothing the program made, only the regions the benchmark made and moved.
Regions are 1-D, half-open ``[lo, hi)`` with ``lo <= hi``; a
subscription ``s`` and an update ``u`` overlap iff
``u.lo < s.hi and s.lo < u.hi``, compared at float32 as stored.  The
benchmark's regions are non-empty (``lo < hi``); only the control's
rounded ones can be empty.

* ``count_overlaps``: K exact in int64.  ``u.hi <= s.lo`` implies
  ``u.lo < s.hi`` unless ``u.lo = u.hi = s.lo = s.hi``, so
  ``K = sum_s #{u : u.lo < s.hi} - #{u : u.hi <= s.lo}`` plus, for an
  empty ``s``, the empty ``u`` at its very point: sorts and binary
  searches.
* ``pairs_digest``: every overlapping pair, enumerated by subscription
  from the updates sorted by lo (candidates are the updates with
  ``u.lo`` in ``[s.lo - longest update, s.hi)``, kept where
  ``u.hi > s.lo``), in blocks of candidates, reduced to a digest: K and
  two sums of 64-bit mixes of the pair's key ``s * m + u``.  Equal
  digests mean equal pair sets (a missing, extra, repeated or altered
  pair changes both sums, except with odds near 2^-64 each).
* ``buffer_digest``: the same digest of a program's pair buffer, plus
  the rows in ``[0, K)`` that are not a pair of in-range ids (a ``-1``
  pad, an id out of range) and the rows the buffer is short of K.

``count_overlaps``'s ``precision`` casts the regions before counting:
``float32`` is the reference; ``bfloat16``, the next precision below the
configuration's float32, is the control (``ddmbench/control.py``) that
the comparison has to find not correct.
"""
from __future__ import annotations

import torch

# two odd 64-bit constants as signed int64, xored into the key before
# mixing so that the two sums are independent
_SALT1 = 0x2545F4914F6CDD1D
_SALT2 = 0x5851F42D4C957F2D
_M1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_M2 = 0x94D049BB133111EB - (1 << 64)


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 (torch's ``>>`` is arithmetic)."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _mix(x: torch.Tensor) -> torch.Tensor:
    """SplitMix64's finaliser on int64 (wrapping products)."""
    x = (x ^ _shr(x, 30)) * _M1
    x = (x ^ _shr(x, 27)) * _M2
    return x ^ _shr(x, 31)


def _digest_add(acc: list, s: torch.Tensor, u: torch.Tensor, m: int,
                keep: torch.Tensor | None = None) -> None:
    key = s * m + u
    h1, h2 = _mix(key ^ _SALT1), _mix(key ^ _SALT2)
    if keep is not None:
        k = keep.to(torch.int64)
        h1, h2 = h1 * k, h2 * k
        acc[0] += k.sum()
    else:
        acc[0] += key.shape[0]
    acc[1] += h1.sum()
    acc[2] += h2.sum()


def _prep(lo: torch.Tensor, hi: torch.Tensor, precision: str = "float32"):
    lo, hi = lo.reshape(-1), hi.reshape(-1)
    if precision != "float32":
        dt = getattr(torch, precision)
        lo, hi = lo.to(dt).float(), hi.to(dt).float()
    return lo.contiguous(), hi.contiguous()


def _require(*pairs, empty_ok: bool = False) -> None:
    for lo, hi in pairs:
        if bool((lo > hi if empty_ok else lo >= hi).any()):
            raise ValueError("the reference needs regions with lo < hi "
                             "(lo <= hi for a count) in the matched state")


def count_overlaps(s_lo, s_hi, u_lo, u_hi, precision: str = "float32") -> int:
    """Exact K over 1-D regions, int64."""
    s_lo, s_hi = _prep(s_lo, s_hi, precision)
    u_lo, u_hi = _prep(u_lo, u_hi, precision)
    _require((s_lo, s_hi), (u_lo, u_hi), empty_ok=True)
    below = torch.searchsorted(torch.sort(u_lo).values, s_hi, right=False)
    gone = torch.searchsorted(torch.sort(u_hi).values, s_lo, right=True)
    k = int((below - gone).sum(dtype=torch.int64))
    point = torch.sort(u_lo[u_lo == u_hi]).values     # empty updates
    s_pt = s_lo[s_lo == s_hi]                          # empty subscriptions
    if point.numel() and s_pt.numel():
        k += int((torch.searchsorted(point, s_pt, right=True)
                  - torch.searchsorted(point, s_pt, right=False))
                 .sum(dtype=torch.int64))
    return k


def pairs_digest(s_lo, s_hi, u_lo, u_hi, block: int = 1 << 25) -> dict:
    """``{"k", "h1", "h2"}`` of every overlapping (s, u) pair."""
    s_lo, s_hi = _prep(s_lo, s_hi)
    u_lo, u_hi = _prep(u_lo, u_hi)
    _require((s_lo, s_hi), (u_lo, u_hi))
    dev = s_lo.device
    n, m = s_lo.shape[0], u_lo.shape[0]
    acc = [torch.zeros((), dtype=torch.int64, device=dev) for _ in range(3)]
    if n and m:
        order = torch.argsort(u_lo)
        ul, uh = u_lo[order], u_hi[order]
        # exact in float64: a float32 difference fits
        span = float((u_hi.double() - u_lo.double()).max())
        first = torch.searchsorted(ul.double(), s_lo.double() - span,
                                   right=False)
        last = torch.searchsorted(ul, s_hi, right=False)
        cnt = (last - first).clamp_(min=0)
        ends = torch.cumsum(cnt, 0)
        ends_h = ends.cpu()
        a = 0
        while a < n:
            base = int(ends_h[a - 1]) if a else 0
            b = int(torch.searchsorted(ends_h, base + block, right=True))
            b = min(max(b, a + 1), n)
            total = int(ends_h[b - 1]) - base
            if total:
                sid = torch.repeat_interleave(
                    torch.arange(a, b, device=dev), cnt[a:b],
                    output_size=total)
                start = ends[sid] - cnt[sid]          # exclusive, global
                g = torch.arange(base, base + total, device=dev)
                pos = first[sid] + (g - start)
                keep = uh[pos] > s_lo[sid]
                _digest_add(acc, sid, order[pos], m, keep)
            a = b
    return {"k": int(acc[0]), "h1": int(acc[1]), "h2": int(acc[2])}


def buffer_digest(decode, cap: int, k: int, n: int, m: int,
                  chunk: int = 1 << 23) -> dict:
    """The digest of slots ``[0, k)`` of a program's pair buffer of ``cap``
    slots, read by ``decode(start, stop)`` as int32 ``(stop - start, 2)``
    rows (column 0 the subscription, column 1 the update), with
    ``bad_rows``: slots in ``[0, k)`` that hold no pair of in-range ids,
    or that the buffer lacks."""
    acc, bad = None, None
    top = min(k, cap)
    for a in range(0, top, chunk):
        r = decode(a, min(a + chunk, top))
        if acc is None:
            acc = [torch.zeros((), dtype=torch.int64, device=r.device)
                   for _ in range(3)]
            bad = torch.zeros((), dtype=torch.int64, device=r.device)
        s, u = r[:, 0].long(), r[:, 1].long()
        bad += ((s < 0) | (s >= n) | (u < 0) | (u >= m)).sum()
        _digest_add(acc, s, u, m)
    if acc is None:
        return {"k": k, "h1": 0, "h2": 0, "bad_rows": k}
    return {"k": k, "h1": int(acc[1]), "h2": int(acc[2]),
            "bad_rows": int(bad) + (k - top)}
