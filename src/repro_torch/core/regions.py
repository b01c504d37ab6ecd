"""Region batches for the DDM matching problem, as torch tensors.

A *region* is a d-dimensional axis-parallel rectangle with half-open
extents ``[lo, hi)`` per dimension (paper §2).  A batch of N regions is
stored structure-of-arrays as two ``(N, d)`` float32 tensors on one
device.  Every constructor takes an explicit ``device`` and defaults to
``"cuda"``: the port exists to run on the card, and the CPU is used
only when the caller names it.  Asking for ``cuda`` on a host without
a card raises ``RuntimeError``; nothing carries on on the CPU.

The synthetic workload generators draw from ``np.random.default_rng``
in exactly the order the JAX package's generators do, so both packages
produce bit-equal arrays from one seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises if CUDA is asked for but
    no card is present (the port never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain torch path")
    return dev


@dataclasses.dataclass(frozen=True)
class Regions:
    """A batch of N axis-parallel d-rectangles, half-open per dimension."""

    lo: torch.Tensor  # (N, d) float32
    hi: torch.Tensor  # (N, d) float32

    @property
    def n(self) -> int:
        return self.lo.shape[0]

    @property
    def d(self) -> int:
        return self.lo.shape[1]

    @property
    def device(self) -> torch.device:
        return self.lo.device

    def dim(self, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """1-D projection along dimension ``k`` (paper §2 reduction)."""
        return self.lo[:, k], self.hi[:, k]

    def __repr__(self) -> str:  # avoid dumping tensors
        return (f"Regions(n={self.lo.shape[0]}, d={self.lo.shape[1]}, "
                f"device={self.lo.device})")


def _as_f32(x, dev: torch.device) -> torch.Tensor:
    """float32 tensor on ``dev``; host array-likes are copied, so later
    writes to the caller's array never reach the regions."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float32)
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)


def make_regions(lo, hi, device="cuda") -> Regions:
    """Regions from array-likes (numpy, lists or tensors) on ``device``."""
    dev = resolve_device(device)
    lo, hi = _as_f32(lo, dev), _as_f32(hi, dev)
    if lo.ndim == 1:
        lo, hi = lo[:, None], hi[:, None]
    if lo.shape != hi.shape or lo.ndim != 2:
        raise ValueError(f"bad region shapes {tuple(lo.shape)} vs "
                         f"{tuple(hi.shape)}")
    return Regions(lo=lo.contiguous(), hi=hi.contiguous())


# ---------------------------------------------------------------------------
# Synthetic workload generators (paper §5 methodology)
# ---------------------------------------------------------------------------

def paper_workload(
    seed: int,
    n_total: int,
    alpha: float,
    space: float = 1.0e6,
    d: int = 1,
    device="cuda",
) -> tuple[Regions, Regions]:
    """The paper's synthetic benchmark (§5, after Raczy et al. [52]).

    ``n_total = N`` regions split into ``n = N/2`` subscriptions and
    ``m = N/2`` updates, each of identical length ``l = alpha * L / N``
    placed uniformly at random on a segment of length ``L = space``.
    ``alpha`` is the overlapping degree.  For ``d > 1`` every dimension
    is generated the same way (the paper evaluates d=1).
    """
    dev = resolve_device(device)
    n = n_total // 2
    m = n_total - n
    length = alpha * space / n_total
    rng = np.random.default_rng(seed)

    def gen(count):
        lo = rng.uniform(0.0, space - length,
                         size=(count, d)).astype(np.float32)
        # guarantee non-empty intervals at f32: for tiny alpha*L/N the
        # exact hi = lo + length can round back onto lo near the top of
        # the domain; the matchers' half-open semantics need lo < hi.
        hi = (lo.astype(np.float64) + length).astype(np.float32)
        hi = np.maximum(hi, np.nextafter(lo, np.float32(np.inf)))
        return lo, hi

    s_lo, s_hi = gen(n)
    u_lo, u_hi = gen(m)
    return (make_regions(s_lo, s_hi, dev), make_regions(u_lo, u_hi, dev))


def koln_like_workload(
    seed: int,
    n_positions: int = 541_222,
    extent: float = 20_000.0,
    width: float = 100.0,
    n_clusters: int = 64,
    device="cuda",
) -> tuple[Regions, Regions]:
    """Clustered vehicular workload mimicking the Cologne trace (§5, Fig 14).

    Vehicle x-positions concentrated on a road network (a mixture of
    dense linear clusters over a ~20 km extent), one subscription *and*
    one update region of fixed ``width`` centred on every position, so
    N ≈ 2 * n_positions regions overall.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    centres = rng.uniform(0, extent, size=n_clusters)
    spans = rng.uniform(100.0, extent / 8, size=n_clusters)
    which = rng.integers(0, n_clusters, size=n_positions)
    x = centres[which] + rng.uniform(-0.5, 0.5, size=n_positions) * spans[which]
    x = np.clip(x, 0, extent).astype(np.float32)
    lo = (x - width / 2)[:, None]
    hi = (x + width / 2)[:, None]
    return make_regions(lo, hi, dev), make_regions(lo.copy(), hi.copy(), dev)


# ---------------------------------------------------------------------------
# Shared predicate (paper Algorithm 1, half-open variant)
# ---------------------------------------------------------------------------

def intersect_1d(x_lo, x_hi, y_lo, y_hi):
    """Half-open interval overlap: [x_lo,x_hi) ∩ [y_lo,y_hi) ≠ ∅."""
    return (x_lo < y_hi) & (y_lo < x_hi)


def intersect_dd(s_lo, s_hi, u_lo, u_hi):
    """d-rectangle overlap = conjunction of per-dimension overlaps (§2)."""
    return ((s_lo < u_hi) & (u_lo < s_hi)).all(dim=-1)
