"""K3 and K4 — brute-force kernels in CUDA (``csrc/bfm.cu``,
``csrc/bfm_mask.cu``).

K3 ``bfm_tile_counts`` replaces the JAX package's Pallas kernel
``kernels/bfm.py:_count_kernel``: the int32 overlap count of every
(ts × tu) tile, for inputs padded to tile multiples with non-matching
±inf sentinel regions (``ops._pad_regions``).  Bound on the card:
operations, n·m·2d float32 compares (≈7.5 ms at the paper's fig. 9
size, d = 1, against the 67 TFLOP/s CUDA-core rate); in practice
instruction issue.  At d = 1 with tu a power-of-two multiple of 16 up to
512 and ts ≤ 4096 (fig. 9 and Koln: 256 × 256) each thread holds 16 U
columns in registers against an S tile resident in shared memory, at
three instructions a pair, 10 of its columns tested by exact saturating
FMAs when ``fma_scale`` allows it (the wrapper reads the bounds'
exponent range back to the host, one sync per call, and picks K or the
all-FSETP instance); every other shape takes the general kernel, one CTA
per tile.

K4 ``bfm_mask`` replaces ``_mask_kernel``: the full (n, m) bool mask.
Unlike the TPU kernel it takes any n and m and masks the ragged edge
itself, so the mask comes out contiguous with nothing padded or
trimmed.  Bound on the card: bytes, n·m written.  Persistent CTAs hold
16 columns' bounds per thread in registers (two dimensions at most; more
are read through L1) and walk 32-row tiles whose S bounds they stage in
shared memory; each thread writes V bytes of a row as one aligned store,
V the largest of 16, 8, 4, 2, 1 that divides m, which picks the kernel
instance.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs
the plain version (``ref.bfm_tile_counts`` / ``ref.bfm_mask``) for CPU
tensors; there is no fallback between them.  ``.launches`` counts kernel
launches.
"""
from __future__ import annotations

import torch

from . import _build, ref

_INT32_MAX = 2 ** 31 - 1


def _check_bounds(s_lo, s_hi, u_lo, u_hi) -> None:
    for name, x in (("s_lo", s_lo), ("s_hi", s_hi), ("u_lo", u_lo),
                    ("u_hi", u_hi)):
        if (x.dtype != torch.float32 or x.ndim != 2
                or not x.is_contiguous() or x.device != s_lo.device):
            raise ValueError(
                f"{name} must be a contiguous float32 (N, d) tensor on "
                f"{s_lo.device}, got {x.dtype} {tuple(x.shape)} on "
                f"{x.device}")
    if s_lo.shape != s_hi.shape or u_lo.shape != u_hi.shape:
        raise ValueError("lo and hi bounds must match in shape")
    if s_lo.shape[1] != u_lo.shape[1] or s_lo.shape[1] < 1:
        raise ValueError(f"S and U must share d >= 1, got "
                         f"{s_lo.shape[1]} and {u_lo.shape[1]}")


def _check_d(what: str, s_lo) -> None:
    # d reaches the kernels as a C int (n and m as long long)
    if s_lo.ndim == 2:
        _build.check_c_int(what, d=s_lo.shape[1])


def fma_scale(*bounds: torch.Tensor) -> float:
    """K = 2^k for K3's FMA compare on these float32 bounds, or 0.0 where
    it would not be exact.

    ``sat(y·K - x·K)`` equals ``[x < y]`` when every ``K·bound`` is finite
    and two distinct bounds lie at least 1/K apart.  With every finite
    nonzero |bound| in [2^emin, 2^(emax+1)), distinct bounds lie at least
    2^(emin-23) apart, so k = 23 - emin; emax - emin <= 103 keeps each
    K·bound below 2^127, and emin >= -104 keeps K a normal float (no
    subnormal bound).  Infinities, NaN and zeros need no condition.  Per
    tensor, a min and a max over the bits of |bound|, then one host read
    for all of them (a device sync).
    """
    ext = []
    for b in bounds:
        # |b|'s bits less one, ordered as |b|: finite nonzero values fall
        # in [0, 0x7F7FFFFE]; zero (wrapped to 0x7FFFFFFF), ±inf and NaN
        # lie above, out of both reductions
        key = (b.view(torch.int32) & 0x7FFFFFFF).sub_(1).bitwise_and_(
            0x7FFFFFFF)
        ext += [key.amin(), torch.where(key < 0x7F7FFFFF, key, -1).amax()]
    keys = torch.stack(ext).tolist()
    lo, hi = min(keys[0::2]), max(keys[1::2])
    if hi < 0:                        # only zeros, infinities and NaN
        return 1.0
    # biased exponents; a subnormal has 0
    e_lo, e_hi = (lo + 1) >> 23, (hi + 1) >> 23
    if e_lo < 127 - 104 or e_hi - e_lo > 103:
        return 0.0
    return 2.0 ** (23 - (e_lo - 127))


def bfm_tile_counts(s_lo, s_hi, u_lo, u_hi, *, ts: int = 256,
                    tu: int = 256) -> torch.Tensor:
    """Per-tile overlap counts int32 (n/ts, m/tu); n%ts == m%tu == 0.

    Shared memory a CTA of 256 threads: ``16·ts`` bytes on the d1 path
    (the S strip as float4), else ``8·d·(ts + tu)`` (both tiles' bounds).
    """
    _check_d("bfm_tile_counts", s_lo)
    n, m = s_lo.shape[0], u_lo.shape[0]
    if ts < 1 or tu < 1 or n % ts or m % tu:
        raise ValueError(f"bfm_tile_counts needs n % ts == m % tu == 0, got "
                         f"n={n} ts={ts} m={m} tu={tu}")
    if s_lo.device.type == "cpu":
        return ref.bfm_tile_counts(s_lo, s_hi, u_lo, u_hi, ts, tu)
    if s_lo.device.type != "cuda":
        raise ValueError(f"bfm_tile_counts: unsupported device {s_lo.device}")
    _check_bounds(s_lo, s_hi, u_lo, u_hi)
    if ts * tu > _INT32_MAX:
        raise ValueError(f"a tile count must fit int32; ts*tu = {ts * tu}")
    if n == 0 or m == 0:
        return torch.empty((n // ts, m // tu), dtype=torch.int32,
                           device=s_lo.device)
    lib = _build.load("bfm")
    d = s_lo.shape[1]
    if lib.bfm_tile_counts_smem(ts, tu, d) == 0:
        raise ValueError(f"tiles ts={ts}, tu={tu} at d={d} need more shared "
                         "memory than a CTA has (227 KB)")
    K = (fma_scale(s_lo, s_hi, u_lo, u_hi)
         if lib.bfm_tile_counts_d1_path(ts, tu, d) else 0.0)
    return _launch_tile_counts(s_lo, s_hi, u_lo, u_hi, ts, tu, K)


def _launch_tile_counts(s_lo, s_hi, u_lo, u_hi, ts, tu, K) -> torch.Tensor:
    """K3's launch for bounds that ``bfm_tile_counts`` has checked, with
    ``fma_scale``'s K (0.0 for the all-FSETP form)."""
    n, m = s_lo.shape[0], u_lo.shape[0]
    out = torch.empty((n // ts, m // tu), dtype=torch.int32,
                      device=s_lo.device)
    lib = _build.load("bfm")
    rc = _build.launch(
        s_lo.device, lib.bfm_tile_counts_launch, s_lo.data_ptr(),
        s_hi.data_ptr(), u_lo.data_ptr(), u_hi.data_ptr(), n, m,
        s_lo.shape[1], ts, tu, out.data_ptr(), K)
    _build.check(lib, "bfm", rc)
    bfm_tile_counts.launches += 1
    return out


def bfm_mask(s_lo, s_hi, u_lo, u_hi) -> torch.Tensor:
    """Full (n, m) bool overlap mask, any n and m.

    Persistent CTAs of 256 threads, static shared memory only (two
    32-row tiles of S bounds).
    """
    _check_d("bfm_mask", s_lo)
    if s_lo.device.type == "cpu":
        return ref.bfm_mask(s_lo, s_hi, u_lo, u_hi)
    if s_lo.device.type != "cuda":
        raise ValueError(f"bfm_mask: unsupported device {s_lo.device}")
    _check_bounds(s_lo, s_hi, u_lo, u_hi)
    n, m = s_lo.shape[0], u_lo.shape[0]
    out = torch.empty((n, m), dtype=torch.bool, device=s_lo.device)
    if n == 0 or m == 0:
        return out
    lib = _build.load("bfm_mask")
    rc = _build.launch(
        s_lo.device, lib.bfm_mask_launch, s_lo.data_ptr(), s_hi.data_ptr(),
        u_lo.data_ptr(), u_hi.data_ptr(), n, m, s_lo.shape[1],
        out.data_ptr())
    _build.check(lib, "bfm_mask", rc)
    bfm_mask.launches += 1
    return out


bfm_tile_counts.launches = 0
bfm_mask.launches = 0
