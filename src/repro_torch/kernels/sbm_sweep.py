"""K1 — the SBM sweep as a hand-written CUDA kernel (``csrc/sbm_sweep.cu``).

Replaces the JAX package's Pallas kernel
``kernels/sbm_sweep.py:_sweep_kernel``.  Given the lex-sorted endpoint
flags ``is_lo``/``is_upd``, it writes each endpoint's SBM report count
``is_hi·(is_sub·upd_active + is_upd·sub_active)``, the active counts
being inclusive prefix sums of ±1 deltas.

The TPU kernel carried the two running totals across grid steps in
SMEM, legal only because a TPU grid runs in order.  CTAs on Hopper run
in no order, so the CUDA kernel is a single-pass scan with decoupled
look-back: one launch, in which each CTA takes the next tile from a
counter, publishes its tile's aggregate, adds its predecessors'
published aggregates until it meets a published inclusive prefix, and
writes its counts.  The ragged tail is masked in the kernel and inputs
off a 16-byte boundary take its scalar instance, so the wrapper pads
nothing.

Bound on the card: bytes — 12 B per endpoint (two int32 flags in, one
int32 count out), each read or written once.  At the paper's fig. 9
size (2e6 endpoints) that is 24 MB, about 7 µs at 3.35 TB/s.

One call is one allocation (the kernel's scratch, then the counts,
returned as a view of it), one memset of the scratch and one kernel
launch, on the current stream.  The scratch comes from PyTorch's
caching allocator, which orders reuse by stream, so calls on two
streams never share it.

Shared memory: static only (the tile index, the warp sums and the
prefix); a CTA of 256 threads a tile (``analysis.kernel_audit``'s model).

``sbm_sweep`` launches the kernel for CUDA tensors (or raises) and
runs the plain version (``ref.sbm_sweep``) for CPU tensors; there is no
fallback between them.  ``sbm_sweep.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from . import _build, ref


def _check_flags(is_lo: torch.Tensor, is_upd: torch.Tensor) -> None:
    for name, x in (("is_lo", is_lo), ("is_upd", is_upd)):
        if x.dtype != torch.int32 or x.ndim != 1 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 "
                             f"tensor, got {x.dtype} {tuple(x.shape)}")
    if is_lo.shape != is_upd.shape or is_lo.device != is_upd.device:
        raise ValueError("is_lo and is_upd must match in shape and device")


def scratch_words(T: int, tile: int) -> int:
    """int32 words of K1's scratch for ``T`` endpoints in tiles of
    ``tile``: the tile counter (8 bytes), then three 64-bit descriptor
    words a tile (``csrc/sbm_sweep.cu``), rounded up to 16 bytes so that
    the counts placed after it start on 16 bytes."""
    return -(-(2 + 6 * (-(-T // tile))) // 4) * 4


def sbm_sweep(is_lo: torch.Tensor, is_upd: torch.Tensor) -> torch.Tensor:
    """Per-endpoint report counts, int32 ``(T,)``, on the inputs' device."""
    dev = is_lo.device
    if dev.type == "cpu":
        return ref.sbm_sweep(is_lo, is_upd)
    if dev.type != "cuda":
        raise ValueError(f"sbm_sweep: unsupported device {dev}")
    _check_flags(is_lo, is_upd)
    T = is_lo.shape[0]
    if T == 0:
        return torch.empty_like(is_lo)
    lib = _build.load("sbm_sweep")
    words = scratch_words(T, lib.const["sbm_sweep_tile"])
    buf = torch.empty(words + T, dtype=torch.int32, device=dev)
    scratch = buf.data_ptr()
    rc = _build.launch(dev, lib.sbm_sweep_launch, is_lo.data_ptr(),
                       is_upd.data_ptr(), scratch + 4 * words, scratch, T)
    _build.check(lib, "sbm_sweep", rc)
    sbm_sweep.launches += 1
    return buf[words:]


sbm_sweep.launches = 0
