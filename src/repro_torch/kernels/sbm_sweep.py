"""K1 — the SBM sweep as a hand-written CUDA kernel (``csrc/sbm_sweep.cu``).

Replaces the JAX package's Pallas kernel
``kernels/sbm_sweep.py:_sweep_kernel``.  Given the lex-sorted endpoint
flags ``is_lo``/``is_upd``, it writes each endpoint's SBM report count
``is_hi·(is_sub·upd_active + is_upd·sub_active)``, the active counts
being inclusive prefix sums of ±1 deltas.

The TPU kernel carried the two running totals across grid steps in
SMEM, legal only because a TPU grid runs in order.  CTAs on Hopper run
in no order, so the CUDA kernel is a three-phase scan: per-CTA delta
sums, one CTA's exclusive scan of those sums, and a local rescan of
each tile seeded with its carry.  The ragged tail is masked in the
kernel, so the wrapper pads nothing.

Bound on the card: bytes — 12 B per endpoint (two int32 flags in, one
int32 count out).  At the paper's fig. 9 size (2e6 endpoints) that is
24 MB, about 7 µs at 3.35 TB/s; the kernel itself reads the flags twice
(20 B per endpoint).

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


def sbm_sweep(is_lo: torch.Tensor, is_upd: torch.Tensor) -> torch.Tensor:
    """Per-endpoint report counts, int32 ``(T,)``, on the inputs' device."""
    if is_lo.device.type == "cpu":
        return ref.sbm_sweep(is_lo, is_upd)
    if is_lo.device.type != "cuda":
        raise ValueError(f"sbm_sweep: unsupported device {is_lo.device}")
    _check_flags(is_lo, is_upd)
    out = torch.empty_like(is_lo)
    T = is_lo.shape[0]
    if T == 0:
        return out
    lib = _build.load("sbm_sweep")
    tile = lib.sbm_sweep_tile()
    scratch = torch.empty(2 * (-(-T // tile)), dtype=torch.int32,
                          device=is_lo.device)
    rc = _build.launch(is_lo.device, lib.sbm_sweep_launch, is_lo.data_ptr(),
                       is_upd.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                       T)
    _build.check(lib, "sbm_sweep", rc)
    sbm_sweep.launches += 1
    return out


sbm_sweep.launches = 0
