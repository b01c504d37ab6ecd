"""K2 — two-pass emit, pass 2, as a hand-written CUDA kernel (``csrc/emit.cu``).

Replaces the JAX package's resident Pallas kernel
``kernels/emit.py:_emit_kernel``.  From pass 1's tables (saturated
offsets, per-emitter counts and start ranks, the two lo-sort
permutations) it writes every output slot's pair: slot ``t`` belongs to
the last emitter ``e`` with ``offs[e] <= t`` (a binary search), its rank
is ``t − offs[e]``, and the partner is read from ``perm_u`` (class A,
``e < n``) or ``perm_s`` (class B).  Ranks past the emitter's count give
the −1 pad, so the output is bit-identical to the plain pass 2.

The TPU kernel kept all five tables in VMEM, which capped it near 5e5
regions.  On Hopper the tables stay in device memory and are served by
the 50 MB L2 (about 16 MB at N = 1e6), so this one route covers every
size the int32 slot ids allow; the TPU's streaming and CSR routes and
their byte-budget policy are not needed to reach the paper's sizes
(re-deriving them for Hopper is ROADMAP Queue 1 item 6).

Bound on the card: bytes — each slot writes 8 B (one int2 store into the
``(max_pairs, 2)`` buffer).  At the paper's fig. 9 size (K ≈ 5e7) that
is 400 MB, about 0.12 ms at 3.35 TB/s; the tables add ~16 MB of reads.
One thread per slot in a grid-stride loop with 64-bit slot arithmetic.

``twopass_emit`` launches the kernel for CUDA tensors (or raises) and
runs the plain version (``ref.twopass_emit``) for CPU tensors.
``max_pairs == 0`` returns an empty ``(0, 2)`` buffer without a launch.
``twopass_emit.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from . import _build, ref

_INT32_MAX = 2 ** 31 - 1


def _check_tables(offs, counts, starts, perm_s, perm_u) -> None:
    n, m = perm_s.shape[0], perm_u.shape[0]
    want = {"offs": n + m + 1, "counts": n + m, "starts": n + m,
            "perm_s": n, "perm_u": m}
    for name, x in zip(want, (offs, counts, starts, perm_s, perm_u)):
        if (x.dtype != torch.int32 or x.ndim != 1 or not x.is_contiguous()
                or x.shape[0] != want[name] or x.device != offs.device):
            raise ValueError(
                f"{name} must be a contiguous int32 ({want[name]},) tensor "
                f"on {offs.device}, got {x.dtype} {tuple(x.shape)} on "
                f"{x.device}")
    if n == 0 or m == 0:
        raise ValueError("twopass_emit needs n >= 1 and m >= 1 emitters")


def twopass_emit(offs, counts, starts, perm_s, perm_u, *,
                 max_pairs: int) -> torch.Tensor:
    """Pass-2 pair write: ``(max_pairs, 2)`` int32, −1 padded."""
    if max_pairs == 0:
        return torch.empty((0, 2), dtype=torch.int32, device=offs.device)
    if offs.device.type == "cpu":
        return ref.twopass_emit(offs, counts, starts, perm_s, perm_u,
                     max_pairs=max_pairs)
    if offs.device.type != "cuda":
        raise ValueError(f"twopass_emit: unsupported device {offs.device}")
    if not 0 < max_pairs <= _INT32_MAX:
        raise ValueError(f"max_pairs must be in [0, {_INT32_MAX}] (int32 "
                         f"slot ids), got {max_pairs}")
    _check_tables(offs, counts, starts, perm_s, perm_u)
    out = torch.empty((max_pairs, 2), dtype=torch.int32, device=offs.device)
    lib = _build.load("emit")
    with torch.cuda.device(offs.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.twopass_emit_launch(
            offs.data_ptr(), counts.data_ptr(), starts.data_ptr(),
            perm_s.data_ptr(), perm_u.data_ptr(), perm_s.shape[0],
            perm_u.shape[0], max_pairs, out.data_ptr(), stream)
    _build.check(lib, "twopass_emit", rc)
    twopass_emit.launches += 1
    return out


twopass_emit.launches = 0
