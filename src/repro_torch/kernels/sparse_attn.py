"""K7 — DDM-planned block-sparse flash attention in CUDA
(``csrc/sparse_attn.cu``).

Replaces the JAX package's Pallas kernel ``kernels/sparse_attn.py:_kernel``
(wrappers ``_sparse_attn_bh``, ``sparse_attn_1h``, ``sparse_attn``).  It
consumes the per-q-block ``[start, end)`` kv windows of
``repro_torch.sparse.planner.block_windows`` (the paper's interval
matcher) and the sink prefix ``[0, sink_end)``: query block i walks the
``sink_end // bkv`` sink blocks, then the blocks from
``max(start, sink_end) // bkv`` up to ``end``, under the mask
``kv <= q & kv < end``, with a float32 online softmax and the finite
sentinel -1e30; the output is in q's type.  The function is
``ref.sparse_attn_bh``'s.  So when ``sink_end % bkv != 0`` the sink
keys ``[sink_end // bkv · bkv, sink_end)`` are read only by q blocks
whose window walk starts at or below them, as in the reference's
kernel; the planner's ``BlockPlan.sink_end`` is whole blocks and never
meets this.

Bound on the card: operations, ``4 · dh`` FLOP per allowed (query, key)
pair and head (``kv <= q``, ``kv < end``, in a walked block), against the
bf16 tensor-core rate; at Zamba2-2.7B's attention (32 heads, dh 80, 32k
tokens, window 4096) that is ~1.3e12 FLOP, ~1.3 ms, against ~0.67 GB of
q/k/v/out (~0.2 ms).  bfloat16 inputs run on the tensor cores
(``mma.sync``, float32 accumulate), float32 inputs on the CUDA cores.

Shared memory a CTA: bfloat16, 128 threads and
``2·(64 + 4·64)·(ceil(dh/16)·16 + 8)`` bytes (q rows and two stages of k
and v); float32, 256 threads and ``4·((64 + 2·64)·(dh + 4) + 64·80)``
bytes (q, k and v rows and the P tile).  The grid is
``(Sq/bq · ceil(bq/64), BH)``.

Accuracy against the plain version (``BF16_TOL``, ``F32_TOL``).  In
float32 both compute the same sums in another order: 2e-5.  In bfloat16
the kernel rounds P to bf16 before P·V (relative error <= 2^-8 per
weight, bf16's unit roundoff) while its row sums stay float32, so an
output element moves by at most ``2^-8 · (sum of p·|v|) / l``, which is
the plain version evaluated on ``|v|``; the output's own rounding adds at
most ``2^-8·|out|``, inside ``2^-7·|want|``.  So every element satisfies
``|got - want| <= atol + ptol·plain(|v|) + rtol·|want|``, and the
relative RMS of the difference stays under ``rms`` (the roundings do not
line up: their RMS is far below their worst case).

The public functions keep the JAX package's layouts: ``sparse_attn_bh``
(BH, S, dh), ``sparse_attn_1h`` (S, dh) and ``sparse_attn``
(B, S, H, dh), whose batch·head fold is the reference's transpose and
reshape.  Inputs are float32 or bfloat16 (one type for q, k and v),
contiguous, with ``dh`` a multiple of 8 up to 256; ``starts``/``ends``
are int32 ``(Sq // bq,)`` on q's device, shared by every head, with
``ends <= Skv``.  A violation raises ``ValueError``.  ``ends <= Skv`` is
read once per windows tensor (a sync on the card), not on every call
with the same, unmodified windows; the kernel masks every key at or past
Skv in any case.

``sparse_attn_bh`` launches the kernel for CUDA tensors (or raises) and
runs the plain version for CPU tensors; there is no fallback between
them.  ``sparse_attn_bh.launches`` counts kernel launches.
"""
from __future__ import annotations

import weakref

import torch

from . import _build, ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel against its plain version (see the module docstring); ptol
# scales the plain version evaluated on |v|
BF16_TOL = dict(atol=1e-4, rtol=2 ** -7, ptol=2 ** -8, rms=2 ** -8)
F32_TOL = dict(atol=2e-5, rtol=2e-5, ptol=0.0, rms=2e-5)
MAX_DH = 256
_INT32_MAX = 2 ** 31 - 1
# CUDA's limit on gridDim.y, which carries batch·head
_MAX_BH = 65535


def _check(q, k, v, starts, ends, *, bq: int, bkv: int,
           sink_end: int) -> None:
    """The reference's asserts, and what the kernel takes, as ValueErrors."""
    if bq < 1 or bkv < 1 or sink_end < 0:
        raise ValueError(f"need bq >= 1, bkv >= 1, sink_end >= 0; got "
                         f"bq={bq} bkv={bkv} sink_end={sink_end}")
    if max(bq, bkv, sink_end) > _INT32_MAX:
        # the kernel takes all three as a C int, which ctypes would wrap
        raise ValueError(f"bq, bkv and sink_end must be <= {_INT32_MAX}; "
                         f"got bq={bq} bkv={bkv} sink_end={sink_end}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.ndim != 3 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (BH, S, dh) "
                             f"tensor, got {tuple(x.shape)}")
        if x.dtype not in DTYPES or x.dtype != q.dtype:
            raise ValueError(f"q, k and v must all be float32 or all "
                             f"bfloat16, got {q.dtype}, {k.dtype}, "
                             f"{v.dtype}")
        if x.device != q.device:
            raise ValueError(f"{name} lives on {x.device}, q on {q.device}")
    BH, Sq, dh = q.shape
    if k.shape != v.shape or k.shape[0] != BH or k.shape[2] != dh:
        raise ValueError(f"k and v must be (BH, Skv, dh) = ({BH}, Skv, "
                         f"{dh}), got {tuple(k.shape)}, {tuple(v.shape)}")
    if dh % 8 or not 8 <= dh <= MAX_DH:
        raise ValueError(f"dh must be a multiple of 8 in [8, {MAX_DH}], "
                         f"got {dh}")
    if Sq % bq:
        raise ValueError(f"Sq % bq must be 0, got Sq={Sq} bq={bq}")
    nq = Sq // bq
    for name, x in (("starts", starts), ("ends", ends)):
        if not isinstance(x, torch.Tensor) or x.shape != (nq,):
            raise ValueError(f"{name} must be a ({nq},) tensor (Sq // bq),"
                             f" got {getattr(x, 'shape', type(x))}")
        if x.dtype != torch.int32 or x.device != q.device:
            raise ValueError(f"{name} must be int32 on {q.device}, got "
                             f"{x.dtype} on {x.device}")
    _check_ends(ends, k.shape[1])


# (ends, its version, Skv) of the last windows found within Skv: calls on
# the same unmodified windows skip the max, which on the card is a
# device-to-host sync
_ends_ok = (lambda: None, -1, -1)


def _check_ends(ends, skv: int) -> None:
    global _ends_ok
    seen, version, seen_skv = _ends_ok
    if seen() is ends and version == ends._version and seen_skv == skv:
        return
    top = int(ends.max()) if ends.numel() else 0
    if top > skv:
        raise ValueError(f"ends must be <= Skv = {skv}, got max {top}")
    _ends_ok = (weakref.ref(ends), ends._version, skv)


def _launch(q, k, v, starts, ends, out, *, bq: int, bkv: int,
            sink_end: int) -> None:
    """Launch K7 on checked CUDA tensors; raises on a CUDA error."""
    lib = _build.load("sparse_attn")
    BH, Sq, dh = q.shape
    rc = _build.launch(q.device, lib.sparse_attn_launch, q.data_ptr(),
                       k.data_ptr(), v.data_ptr(), starts.data_ptr(),
                       ends.data_ptr(), out.data_ptr(), DTYPES[q.dtype], BH,
                       Sq, k.shape[1], dh, bq, bkv, sink_end, dh ** -0.5)
    _build.check(lib, "sparse_attn", rc)


def sparse_attn_bh(q, k, v, starts, ends, *, bq: int = 128,
                   bkv: int = 128, sink_end: int = 0) -> torch.Tensor:
    """q (BH, Sq, dh), k/v (BH, Skv, dh) → (BH, Sq, dh) in q's type."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sparse_attn: unsupported device {q.device}")
    _check(q, k, v, starts, ends, bq=bq, bkv=bkv, sink_end=sink_end)
    if q.device.type == "cpu":
        return ref.sparse_attn_bh(q, k, v, starts, ends, bq=bq, bkv=bkv,
                                  sink_end=sink_end)
    if q.shape[0] > _MAX_BH:
        raise ValueError(f"batch·head must be <= {_MAX_BH}, got "
                         f"{q.shape[0]}")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("q, k and v must start on a 16-byte boundary")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    _launch(q, k, v, starts, ends, out, bq=bq, bkv=bkv, sink_end=sink_end)
    sparse_attn_bh.launches += 1
    return out


sparse_attn_bh.launches = 0


def sparse_attn_1h(q, k, v, starts, ends, *, bq: int = 128,
                   bkv: int = 128, sink_end: int = 0) -> torch.Tensor:
    """Single head: q (Sq, dh), k/v (Skv, dh), starts/ends (nq,) int32."""
    if q.ndim != 2 or k.ndim != 2 or v.ndim != 2:
        raise ValueError(f"q, k, v must be (S, dh), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    return sparse_attn_bh(q[None], k[None], v[None], starts, ends, bq=bq,
                          bkv=bkv, sink_end=sink_end)[0]


def sparse_attn(q, k, v, starts, ends, *, bq: int = 128, bkv: int = 128,
                sink_end: int = 0) -> torch.Tensor:
    """Batched multi-head: q/k/v (B, S, H, dh), batch·head folded."""
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, S, H, dh) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, dh = q.shape

    def fold(x):
        return x.transpose(1, 2).reshape(B * H, S, dh).contiguous()

    out = sparse_attn_bh(fold(q), fold(k), fold(v), starts, ends, bq=bq,
                         bkv=bkv, sink_end=sink_end)
    return out.reshape(B, H, S, dh).transpose(1, 2)
