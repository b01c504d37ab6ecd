"""Plain torch versions of the port's CUDA kernels.

Each function computes exactly what its kernel computes, with ordinary
tensor operations on any device.  The kernel wrappers take them for
tensors on the CPU, the CPU tests hold them against the JAX package's
Pallas kernels (interpret mode) or its plain pass 2, and
``chip_smoke.py`` holds each CUDA kernel against them on the card:

* ``sbm_sweep``    — K1's function, ``core.sbm._stream_contribs``
  (the JAX package's ``kernels/ref.py:sbm_sweep``);
* ``twopass_emit`` — K2's function, ``core.sbm._twopass_slots``
  (the slot loop of the JAX package's ``core/sbm.py:_twopass_emit``);
* ``bfm_tile_counts`` / ``bfm_mask`` — K3's and K4's functions (the JAX
  package's ``kernels/ref.py:bfm_tile_counts`` / ``bfm_mask``);
* ``twopass_emit_streaming`` / ``csr_decode_window`` — K5's and K6's
  functions, both ``core.sbm._packed_window`` over the packed table;
* ``itm_walk`` — K8's function, the lock-step tree walk of
  ``core.itm._lockstep`` (the JAX package's vmapped ``while_loop``,
  ``core/itm.py:113,152``; K8 has no Pallas counterpart);
* ``sparse_attn_bh`` — K7's function, the block walk of the JAX
  package's ``kernels/sparse_attn.py:_kernel`` (not ``windowed_attention``
  of its ``kernels/ref.py``, which has no causal mask and no sink).
"""
from __future__ import annotations

import torch

from ..core.brute import _mask_block
from ..core.itm import _lockstep
from ..core.sbm import _packed_window
from ..core.sbm import _stream_contribs as sbm_sweep
from ..core.sbm import _twopass_slots as twopass_emit

__all__ = ["sbm_sweep", "twopass_emit", "bfm_tile_counts", "bfm_mask",
           "twopass_emit_streaming", "csr_decode_window", "itm_walk",
           "sparse_attn_bh"]

# elements of one row block's (rows, m, d) compare in bfm_tile_counts
_TILE_COUNT_BLOCK = 1 << 28
# K7's finite masking sentinel (never -inf: exp(-inf - -inf) is NaN)
NEG_INF = -1e30
# elements of one chunk's (BH, q blocks, bq, walked keys) scores in
# sparse_attn_bh
_ATTN_CHUNK = 1 << 26


def bfm_tile_counts(s_lo, s_hi, u_lo, u_hi, ts: int, tu: int):
    """Per-(S-tile, U-tile) overlap counts, int32 (n/ts, m/tu).

    Inputs are (n, d)/(m, d) float32, n % ts == m % tu == 0.  S is taken
    in blocks of whole tiles so the compare stays near 2^28 elements,
    which lets the card run this at the paper's sizes.
    """
    n, d = s_lo.shape
    m = u_lo.shape[0]
    out = torch.zeros((n // ts, m // tu), dtype=torch.int32,
                      device=s_lo.device)
    if n == 0 or m == 0:
        return out
    rows = max(ts, _TILE_COUNT_BLOCK // max(m * d, 1) // ts * ts)
    for i in range(0, n, rows):
        ok = _mask_block(s_lo[i:i + rows], s_hi[i:i + rows], u_lo, u_hi)
        out[i // ts:(i + rows) // ts] = ok.reshape(
            -1, ts, m // tu, tu).sum(dim=(1, 3), dtype=torch.int32)
    return out


def bfm_mask(s_lo, s_hi, u_lo, u_hi):
    """Full (n, m) bool overlap mask."""
    return _mask_block(s_lo, s_hi, u_lo, u_hi)


def twopass_emit_streaming(tab, perm_s, perm_u, *, max_pairs: int):
    """K5's function: the ``(max_pairs, 2)`` pass-2 buffer from the packed
    compacted table, bit-identical to ``twopass_emit``."""
    return _packed_window(tab, perm_s, perm_u, 0, max_pairs)


def csr_decode_window(tab, perm_s, perm_u, w0: int, nslots: int):
    """K6's function: slots ``[w0, w0 + nslots)`` of the pass-2 buffer
    from the packed compacted table."""
    return _packed_window(tab, perm_s, perm_u, w0, w0 + nslots)


def itm_walk(tree, q_lo, q_hi, cap: int = 0):
    """K8's function: ``(ids (b, cap), counts (b,))``, each query's first
    ``cap`` hits in DFS order, −1 padded; counts go on past ``cap``."""
    return _lockstep(tree, q_lo, q_hi, cap)[:2]


def window_blocks(starts, ends, *, bkv: int, sink_end: int):
    """K7's walk past the sink: first kv block and block count per q
    block, int64 (nq,) each.  The window starts at the aligned-down
    ``max(start, sink_end)``; a count below zero walks nothing."""
    first = torch.clamp(starts.long(), min=sink_end) // bkv
    count = (ends.long() - first * bkv + bkv - 1) // bkv
    return first, torch.clamp(count, min=0)


def sparse_attn_bh(q, k, v, starts, ends, *, bq: int, bkv: int,
                   sink_end: int):
    """K7's function: block-sparse causal attention, q (BH, Sq, dh),
    k/v (BH, Skv, dh), starts/ends int32 (Sq // bq,); output in q's type.

    Query block i walks the ``sink_end // bkv`` sink blocks, then its
    window's blocks from ``max(start, sink_end) // bkv`` up to ``end``.
    A walked key counts when ``kv <= q`` and ``kv < end`` and otherwise
    scores the finite sentinel -1e30; keys at or past Skv are not there
    at all.  So a row that meets no allowed key returns the mean of v
    over the keys it walked, as the TPU kernel does (its online softmax
    gives every masked key weight 1 while its running max is still the
    sentinel).  One softmax over the walked keys gives the online
    softmax's result: a real score zeroes every sentinel weight in both.

    q blocks are taken in chunks whose walked keys are gathered, so
    memory stays O(BH · bq · walked keys) per chunk, never (Sq, Skv).
    Accumulates in float32; on the card it sets
    ``torch.backends.cuda.matmul.allow_tf32 = False`` for its products
    (and restores the setting after).
    """
    BH, Sq, dh = q.shape
    Skv = k.shape[1]
    nq = Sq // bq
    dev = q.device
    out = torch.empty_like(q)
    if BH == 0 or nq == 0:
        return out
    scale = dh ** -0.5
    nsink = sink_end // bkv
    first, count = window_blocks(starts.to(dev), ends.to(dev), bkv=bkv,
                                 sink_end=sink_end)
    ends64 = ends.to(dev).long()
    walk = nsink + count                       # kv blocks walked per q block
    w = int(walk.max())
    if w == 0:              # nothing walked: acc and l stay 0
        return out.zero_()
    # q blocks per chunk, so its scores and gathered keys stay under
    # _ATTN_CHUNK elements
    c = max(1, _ATTN_CHUNK // (BH * max(bq, dh) * w * bkv))
    offs = torch.arange(bkv, device=dev)
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for i0 in range(0, nq, c):
            i1 = min(i0 + c, nq)
            out[:, i0 * bq:i1 * bq] = _attend_chunk(
                q, k, v, i0, i1, w, first, walk, ends64, offs,
                bq=bq, bkv=bkv, nsink=nsink, scale=scale)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    return out


def _attend_chunk(q, k, v, i0, i1, w, first, walk, ends64, offs, *, bq,
                  bkv, nsink, scale):
    """Output rows of q blocks [i0, i1), each walking at most ``w``
    kv blocks, in q's type."""
    BH, _, dh = q.shape
    Skv = k.shape[1]
    dev = q.device
    c = i1 - i0
    i = torch.arange(i0, i1, device=dev)
    j = torch.arange(w, device=dev)
    blk = torch.where(j[None, :] < nsink, j[None, :],
                      first[i0:i1, None] + (j[None, :] - nsink))
    walked = j[None, :] < walk[i0:i1, None]                  # (c, w)
    pos = (blk[:, :, None] * bkv + offs).reshape(c, w * bkv)
    valid = walked.repeat_interleave(bkv, dim=1) & (pos < Skv)
    idx = torch.where(valid, pos, 0).reshape(-1)
    kg = k[:, idx].float().reshape(BH, c, w * bkv, dh)
    vg = v[:, idx].float().reshape(BH, c, w * bkv, dh)
    qc = q[:, i0 * bq:i1 * bq].float().reshape(BH, c, bq, dh) * scale
    s = qc @ kg.transpose(-1, -2)                            # (BH,c,bq,W)
    q_pos = i[:, None] * bq + torch.arange(bq, device=dev)   # (c, bq)
    ok = (valid[:, None, :] & (pos[:, None, :] <= q_pos[:, :, None])
          & (pos[:, None, :] < ends64[i0:i1, None, None]))
    s = torch.where(ok, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * valid[:, None, :]
    l = p.sum(dim=-1, keepdim=True)
    o = (p @ vg) / torch.where(l > 0, l, 1.0)
    return o.reshape(BH, c * bq, dh).to(q.dtype)
