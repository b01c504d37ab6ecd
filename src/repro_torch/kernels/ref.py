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
  functions, both ``core.sbm._packed_window`` over the packed table.
"""
from __future__ import annotations

import torch

from ..core.brute import _mask_block
from ..core.sbm import _packed_window
from ..core.sbm import _stream_contribs as sbm_sweep
from ..core.sbm import _twopass_slots as twopass_emit

__all__ = ["sbm_sweep", "twopass_emit", "bfm_tile_counts", "bfm_mask",
           "twopass_emit_streaming", "csr_decode_window"]

# elements of one row block's (rows, m, d) compare in bfm_tile_counts
_TILE_COUNT_BLOCK = 1 << 28


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
