"""DDM matching helpers shared across the engine's consumers.

The port's counterpart of the JAX package's ``core/dd_match.py``:
``block_mask`` (the sparse-attention planner primitive) and
``pairs_to_set`` (validated host-side set assembly over any
``core.pairs.PairsResult`` or raw pair buffer).
"""
from __future__ import annotations

import numpy as np
import torch

from .pairs import PairsResult, to_numpy


def block_mask(q_lo: torch.Tensor, q_hi: torch.Tensor, kv_lo: torch.Tensor,
               kv_hi: torch.Tensor) -> torch.Tensor:
    """(nq, nkv) overlap mask between 1-D query/kv interval batches."""
    return (q_lo[:, None] < kv_hi[None, :]) & (kv_lo[None, :] < q_hi[:, None])


def _range_failure(arr: np.ndarray, m: int, n: int | None, where: str,
                   context: object) -> None:
    from .engine import describe_pair_range_errors

    problems = describe_pair_range_errors(arr, m, n)
    if problems:
        ctx = f"; context={context!r}" if context is not None else ""
        raise ValueError(f"pair buffer index-range failure{where}: "
                         + "; ".join(problems) + ctx)


def _keys(arr: np.ndarray, m: int) -> list[int]:
    arr = arr[arr[:, 0] >= 0]
    return (arr[:, 0].astype(np.int64) * m + arr[:, 1]).tolist()


def pairs_to_set(pairs, m: int, n: int | None = None, *,
                 context: object = None) -> set[int]:
    """Host-side helper: −1-padded (k, 2) pair buffer → ``{s*m + u}`` set.

    Validates every non-pad pair against the region-set sizes: update
    indices must lie in ``[0, m)`` and, when ``n`` is given,
    subscription indices in ``[0, n)``.  On failure the error names the
    offending slots, their (s, u) values and the valid ranges; pass
    ``context=plan`` to have its ``repr`` appear in the message.

    A ``PairsResult`` (``DensePairs`` or the lazy ``CSRPairs`` view) is
    consumed window by window, so the dense ``(cap, 2)`` buffer is never
    materialized; tensors and arrays are read whole.
    """
    if isinstance(pairs, PairsResult):
        out: set[int] = set()
        for w0, arr in pairs.windows():
            _range_failure(arr, m, n, f" (window at slot {w0})", context)
            out.update(_keys(arr, m))
        return out
    arr = to_numpy(pairs)
    _range_failure(arr, m, n, "", context)
    return set(_keys(arr, m))
