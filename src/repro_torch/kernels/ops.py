"""Public wrappers that put the CUDA kernels on the SBM main path.

The port's counterpart of the main-path half of the JAX package's
``kernels/ops.py``: ``sbm_count_cuda`` (its ``sbm_count_pallas`` /
``_sweep``) and ``twopass_pairs_cuda`` (its ``twopass_pairs_pallas``,
resident route).  Sorts, searchsorted and the offset scan around the
kernels stay library calls, as they were XLA outside Pallas in the
reference.  The kernels run for regions on the card; regions on the
CPU take the kernels' plain versions.

Emit routes: ``auto`` and ``resident`` take kernel K2, which reads its
tables from device memory at any n+m, so the TPU's VMEM route policy
does not apply; ``xla`` takes the plain torch pass 2
(``core.sbm.sbm_pairs``); ``streaming`` and ``csr`` are not ported
(ROADMAP Queue 1 item 6) and raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from ..core import sbm
from ..core.engine import EMIT_ROUTES
from ..core.regions import Regions
from . import emit as emit_kernel
from . import sbm_sweep as sweep_kernel

# last route taken by twopass_pairs_cuda (None before any call / after
# an empty-set short-circuit), so tests can see which path ran
_LAST_EMIT_ROUTE: str | None = None


def last_emit_route() -> str | None:
    return _LAST_EMIT_ROUTE


def _sweep(s_lo, s_hi, u_lo, u_hi) -> torch.Tensor:
    """Per-endpoint sweep counts: library lex-sort, then kernel K1."""
    is_lo, is_upd = sbm._endpoint_stream(s_lo, s_hi, u_lo, u_hi)
    return sweep_kernel.sbm_sweep(is_lo, is_upd)


def sbm_count_cuda(S: Regions, U: Regions) -> int:
    """Total K via sort + the K1 sweep kernel (1-D regions), exact int64."""
    assert S.d == 1
    if S.n == 0 or U.n == 0:
        return 0
    c = _sweep(S.lo[:, 0], S.hi[:, 0], U.lo[:, 0], U.hi[:, 0])
    return int(c.sum(dtype=torch.int64))


def twopass_pairs_cuda(S: Regions, U: Regions, max_pairs: int, *,
                       route: str = "auto"):
    """Exact 1-D pair enumeration, pass 2 in the K2 emit kernel.

    Same contract as ``core.sbm.sbm_pairs``: ``(pairs, exact count)``,
    ``pairs`` an int32 ``(max_pairs, 2)`` −1-padded tensor on the
    regions' device; truncation still reports the true K.
    """
    global _LAST_EMIT_ROUTE
    assert S.d == 1
    if route not in EMIT_ROUTES:
        raise ValueError(f"route must be one of {EMIT_ROUTES}, got {route}")
    if route in ("streaming", "csr"):
        raise NotImplementedError(
            f"emit route {route!r} is not ported yet (ROADMAP Queue 1 item "
            "6); 'auto'/'resident' take the CUDA emit kernel at any size")
    if S.n == 0 or U.n == 0:
        _LAST_EMIT_ROUTE = None
        return torch.full((max_pairs, 2), -1, dtype=torch.int32,
                          device=S.device), 0
    _LAST_EMIT_ROUTE = "xla" if route == "xla" else "resident"
    if route == "xla":
        return sbm.sbm_pairs(S, U, max_pairs)
    perm_s, perm_u, starts, counts, offs, cnt_a, cnt_b = sbm._twopass_phase1(
        S.lo[:, 0], S.hi[:, 0], U.lo[:, 0], U.hi[:, 0], max_pairs)
    pairs = emit_kernel.twopass_emit(offs, counts, starts, perm_s, perm_u,
                                     max_pairs=max_pairs)
    return pairs, sbm._total(cnt_a) + sbm._total(cnt_b)
