"""DDM-planned block-sparse attention layout.

The port's counterpart of the JAX package's ``sparse/planner.py``: the
paper's service applied inside the LM framework.  Each query block
*subscribes* to the key range it may attend to (causal sliding window),
each KV block is an *update region*, and the block-level attention
layout is the set of overlapping (subscription, update) pairs, computed
by the port's matching engine (``core.engine``), the same code path as
the HLA pub/sub matching.

Outputs, on the plan's device:
  * ``block_bitmask`` — (nq, nkv) bool (tests and reference);
  * ``block_windows`` — per-q-block contiguous [start, end) token
    ranges, int32 (nq,) each, consumed by the K7 kernel
    (``kernels.sparse_attn``) together with the sink prefix
    ``plan.sink_end``;
  * ``decode_window`` — the decode-time read range of one position.

Every function takes ``device`` (``"cuda"`` by default; ``"cuda"``
without a card raises).  On the card ``block_windows`` runs the exact
capacity SBM plan's ``pairs()``, i.e. kernels K1 (the counting sweep)
and K2 (the pass-2 emit).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import MatchSpec, Regions, block_mask, build_plan, make_regions

_INT32_MAX = np.iinfo(np.int32).max


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    seq_len: int
    block_q: int
    block_kv: int
    window: int
    sink_blocks: int

    @property
    def nq(self) -> int:
        return -(-self.seq_len // self.block_q)

    @property
    def nkv(self) -> int:
        return -(-self.seq_len // self.block_kv)

    @property
    def sink_end(self) -> int:
        return self.sink_blocks * self.block_kv


def _q_subscriptions(plan: BlockPlan, device="cuda") -> Regions:
    """Query block i subscribes to keys [max(0, end_i - window), end_i)."""
    i = np.arange(plan.nq, dtype=np.float32)
    end = np.minimum((i + 1) * plan.block_q, plan.seq_len)
    start = np.maximum(end - plan.window, 0.0)
    return make_regions(start, end, device)


def _kv_updates(plan: BlockPlan, device="cuda") -> Regions:
    j = np.arange(plan.nkv, dtype=np.float32)
    lo = j * plan.block_kv
    hi = np.minimum((j + 1) * plan.block_kv, plan.seq_len)
    return make_regions(lo, hi, device)


def _causal_ends(plan: BlockPlan, device) -> torch.Tensor:
    """int64 (nq,) token end of each q block, clipped to seq_len."""
    i = torch.arange(plan.nq, dtype=torch.int64, device=device)
    return torch.clamp((i + 1) * plan.block_q, max=plan.seq_len)


def block_bitmask(plan: BlockPlan, device="cuda") -> torch.Tensor:
    """(nq, nkv) bool via DDM interval matching + sink columns."""
    S = _q_subscriptions(plan, device)
    U = _kv_updates(plan, device)
    mask = block_mask(S.lo[:, 0], S.hi[:, 0], U.lo[:, 0], U.hi[:, 0])
    mask[:, :plan.sink_blocks] = True
    # causality at block granularity: kv block start < q block end
    j_lo = torch.arange(plan.nkv, dtype=torch.int64,
                        device=mask.device) * plan.block_kv
    return mask & (j_lo[None, :] < _causal_ends(plan, mask.device)[:, None])


def block_windows(plan: BlockPlan, device="cuda"):
    """Per-q-block contiguous kv token ranges ``(starts, ends)``, int32
    ``(nq,)`` tensors on ``device``.

    Derived from the DDM pair enumeration (not re-derived arithmetic):
    enumerate (q-block, kv-block) matches with an engine ``MatchPlan``
    (exact-capacity SBM), and reduce each q row to its [min, max]
    matched kv block on the device (``scatter_reduce``, bit-equal to the
    reference's ``np.minimum.at``/``np.maximum.at``).  The sink prefix
    is carried separately (``plan.sink_end``).
    """
    S = _q_subscriptions(plan, device)
    U = _kv_updates(plan, device)
    mplan = build_plan(MatchSpec(algo="sbm", capacity="exact",
                                 device=str(torch.device(device))),
                       S.n, U.n, S.d)
    res, _ = mplan.pairs(S, U)
    pairs = res.to_dense()
    pairs = pairs[pairs[:, 0] >= 0].long()
    q_idx, kv_blk = pairs[:, 0], pairs[:, 1]
    dev = S.device
    starts = torch.full((plan.nq,), _INT32_MAX, dtype=torch.int64,
                        device=dev)
    ends = torch.zeros(plan.nq, dtype=torch.int64, device=dev)
    starts.scatter_reduce_(0, q_idx, kv_blk * plan.block_kv, reduce="amin")
    ends.scatter_reduce_(0, q_idx, (kv_blk + 1) * plan.block_kv,
                         reduce="amax")
    # causal clip to the q block's own end, and clip to seq_len
    ends = torch.minimum(torch.clamp(ends, max=plan.seq_len),
                         _causal_ends(plan, dev))
    starts = torch.minimum(starts, ends)
    return starts.to(torch.int32), ends.to(torch.int32)


def decode_window(pos: int, plan: BlockPlan) -> tuple[int, int]:
    """Decode-time read range for a query at absolute position ``pos``:
    [max(sink_end, pos+1-window), pos+1) plus the [0, sink_end) prefix."""
    end = pos + 1
    start = max(end - plan.window, 0)
    return start, end
