"""Interval Tree Matching (ITM) — paper §3, Alg. 5, as plain torch.

The port's counterpart of the JAX package's ``core/itm.py``.  The tree
is the reference's pointer-free one: a perfectly balanced BST over the
lo-sorted intervals in implicit Eytzinger layout (node k has children
2k and 2k+1, arrays 1-indexed, length M+1 = 2^h), padded to a full tree
with sentinels (lo = +inf, hi = −inf, id = −1), with each node's subtree
``minlower``/``maxupper`` bounds.  Construction is a stable sort, one
gather into in-order positions and h bottom-up max/min levels.

Queries are the reference's pruned DFS with an explicit stack: pop a
node; prune it if its subtree bounds cannot overlap the query; count
(or record) it if its own interval overlaps; push the left child, then
the right child unless the query ends at or before the node's lo.  So
the right subtree is visited first, and hits are written in that DFS
order.  The reference ``vmap``s a ``lax.while_loop`` over the queries;
here the same machine runs lock-step over the whole batch (``_lockstep``:
a ``(b, h+2)`` stack and one ``sp`` per query, one step per pop until
every stack is empty).  That is the ``backend="torch"`` path and the
plain version of the CUDA tree walk K8 (``kernels/itm.py``), which runs
one thread per query, the paper's "for all u in parallel".

``jnp.argsort`` is stable and ``torch.argsort`` is not unless asked, so
the build sorts with ``stable=True``: intervals with tied lo keep their
index order, and the five arrays come out bit-equal to the reference's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..spans import span
from .regions import Regions
from .sbm import _total

_I32 = torch.int32


class ITree(NamedTuple):
    """Implicit interval tree.  Tensors are 1-indexed, length M+1 = 2^h."""

    lo: torch.Tensor        # node interval lower bound
    hi: torch.Tensor        # node interval upper bound
    minlower: torch.Tensor  # subtree min lo
    maxupper: torch.Tensor  # subtree max hi
    ids: torch.Tensor       # original region index (−1 for sentinel)

    @property
    def height(self) -> int:
        return int(self.lo.shape[0]).bit_length() - 1   # M+1 = 2^h


def _inorder(h: int, device) -> torch.Tensor:
    """In-order rank of every node 1..M of a complete tree of height h.

    Level d is the node range [2^d, 2^(d+1)); its j-th node has in-order
    rank (2j+1)·2^(h-1-d) − 1.  Integer arithmetic, level by level.
    """
    levels = []
    for d in range(h):
        j = torch.arange(1 << d, dtype=torch.int64, device=device)
        levels.append((2 * j + 1) * (1 << (h - 1 - d)) - 1)
    return torch.cat(levels)


def _build(lo_1d: torch.Tensor, hi_1d: torch.Tensor, n: int) -> ITree:
    h = max(n.bit_length(), 1)
    M = (1 << h) - 1
    dev = lo_1d.device
    order = torch.argsort(lo_1d, stable=True)
    pad = M - n
    slo = torch.cat([lo_1d[order],
                     torch.full((pad,), float("inf"), device=dev)])
    shi = torch.cat([hi_1d[order],
                     torch.full((pad,), float("-inf"), device=dev)])
    sid = torch.cat([order.to(_I32),
                     torch.full((pad,), -1, dtype=_I32, device=dev)])
    inorder = _inorder(h, dev)
    tree_lo = torch.cat([torch.full((1,), float("inf"), device=dev),
                         slo[inorder]])
    tree_hi = torch.cat([torch.full((1,), float("-inf"), device=dev),
                         shi[inorder]])
    tree_id = torch.cat([torch.full((1,), -1, dtype=_I32, device=dev),
                         sid[inorder]])
    maxupper = tree_hi.clone()
    minlower = tree_lo.clone()
    for lvl in range(h - 2, -1, -1):
        a, b = 1 << lvl, 1 << (lvl + 1)
        kids = maxupper[b:2 * b].view(-1, 2)
        maxupper[a:b] = torch.maximum(
            maxupper[a:b], torch.maximum(kids[:, 0], kids[:, 1]))
        kids = minlower[b:2 * b].view(-1, 2)
        minlower[a:b] = torch.minimum(
            minlower[a:b], torch.minimum(kids[:, 0], kids[:, 1]))
    return ITree(tree_lo, tree_hi, minlower, maxupper, tree_id)


def build_tree(R: Regions, dim: int = 0) -> ITree:
    """The interval tree of ``R``'s dimension ``dim``, on ``R``'s device."""
    with span("itm.build_tree"):
        lo, hi = R.dim(dim)
        return _build(lo.float(), hi.float(), R.n)


# ---------------------------------------------------------------------------
# queries: the lock-step walk
# ---------------------------------------------------------------------------

def _lockstep(tree: ITree, q_lo: torch.Tensor, q_hi: torch.Tensor,
              cap: int = 0):
    """Every query's DFS, one pop per step for the whole batch.

    Returns ``(buf, cnt, visits)``: int32 ``(b, cap)`` ids of the first
    ``cap`` hits of each query in DFS order, −1 padded; int32 ``(b,)`` hit
    counts, which go on past ``cap``; and int32 ``(b,)`` nodes popped per
    query.
    """
    dev = tree.lo.device
    b = q_lo.shape[0]
    M = tree.lo.shape[0] - 1
    h = tree.height
    stack = torch.zeros((b, h + 2), dtype=torch.int64, device=dev)
    stack[:, 0] = 1
    sp = torch.ones(b, dtype=torch.int64, device=dev)
    cnt = torch.zeros(b, dtype=_I32, device=dev)
    visits = torch.zeros(b, dtype=_I32, device=dev)
    buf = torch.full((b, cap), -1, dtype=_I32, device=dev)
    rows = torch.arange(b, device=dev)
    while b and bool((sp > 0).any()):
        act = sp > 0
        k = stack.gather(1, (sp - 1).clamp(min=0)[:, None]).squeeze(1)
        sp = sp - act.long()
        visits += act.to(_I32)
        live = act & ~((tree.maxupper[k] <= q_lo)
                       | (tree.minlower[k] >= q_hi))
        node_lo = tree.lo[k]
        node_id = tree.ids[k]
        hit = (live & (node_lo < q_hi) & (q_lo < tree.hi[k])
               & (node_id >= 0))
        if cap:
            w = hit & (cnt < cap)
            buf[rows[w], cnt[w].long()] = node_id[w]
        cnt += hit.to(_I32)
        push_l = live & (2 * k <= M)
        push_r = push_l & (q_hi > node_lo)
        for push, child in ((push_l, 2 * k), (push_r, 2 * k + 1)):
            at = sp[:, None]
            stack.scatter_(1, at, torch.where(push, child,
                                              stack.gather(1, at)[:, 0])
                           [:, None])
            sp = sp + push.long()
    return buf, cnt, visits


def itm_query_counts(tree: ITree, q_lo, q_hi) -> torch.Tensor:
    """Per-query overlap counts, int32 (b,) — paper Alg. 5, counting."""
    return _lockstep(tree, q_lo, q_hi)[1]


def itm_query_pairs(tree: ITree, q_lo, q_hi, cap: int):
    """``(ids int32 (b, cap) −1-padded in DFS order, counts int32 (b,))``;
    the counts go on past ``cap``."""
    return _lockstep(tree, q_lo, q_hi, cap)[:2]


def verify_dims(ids: torch.Tensor, o_lo, o_hi, q_lo, q_hi):
    """Keep the dim-0 ids that overlap their query on dims 1..d-1 too.

    ``ids`` is int32 ``(b, cap)`` (−1 pads) into the regions with bounds
    ``o_lo``/``o_hi`` (n, d); ``q_lo``/``q_hi`` are (b, d).  Returns
    ``(ids with −1 where a dimension fails, verified counts int32 (b,))``,
    uncompacted, as the reference's ``itm_query_pairs_dd``.
    """
    ok = ids >= 0
    if o_lo.shape[1] > 1:
        ic = ids.clamp(min=0).long()
        for j in range(1, o_lo.shape[1]):
            ok &= ((o_lo[:, j][ic] < q_hi[:, j, None])
                   & (q_lo[:, j, None] < o_hi[:, j][ic]))
        ids = torch.where(ok, ids, -1)
    return ids, ok.sum(dim=-1, dtype=_I32)


def itm_query_pairs_dd(tree: ITree, o_lo, o_hi, q_lo, q_hi, cap: int):
    """Batched d-dim overlap query: dim-0 tree walk, then verify dims 1+.

    ``tree`` indexes dim 0 of the regions whose full bounds are
    ``o_lo``/``o_hi`` (n, d); ``q_lo``/``q_hi`` are (b, d) query boxes.
    Returns ``(ids, counts)``: (b, cap) ids overlapping each query on all
    dimensions (−1 where the walk wrote none or a dimension fails) and
    (b,) verified counts.  ``cap`` must cover the dim-0 count per query.
    """
    ids, _ = itm_query_pairs(tree, q_lo[:, 0], q_hi[:, 0], cap)
    return verify_dims(ids, o_lo, o_hi, q_lo, q_hi)


def itm_count(S: Regions, U: Regions, swap: str = "auto") -> int:
    """Total K: build the tree on one set, query the other (Alg. 5).

    ``swap='auto'`` builds the tree on the smaller set (paper §3's
    m ≪ n optimization).
    """
    assert S.d == 1
    build_on_S = S.n <= U.n if swap == "auto" else (swap == "S")
    T = build_tree(S if build_on_S else U)
    Q = U if build_on_S else S
    return _total(itm_query_counts(T, Q.lo[:, 0], Q.hi[:, 0]))
