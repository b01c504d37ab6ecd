"""K8 — the interval tree walk as a hand-written CUDA kernel
(``csrc/itm_walk.cu``).

The JAX package walks its tree with a ``lax.while_loop`` ``vmap``ped
over the queries (``core/itm.py:113,152``), which XLA compiles into one
loop on the device; it has no Pallas kernel.  The port's plain version,
``core.itm._lockstep``, runs that stack machine lock-step from Python,
one step per pop of the slowest query.  K8 computes the same function:
each query's count, going on past ``cap``, and its first ``cap`` hit ids
in the reference's right-first DFS order into a ``(b, cap)`` int32 buffer
that this wrapper prefills with −1 (row offsets are 64-bit: b·cap may
pass 2^31).  It has two instances (counts only; counts and ids), each
one launch, in one of two regimes.

What bounds it on the card: each node visit is a dependent read of the
tree from L2, so a query's walk is a chain of reads as long as the walk.
Both regimes walk without a stack: the tree is complete, so the node
after a finished subtree follows from the node index's bits.

* **Thread regime** (b above the card's SM count: fig. 9, Koln, a
  service tick): a thread per query, thread t walking query ``order[t]``,
  the queries' argsort by lo (``query_order``, one library sort), so the
  lanes of a warp share most of their paths; the many warps in flight
  hide the latency.  The pairs instance stages each lane's hits in
  shared memory and writes whole 32-byte sectors of its row.  A caller
  that walks the same queries twice sorts once and passes the order to
  both.
* **CTA regime** (b at most the SM count: serving's batch of 64 boxes,
  the distributed query's rows): a CTA per query expands the tree level
  by level across its threads, in pre-order, then walks the subtrees
  left open with its warps, and places every hit by a scan; its floor is
  the tree's height in dependent reads.  It takes no order, and the
  wrapper sorts none for it.

Shared memory: the CTA regime takes 159,812 bytes a CTA of 512 threads
(two lists of 12,288 entries, their counts and flags, the scan's sums);
the thread regime, 256 queries a CTA, static shared memory only.

``regime`` is the rule; ``itm_walk(..., _regime=...)`` forces either
regime on the same inputs (for the tests and ``chip_smoke.py``).
``itm_walk`` launches the kernel for CUDA tensors (or raises) and runs
the plain version (``ref.itm_walk``) for CPU tensors; there is no
fallback between them or between the regimes.  ``itm_walk.launches``
counts kernel launches, ``itm_walk.cta_launches`` those in the CTA
regime.
"""
from __future__ import annotations

import torch

from . import _build, ref


def _check(tree, q_lo: torch.Tensor, q_hi: torch.Tensor) -> None:
    dev = q_lo.device
    for name, x, dtype in (("lo", tree.lo, torch.float32),
                           ("hi", tree.hi, torch.float32),
                           ("minlower", tree.minlower, torch.float32),
                           ("maxupper", tree.maxupper, torch.float32),
                           ("ids", tree.ids, torch.int32)):
        if (x.dtype != dtype or x.ndim != 1 or not x.is_contiguous()
                or x.device != dev or x.shape != tree.lo.shape):
            raise ValueError(
                f"tree.{name} must be a contiguous 1-D {dtype} tensor of "
                f"the tree's length on {dev}, got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}")
    size = tree.lo.shape[0]
    if size < 2 or size & (size - 1) or size > 1 << 31:
        raise ValueError(f"a tree's length must be a power of two in "
                         f"[2, 2^31], got {size}")
    for name, x in (("q_lo", q_lo), ("q_hi", q_hi)):
        if x.dtype != torch.float32 or x.ndim != 1 or x.device != dev:
            raise ValueError(f"{name} must be a 1-D float32 tensor on {dev}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if q_lo.shape != q_hi.shape:
        raise ValueError("q_lo and q_hi must match in shape")


def query_order(q_lo: torch.Tensor) -> torch.Tensor:
    """The order K8's threads take the queries in: int32 argsort by lo."""
    return torch.argsort(q_lo).to(torch.int32)


REGIMES = ("thread", "cta")


def regime(b: int, sm_count: int) -> str:
    """K8's regime for ``b`` queries on a card of ``sm_count`` SMs: a CTA
    a query when every query can have an SM of its own in one wave
    (``b <= sm_count``), else a thread a query."""
    return "cta" if b <= sm_count else "thread"


_SM_COUNT: dict[int, int] = {}


def _sm_count(dev: torch.device) -> int:
    n = _SM_COUNT.get(dev.index)
    if n is None:
        n = torch.cuda.get_device_properties(dev).multi_processor_count
        _SM_COUNT[dev.index] = n
    return n


def itm_walk(tree, q_lo: torch.Tensor, q_hi: torch.Tensor, cap: int = 0,
             order: torch.Tensor | None = None, *,
             _regime: str | None = None):
    """Every query's tree walk: ``(ids, counts)``.

    ``counts`` is int32 ``(b,)``, going on past ``cap``; ``ids`` is int32
    ``(b, cap)``, the first ``cap`` hits of each query in DFS order, −1
    padded.  ``cap`` 0 takes the count instance.  ``order`` is
    ``query_order(q_lo)``, computed here when the thread regime needs it
    and it is not given; the caller vouches that it is a permutation of
    ``range(b)``.  ``_regime`` ("thread" or "cta") overrides ``regime``.
    The plain version on CPU tensors uses neither.
    """
    if _regime is not None and _regime not in REGIMES:
        raise ValueError(f"_regime must be one of {REGIMES} or None, got "
                         f"{_regime!r}")
    dev = q_lo.device
    if dev.type == "cpu":
        return ref.itm_walk(tree, q_lo, q_hi, cap)
    if dev.type != "cuda":
        raise ValueError(f"itm_walk: unsupported device {dev}")
    _check(tree, q_lo, q_hi)
    cap = int(cap)
    if cap < 0 or cap > 2 ** 31 - 1:
        raise ValueError(f"cap must be in [0, 2^31), got {cap}")
    b = q_lo.shape[0]
    counts = torch.empty(b, dtype=torch.int32, device=dev)
    ids = torch.full((b, cap), -1, dtype=torch.int32, device=dev)
    if b == 0:
        return ids, counts
    if q_lo.stride() != q_hi.stride() or q_lo.stride(0) < 1:
        # the kernel reads both with one positive stride
        q_lo, q_hi = q_lo.contiguous(), q_hi.contiguous()
    if b > 2 ** 31 - 1:
        raise ValueError(f"at most 2^31 - 1 queries a call, got {b}")
    per_cta = (_regime or regime(b, _sm_count(dev))) == "cta"
    if order is None:
        if not per_cta:
            order = query_order(q_lo)
    elif (order.dtype != torch.int32 or order.shape != (b,)
          or not order.is_contiguous() or order.device != dev):
        raise ValueError(f"order must be a contiguous int32 ({b},) tensor "
                         f"on {dev}, got {order.dtype} {tuple(order.shape)} "
                         f"on {order.device}")
    lib = _build.load("itm_walk")
    rc = _build.launch(
        dev, lib.itm_walk_launch, tree.lo.data_ptr(), tree.hi.data_ptr(),
        tree.minlower.data_ptr(), tree.maxupper.data_ptr(),
        tree.ids.data_ptr(), tree.lo.shape[0] - 1, q_lo.data_ptr(),
        q_hi.data_ptr(), q_lo.stride(0),
        None if order is None else order.data_ptr(), b, cap,
        ids.data_ptr() if cap else None, counts.data_ptr(), int(per_cta))
    _build.check(lib, "itm_walk", rc)
    itm_walk.launches += 1
    itm_walk.cta_launches += per_cta
    return ids, counts


itm_walk.launches = 0
itm_walk.cta_launches = 0
