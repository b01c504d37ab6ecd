"""Each tick a share of the subscriptions and of the updates jump to new
positions, drawn as the generator draws them (uniform on the segment,
the configuration's length; non-empty at float32).

Which regions move: the pool holds ``pool`` batches, made on the device
from the seed, each ``round(fraction * count)`` distinct indices a side
(a prefix of a random permutation); tick ``t`` moves batch ``t % pool``.
Where they go: tick ``t`` draws its new extents afresh, from a generator
seeded with ``seed + 1 + t``, so no two ticks write the same extents and
the state never comes back to an earlier one; the reference replays the
same draws.  The state carries over from tick to tick.
Parameters: ``fraction``, ``pool``.
"""
from __future__ import annotations

import torch


def make_pool(work, params: dict, seed: int, device) -> dict:
    n_batches = int(params["pool"])
    frac = float(params["fraction"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    pool = {"n_batches": n_batches, "seed": seed, "gen": gen,
            "d": work.d, "space": float(work.meta["space"]),
            "length": float(work.meta["length"]),
            "inf": torch.tensor(float("inf"), device=device)}
    for side, count in (("s", work.n), ("u", work.m)):
        k = max(1, round(frac * count))
        # each permutation's prefix copied at once, so that no more than
        # one whole permutation is alive at a time
        pool[side] = torch.stack([
            torch.randperm(count, generator=gen, device=device)[:k].clone()
            for _ in range(n_batches)])
    return pool


def apply(store, pool: dict, t: int) -> None:
    """Write tick ``t``'s moves into the store's tensors, in place."""
    b = t % pool["n_batches"]
    idx_s, idx_u = pool["s"][b], pool["u"][b]
    gen = pool["gen"]
    gen.manual_seed((pool["seed"] + 1 + t) % 2**63)
    x = torch.rand((idx_s.shape[0] + idx_u.shape[0], pool["d"]),
                   dtype=torch.float64, generator=gen, device=idx_s.device)
    length = pool["length"]
    lo = (x * (pool["space"] - length)).float()
    hi = torch.maximum((lo.double() + length).float(),
                       torch.nextafter(lo, pool["inf"]))
    k = idx_s.shape[0]
    for idx, rows, lo_t, hi_t in ((idx_s, slice(0, k), store.s_lo,
                                   store.s_hi),
                                  (idx_u, slice(k, None), store.u_lo,
                                   store.u_hi)):
        lo_t.index_copy_(0, idx, lo[rows])
        hi_t.index_copy_(0, idx, hi[rows])
