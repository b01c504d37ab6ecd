"""A tick asks ``MatchPlan.pairs(S, U)``: the pair buffer on the device
and the exact K on the host, the buffer's slots ``[0, K)`` being every
overlapping (subscription, update) pair once, in an order the engine
chooses.

Judged against ``reference.pairs_digest`` on the same state, as a set:
``k_gap`` is ``|K - K_ref|``; ``bad_rows`` counts the slots in
``[0, K)`` that hold a pad or an id out of range, or are missing;
``set_gap`` counts the two digest sums that differ.  All are exact, with
the limit 0.
"""
from __future__ import annotations

from ddmbench import reference

LIMITS = {"k_gap": 0, "bad_rows": 0, "set_gap": 0}


def call(plan, S, U):
    return plan.pairs(S, U)


def k_of(result) -> int:
    return int(result[1])


def summarize(result, store) -> dict:
    res, k = result
    return reference.buffer_digest(res.decode, res.cap, int(k),
                                   store.s_lo.shape[0], store.u_lo.shape[0])


def expected(store) -> dict:
    return reference.pairs_digest(store.s_lo, store.s_hi, store.u_lo,
                                  store.u_hi)


def compare(got: dict, want: dict) -> dict:
    return {"k_gap": abs(got["k"] - want["k"]),
            "bad_rows": got.get("bad_rows", 0),
            "set_gap": int(got["h1"] != want["h1"])
            + int(got["h2"] != want["h2"])}
