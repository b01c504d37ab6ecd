"""A tick asks ``MatchPlan.count(S, U)``: the exact K, a host int.

Judged against ``reference.count_overlaps`` on the same state:
``k_gap`` is ``|K - K_ref|``, and an exact count has the limit 0.
"""
from __future__ import annotations

from ddmbench import reference

LIMITS = {"k_gap": 0}


def call(plan, S, U):
    return plan.count(S, U)


def k_of(result) -> int:
    return int(result)


def summarize(result, store) -> dict:
    return {"k": int(result)}


def expected(store) -> dict:
    return {"k": reference.count_overlaps(store.s_lo, store.s_hi,
                                          store.u_lo, store.u_hi)}


def compare(got: dict, want: dict) -> dict:
    return {"k_gap": abs(got["k"] - want["k"])}
