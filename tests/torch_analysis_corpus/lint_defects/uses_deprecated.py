"""Seeded lint defect: port code calling, and re-defining, the removed
pre-engine shims.  Scanned as text by the corpus lint cases; never
imported."""
from repro_torch.core import build_plan


def match_count(S, U, algo="sbm"):
    return build_plan(algo, S.n, U.n, S.d).count(S, U)


def count_overlaps(S, U):
    return match_count(S, U, algo="sbm")


def enumerate_overlaps(S, U, cap):
    pairs, k = match_pairs(S, U, cap, algo="sbm")  # noqa: F821
    return pairs, k, distributed_sbm_count(S, U)  # noqa: F821
