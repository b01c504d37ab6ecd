"""Core DDM matching library of the port (the paper's contribution, in
PyTorch), mirroring ``repro.core`` for what is ported so far:

    spec = MatchSpec(algo="sbm",        # sbm | sbm_chunked | sbm_binary
                     backend="cuda",    # cuda (hand kernels) | torch
                     capacity="exact",  # exact | fixed | grow
                     device="cuda")     # or "cpu"
    plan = build_plan(spec, n_sub=S.n, n_upd=U.n, d=S.d)
    k         = plan.count(S, U)        # exact K, int64-safe
    res, k    = plan.pairs(S, U)        # DensePairs (−1-padded slots)

Public surface:
    MatchSpec / MatchPlan / build_plan (repro_torch.core.engine)
    PairsResult / DensePairs — the pair-enumeration result contract
    Regions, make_regions, paper_workload, koln_like_workload
"""
from .regions import (Regions, make_regions, paper_workload,
                      koln_like_workload, intersect_1d, intersect_dd)
from .engine import (ALGOS, BACKENDS, CAPACITY_POLICIES, MatchPlan,
                     MatchSpec, build_plan)
from .pairs import DensePairs, PairsResult
from . import sbm

__all__ = [
    "Regions", "make_regions", "paper_workload", "koln_like_workload",
    "intersect_1d", "intersect_dd",
    "MatchSpec", "MatchPlan", "build_plan",
    "ALGOS", "BACKENDS", "CAPACITY_POLICIES",
    "PairsResult", "DensePairs", "sbm",
]
