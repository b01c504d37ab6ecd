"""Core DDM matching library of the port (the paper's contribution, in
PyTorch), mirroring ``repro.core``:

    spec = MatchSpec(algo="sbm",        # sbm | sbm_chunked | sbm_binary
                                        # | hsbm | itm | bfm | gbm
                     backend="cuda",    # cuda (hand kernels) | torch
                                        # | distributed (torch.distributed)
                     capacity="exact",  # exact | fixed | grow
                     emit_route="auto", # resident | streaming | csr | xla
                     device="cuda")     # or "cpu"
    plan = build_plan(spec, n_sub=S.n, n_upd=U.n, d=S.d)
    k         = plan.count(S, U)        # exact K, int64-safe
    res, k    = plan.pairs(S, U)        # PairsResult (−1-padded slots)
    mask      = plan.mask(S, U)         # (n, m) bool
    ids, cnt  = plan.query(tree, opp, q_lo, q_hi)   # batched tree query

    svc = DDMService(S, U)              # dynamic matching (paper §3)
    svc.connect(); added, removed = svc.update_regions("sub", idx, lo, hi)

Public surface:
    MatchSpec / MatchPlan / build_plan (repro_torch.core.engine)
    PairsResult / DensePairs / ShardedPairs — the pair-enumeration
    result contract (ShardedPairs: the distributed backend's per-rank
    buffers)
    Regions, make_regions, paper_workload, koln_like_workload
    block_mask / pairs_to_set (repro_torch.core.dd_match)
    the matchers: sbm (flat and hybrid grid+SBM), itm (the interval
    tree), brute (BFM), grid (GBM and the hybrid's geometry)
    distributed — the multi-rank backend's steps on torch.distributed
    (sample_splitters, bucket_cap, resolve_group, ...)
    DDMService / DDMSnapshot / StoreView (repro_torch.core.dynamic)
"""
from .regions import (Regions, make_regions, paper_workload,
                      koln_like_workload, intersect_1d, intersect_dd)
from .engine import (ALGOS, BACKENDS, CAPACITY_POLICIES, MatchPlan,
                     MatchSpec, build_plan)
from .pairs import DensePairs, PairsResult, ShardedPairs
from .dd_match import block_mask, pairs_to_set
from .dynamic import DDMService, DDMSnapshot, StoreView
from . import brute, distributed, grid, itm, sbm

__all__ = [
    "Regions", "make_regions", "paper_workload", "koln_like_workload",
    "intersect_1d", "intersect_dd",
    "MatchSpec", "MatchPlan", "build_plan",
    "ALGOS", "BACKENDS", "CAPACITY_POLICIES",
    "PairsResult", "DensePairs", "ShardedPairs", "block_mask",
    "pairs_to_set",
    "DDMService", "DDMSnapshot", "StoreView",
    "sbm", "itm", "brute", "grid", "distributed",
]
