"""Seeded steady-pass defects — capacity resolvers that allocate a new
buffer shape forever, and a plan whose second call resolves a new
capacity inside ``steady_state``.
"""
import torch

from repro_torch.analysis import audit_grow_bound
from repro_torch.analysis.steady import probe_steady
from repro_torch.core import MatchPlan, MatchSpec
from repro_torch.core.regions import Regions


def _exact_resolver(report, target):
    # "grow" that resizes to exactly K: every K drift is a new shape
    def factory():
        return lambda k: max(k, 1)

    audit_grow_bound(factory, max_k=1 << 20, target=target, report=report)


def _quantized_linear_resolver(report, target):
    # 1024-slot quanta still grow linearly in K: 1024 distinct
    # capacities by 2^20, against ~22 for the doubling ladder
    def factory():
        return lambda k: -(-max(k, 1) // 1024) * 1024

    audit_grow_bound(factory, max_k=1 << 20, target=target, report=report)


def _regions(lo, width):
    lo = torch.tensor(lo, dtype=torch.float32)[:, None]
    return Regions(lo, lo + width)


def _drifting_exact_plan(report, target):
    # capacity="exact" sizes the buffer to K, so a K that differs between
    # the warm-up call and the guarded one is a new buffer shape
    S = _regions([0.0, 1.0, 2.0, 3.0], 1.5)
    wide, narrow = _regions([0.5, 2.5], 2.0), _regions([0.5, 2.5], 0.25)
    plan = MatchPlan(MatchSpec(capacity="exact", device="cpu"), 4, 2, 1)
    calls = iter((wide, narrow))
    probe_steady(report, target, plan, lambda: plan.pairs(S, next(calls)))


CASES = [
    dict(name="exact_growth_resolver", pass_name="steady",
         code="S_GROW_BOUND", audit=_exact_resolver),
    dict(name="quantized_linear_resolver", pass_name="steady",
         code="S_GROW_BOUND", audit=_quantized_linear_resolver),
    dict(name="exact_plan_with_drifting_k", pass_name="steady",
         code="S_STEADY_STATE", audit=_drifting_exact_plan),
]
