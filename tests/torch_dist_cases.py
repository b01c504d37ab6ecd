"""Cases of the distributed backend, run through both packages.

The inputs are NumPy arrays from fixed seeds.  ``port_results`` runs them
through ``repro_torch``'s ``backend="distributed"`` on a process group,
``jax_results`` through ``repro``'s on a device mesh; both return a flat
dict of NumPy values under the same keys, so a test compares them key by
key.  ``port_worker`` is the body of one gloo rank of a spawned group
(ranks 0-3: the default group is P = 4, ``new_group([0, 1])`` P = 2,
``new_group([0])`` P = 1), and ``jax_main`` the body of one JAX process
whose host platform shows P devices (``XLA_FLAGS`` set by the caller
before JAX is imported).  Neither imports the other package.
"""
from __future__ import annotations

import datetime

import numpy as np

# (seed, n, m, d, space, widths, integer endpoints)
CASES = {
    "d1": (1, 300, 260, 1, 1000.0, (1.0, 40.0), False),
    "ties": (2, 240, 200, 1, 100.0, (1.0, 12.0), True),
    "d2": (3, 220, 200, 2, 1000.0, (5.0, 150.0), False),
    "d3": (4, 200, 180, 3, 1000.0, (20.0, 300.0), False),
    "dup": None,
}
# lows that tie: the buffer's slot order differs from the single-device
# sbm's, so these are held as sets
TIED = ("ties", "dup")
POLICIES = {"exact": None, "fixed": 37, "grow": 4}
# the (case, policy) runs of pairs(): every policy on d1, one on the rest
# (each is a new plan, which the reference compiles anew)
RUNS = (("d1", "exact"), ("d1", "fixed"), ("d1", "grow"), ("ties", "grow"),
        ("d2", "exact"), ("d3", "grow"), ("dup", "exact"))
# (seed, n, m) of the overflow workload and the overprovisions tried
OVF = (5, 2000, 2000)
OVERPROVISIONS = (0.5, 1.0, 2.5)
CLUSTERED_N = 40_000         # every S endpoint below every U endpoint
ALL_OVERLAP_N = 47_000       # K = n·m = 2,209,000,000 > 2^31
SEP = ":"


def arrays(case: str):
    """``(s_lo, s_hi, u_lo, u_hi)``, float32 ``(k, d)``."""
    if case == "dup":
        # five identical intervals a side (25 pairs) and the half-open
        # neighbours [0, 10) / [20, 30), which match nothing
        s_lo = np.array([[10.0]] * 5 + [[0.0]], np.float32)
        s_hi = np.array([[20.0]] * 5 + [[10.0]], np.float32)
        u_lo = np.array([[10.0]] * 5 + [[20.0]], np.float32)
        u_hi = np.array([[20.0]] * 5 + [[30.0]], np.float32)
        return s_lo, s_hi, u_lo, u_hi
    seed, n, m, d, space, (w0, w1), integer = CASES[case]
    rng = np.random.default_rng(seed)

    def side(k):
        lo = rng.uniform(0, space, (k, d))
        w = rng.uniform(w0, w1, (k, d))
        if integer:
            lo, w = np.floor(lo), np.ceil(w)
        return lo.astype(np.float32), (lo + w).astype(np.float32)

    return side(n) + side(m)


def ovf_arrays():
    seed, n, m = OVF
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0, 1e4, n + m).astype(np.float32)
    hi = lo + rng.uniform(1, 50, n + m).astype(np.float32)
    return lo[:n, None], hi[:n, None], lo[n:, None], hi[n:, None]


def clustered_arrays():
    n = CLUSTERED_N
    s_lo = np.linspace(0.0, 1.0, n, dtype=np.float32)[:, None]
    u_lo = np.linspace(1000.0, 1001.0, n, dtype=np.float32)[:, None]
    return s_lo, s_lo + 0.5, u_lo, u_lo + 0.5


def all_overlap_arrays():
    n = ALL_OVERLAP_N
    return (np.zeros((n, 1), np.float32), np.full((n, 1), 10.0, np.float32),
            np.full((n, 1), 1.0, np.float32), np.full((n, 1), 2.0, np.float32))


def key(*parts) -> str:
    return SEP.join(str(p) for p in parts)


def _run_cases(make, spec, plan_of, asarray, count_dd: bool) -> dict:
    """The runs through one package: ``make(arrays) -> (S, U)``,
    ``spec(**fields)``, ``plan_of(spec, S, U)``.  ``count()`` runs on
    every case, or with ``count_dd`` False on the d = 1 cases only (at d >
    1 it is ``pairs()``' K by construction, in both packages)."""
    out = {}
    for case, pol in RUNS:
        S, U = make(arrays(case))
        plan = plan_of(spec(capacity=pol, max_pairs=POLICIES[pol]), S, U)
        res, k = plan.pairs(S, U)
        out[key(case, pol, "K")] = np.int64(k)
        out[key(case, pol, "buf")] = asarray(res)
        out[key(case, pol, "cap_dev")] = np.int64(res.cap_dev)
        out[key(case, pol, "dev_counts")] = np.asarray(res.dev_counts,
                                                       np.int64)
    for case in CASES:
        S, U = make(arrays(case))
        if S.d == 1 or count_dd:
            plan = plan_of(spec(capacity="exact", max_pairs=None), S, U)
            out[key(case, "count")] = np.int64(plan.count(S, U))
    S, U = make(ovf_arrays())
    for op in OVERPROVISIONS:
        for path in ("count", "pairs"):
            plan = plan_of(spec(capacity="exact", max_pairs=None,
                                overprovision=op), S, U)
            try:
                getattr(plan, path)(S, U)
                raised = 0
            except OverflowError:
                raised = 1
            out[key("ovf", path, op)] = np.int64(raised)
    return out


def port_results(group=None, device="cpu") -> dict:
    """The cases through ``repro_torch`` on ``group`` (every rank of it
    calls this)."""
    import torch
    from repro_torch import convert
    from repro_torch.core import MatchSpec
    from repro_torch.core.engine import MatchPlan

    def make(arrs):
        return (convert.regions_from_numpy(arrs[0], arrs[1], device),
                convert.regions_from_numpy(arrs[2], arrs[3], device))

    def spec(**kw):
        return MatchSpec(algo="sbm", backend="distributed", group=group,
                         device=device, **kw)

    def plan_of(sp, S, U):
        return MatchPlan(sp, S.n, U.n, S.d)

    with torch.no_grad():
        out = _run_cases(make, spec, plan_of, convert.pairs_to_numpy,
                         count_dd=True)
    return out


def port_queries(group=None, device="cpu") -> dict:
    """The d = 1 and d = 2 cases' S boxes queried against a tree on U,
    ``MatchSpec(algo="itm", backend="distributed", capacity="grow",
    max_pairs=8)``: ids and counts."""
    from repro_torch import convert
    from repro_torch.core import MatchSpec, itm
    from repro_torch.core.engine import MatchPlan
    out = {}
    for case in ("d1", "d2"):
        a = arrays(case)
        S = convert.regions_from_numpy(a[0], a[1], device)
        U = convert.regions_from_numpy(a[2], a[3], device)
        plan = MatchPlan(MatchSpec(algo="itm", backend="distributed",
                                   capacity="grow", max_pairs=8,
                                   group=group, device=device),
                         S.n, U.n, S.d)
        ids, cnt = plan.query(itm.build_tree(U), U, S.lo, S.hi)
        out[key("query", case, "ids")] = convert.pairs_to_numpy(ids)
        out[key("query", case, "cnt")] = convert.pairs_to_numpy(cnt)
    return out


def port_regressions(group=None, device="cpu") -> dict:
    """The clustered stream's K (0, no overflow) and the all-overlap
    table's K (n·m, past 2^31)."""
    from repro_torch import convert
    from repro_torch.core import MatchSpec
    from repro_torch.core.engine import MatchPlan
    out = {}
    for name, arrs in (("clustered", clustered_arrays()),
                       ("all_overlap", all_overlap_arrays())):
        S = convert.regions_from_numpy(arrs[0], arrs[1], device)
        U = convert.regions_from_numpy(arrs[2], arrs[3], device)
        plan = MatchPlan(MatchSpec(algo="sbm", backend="distributed",
                                   group=group, device=device), S.n, U.n, 1)
        out[key(name, "K")] = np.int64(plan.count(S, U))
    return out


def port_worker(rank: int, world: int, store: str, out_dir: str) -> None:
    """One rank of a spawned gloo group: every case at P = 4, 2 and 1
    (ranks outside a subgroup skip it), written to ``rank{r}.npz``."""
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        groups = {world: None, 2: dist.new_group([0, 1]),
                  1: dist.new_group([0])}
        out = {}
        for P, group in groups.items():
            if P < world and rank >= P:
                continue
            res = port_results(group)
            res.update(port_queries(group))
            if P == world:
                res.update(port_regressions(group))
            out.update({key(f"P{P}", k): v for k, v in res.items()})
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def jax_results(mesh=None) -> dict:
    """The cases through ``repro``'s distributed backend on ``mesh``
    (``None``: its default mesh over every device the process sees)."""
    from repro.core import MatchSpec, make_regions
    from repro.core.engine import MatchPlan

    def make(arrs):
        return make_regions(arrs[0], arrs[1]), make_regions(arrs[2], arrs[3])

    def spec(**kw):
        return MatchSpec(algo="sbm", backend="distributed", mesh=mesh, **kw)

    def plan_of(sp, S, U):
        return MatchPlan(sp, S.n, U.n, S.d)

    return _run_cases(make, spec, plan_of, np.asarray, count_dd=False)


def jax_main(out_path: str, nshards: int) -> None:
    """Every case on an ``nshards``-device mesh, to one ``.npz``."""
    import jax
    from jax.sharding import Mesh
    mesh = Mesh(np.array(jax.devices()[:nshards]), ("shards",))
    np.savez(out_path, **{key(f"P{nshards}", k): v
                          for k, v in jax_results(mesh).items()})
