"""The audit matrix — what ``python -m repro_torch.analysis`` runs.

The port's counterpart of the JAX package's ``analysis/matrix.py``.

* ``audit_plan_matrix`` — every registered algo × backend × capacity row
  (the distributed backend for the sbm family only, on an in-process
  gloo group of world size 1, as in the reference): a fresh
  ``MatchPlan`` runs ``count``, ``pairs``, ``mask`` and, for ``itm`` and
  the distributed backend, ``query`` on the probe (distinct prime sizes,
  ``PROBE``) under ``capture.capture_dispatch``; the records are checked
  at the row's target scale (``TARGETS``), the outputs against
  ``OUT_DTYPES``, the host syncs against ``SYNC_BUDGETS``.  On the card,
  the ``cuda`` backend's rows also count the syncs that
  ``torch.cuda.set_sync_debug_mode("warn")`` reports; a count that
  differs from the audit's is ``T_SYNC_COUNT``, a fault of the audit.
* ``audit_kernel_matrix`` — ``K_SIGNATURE`` and ``K_ROUTE_DRIFT``
  everywhere; on the card every kernel K1–K8 launched at the
  reference's production shapes (``kernel_matrix_entries``) under
  ``capture.capture_launches``, each launch audited before it runs, and
  every built function's resources read with ``cuobjdump``.
* ``audit_steady_matrix`` — the three grow resolvers against the O(lg K)
  bound and the live ``steady_state`` probes.
* ``lint.lint_paths`` over ``src/repro_torch`` and ``chip_smoke.py``.

``run_all(device="cpu")`` lists the checks it cannot run there in the
report's ``not_run``; ``run_all(device="cuda")`` without a card raises.
"""
from __future__ import annotations

import contextlib
import datetime
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from ..core import itm
from ..core.engine import (ALGOS, BACKENDS, CAPACITY_POLICIES, MatchPlan,
                           MatchSpec)
from ..core.regions import Regions
from . import kernel_audit, steady
from .capture import capture_dispatch, capture_launches
from .report import Report
from .trace_audit import audit_outputs, audit_records

# distinct primes: every derived dimension (n, m, n+m, n+m+1, caps,
# products ...) resolves uniquely (the reference's probe)
PROBE = {"n": 37, "m": 29, "cap": 53}

# per-algorithm target scales: the brute family materializes (n, m)
# masks, so its target is the largest int32-safe mask; the sort-based
# paths scale to the paper's regime (the reference's targets)
_BRUTE_TARGET = {"n": 30_000, "m": 30_000, "cap": 1 << 20}
_SORT_TARGET = {"n": 1_000_000, "m": 1_000_000, "cap": 1 << 21}
TARGETS = {
    "bfm": _BRUTE_TARGET,
    "gbm": _BRUTE_TARGET,
    "sbm": _SORT_TARGET,
    "sbm_chunked": _SORT_TARGET,
    "sbm_binary": _SORT_TARGET,
    "hsbm": _SORT_TARGET,
    "itm": _SORT_TARGET,
}

# declared outputs of each plan method: ``int`` a host int, ``"pairs"`` a
# PairsResult of int32 slots, else a tensor dtype
OUT_DTYPES = {
    "count": (int,),
    "pairs": ("pairs", int),
    "mask": (torch.bool,),
    "query": (torch.int32, torch.int32),
}

# float64 ops allowed on a plan method's torch path, with the reason
F64_ALLOWED: dict[str, str] = {}


def _budgets(table: dict) -> dict:
    """{"algo/backend/capacity:method": syncs} from rows of (count,
    pairs under exact/fixed/grow, mask, query); None: no such method."""
    out = {}
    for (algos, backend), (count, pairs, mask, query) in table.items():
        for algo in algos.split():
            for cap, p in zip(CAPACITY_POLICIES, pairs):
                row = f"{algo}/{backend}/{cap}"
                for method, n in (("count", count), ("pairs", p),
                                  ("mask", mask), ("query", query)):
                    if n is not None:
                        out[f"{row}:{method}"] = n
    return out


_SBM = "sbm sbm_chunked sbm_binary"
# the host syncs each plan method makes at the probe today, measured
# once (``python -m repro_torch.analysis`` prints each row's count) and
# written down: more is a ``T_HOST_SYNC`` regression.  The distributed
# rows run on gloo and the CPU on either device.  On the card, K3's
# count reads the bounds' exponent range (one ``tolist``) and K8's walk
# reads nothing back.  On the CPU the
# cuda backend runs the kernels' plain versions (itm's lock-step walk
# reads each step's liveness), and a Tensor.cpu/tolist counts as the
# copy it would be on the card.
SYNC_BUDGETS = {
    "cpu": _budgets({
        ("bfm", "torch"): (1, (2, 1, 2), 0, None),
        ("bfm", "cuda"): (1, (2, 1, 2), 0, None),
        ("gbm", "torch"): (11, (12, 1, 2), 0, None),
        ("gbm", "cuda"): (11, (12, 1, 2), 0, None),
        (_SBM, "torch"): (1, (3, 2, 4), 0, None),
        (_SBM, "cuda"): (1, (3, 2, 4), 0, None),
        ("hsbm", "torch"): (7, (14, 7, 14), 0, None),
        ("hsbm", "cuda"): (7, (14, 7, 14), 0, None),
        ("itm", "torch"): (18, (135, 117, 234), 0, 115),
        ("itm", "cuda"): (18, (135, 117, 234), 0, 115),
        (_SBM, "distributed"): (8, (20, 12, 24), None, 115),
    }),
    "cuda": _budgets({
        ("bfm", "torch"): (1, (2, 1, 2), 0, None),
        ("bfm", "cuda"): (2, (3, 1, 2), 0, None),
        ("gbm", "torch"): (11, (12, 1, 2), 0, None),
        ("gbm", "cuda"): (11, (12, 1, 2), 0, None),
        (_SBM, "torch"): (1, (3, 2, 4), 0, None),
        (_SBM, "cuda"): (1, (3, 2, 4), 0, None),
        ("hsbm", "torch"): (7, (14, 7, 14), 0, None),
        ("hsbm", "cuda"): (7, (14, 7, 14), 0, None),
        ("itm", "torch"): (17, (132, 115, 230), 0, 113),
        ("itm", "cuda"): (1, (4, 3, 6), 0, 1),
    }),
}


def probe_regions(n: int, d: int = 1, seed: int = 0,
                  device="cpu") -> Regions:
    """The reference's probe regions (its RandomState draws), on
    ``device``."""
    rng = np.random.RandomState(seed)
    lo = rng.uniform(0.0, 1.0, size=(n, d)).astype(np.float32)
    ext = rng.uniform(0.01, 0.2, size=(n, d)).astype(np.float32)
    return Regions(torch.from_numpy(lo).to(device),
                   torch.from_numpy(lo + ext).to(device))


def iter_plan_rows():
    """Every registered (algo, backend, capacity) combination."""
    for algo in ALGOS:
        for backend in BACKENDS:
            if backend == "distributed" and algo not in (
                    "sbm", "sbm_chunked", "sbm_binary"):
                continue  # the distributed backend is parallel SBM
            for capacity in CAPACITY_POLICIES:
                yield algo, backend, capacity


def _row_spec(algo: str, backend: str, capacity: str, device: str,
              group=None) -> MatchSpec:
    kw = dict(algo=algo, backend=backend, capacity=capacity, device=device)
    if capacity == "fixed":
        kw["max_pairs"] = PROBE["cap"]
    if backend == "distributed":
        kw["group"] = group
    return MatchSpec(**kw)


@contextlib.contextmanager
def gloo_group():
    """A gloo group of world size 1 in this process: the default group,
    made in a temporary directory and destroyed on exit, or a new gloo
    group when a default group of world size 1 already exists."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() != 1:
            raise RuntimeError("the audit's distributed rows need a world "
                               "of one rank")
        yield dist.new_group(ranks=[0], backend="gloo")
        return
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0,
                                timeout=datetime.timedelta(seconds=60))
        try:
            yield None
        finally:
            dist.destroy_process_group()


def _row_methods(plan, algo: str, backend: str, S, U):
    calls = [("count", lambda: plan.count(S, U)),
             ("pairs", lambda: plan.pairs(S, U))]
    if backend != "distributed":
        calls.append(("mask", lambda: plan.mask(S, U)))
    if algo == "itm" or backend == "distributed":
        tree = itm.build_tree(Regions(S.lo[:, :1], S.hi[:, :1]))
        calls.append(("query", lambda: plan.query(tree, S, U.lo, U.hi)))
    return calls


def _sync_debug_count(fn):
    """``fn()`` under ``set_sync_debug_mode("warn")``: (result, the
    places of the synchronizing operations it reported)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, [f"{Path(w.filename).name}:{w.lineno}" for w in seen
                 if "called a synchronizing CUDA operation" in str(w.message)]


def audit_plan_row(report: Report, algo: str, backend: str, capacity: str,
                   *, device: str, group=None, launch_gate=None,
                   launches: list | None = None) -> dict:
    """Probe one row; returns {method: counts}."""
    dev = "cpu" if backend == "distributed" else device
    S = probe_regions(PROBE["n"], seed=0, device=dev)
    U = probe_regions(PROBE["m"], seed=1, device=dev)
    spec = _row_spec(algo, backend, capacity, dev, group)
    plan = MatchPlan(spec, S.n, U.n, 1)
    row = f"{algo}/{backend}/{capacity}"
    budgets = SYNC_BUDGETS.get(torch.device(dev).type, {})
    cross_check = torch.device(dev).type == "cuda" and backend == "cuda"
    out = {}
    for method, call in _row_methods(plan, algo, backend, S, U):
        records: list = []
        target = f"{row}:{method}"
        with contextlib.ExitStack() as stack:
            if launches is not None:
                stack.enter_context(capture_launches(launches, launch_gate))
            stack.enter_context(capture_dispatch(records, dev))
            if cross_check:
                result, sites = _sync_debug_count(call)
            else:
                result, sites = call(), None
        counts = audit_records(
            records, target=target, report=report, probe=PROBE,
            target_scale=TARGETS[algo], allowed=F64_ALLOWED,
            sync_budget=budgets.get(target))
        if target not in budgets:
            report.add("trace", "T_HOST_SYNC", target,
                       f"no sync budget written down for {target} on "
                       f"{torch.device(dev).type} ({counts['syncs']} "
                       "measured)")
        counts["sync_debug"] = None if sites is None else len(sites)
        if sites is not None and len(sites) != counts["syncs"]:
            ops = [r.op for r in records if r.sync]
            report.add("trace", "T_SYNC_COUNT", target,
                       f"the audit counts {counts['syncs']} host sync(s) "
                       f"({', '.join(ops)}), set_sync_debug_mode reports "
                       f"{len(sites)} (at {', '.join(sites)}): the "
                       "audit's sync classes are wrong")
        audit_outputs(result, OUT_DTYPES[method], target=target,
                      report=report)
        out[method] = counts
        report.note_audit(
            "trace", f"{target} on {dev}: {counts['ops']} ops "
            f"({counts['scaled']} at target scale, {counts['probe_scale']} "
            f"at probe scale), {counts['syncs']} sync(s)")
    return out


def _warm_up(device: str) -> None:
    """One cuda-backend row of each algorithm, run once and not recorded:
    what a process does once on the card (the first launch's set-up
    synced once in a run on an H100) is no plan method's sync."""
    S = probe_regions(PROBE["n"], seed=0, device=device)
    U = probe_regions(PROBE["m"], seed=1, device=device)
    for algo in ALGOS:
        plan = MatchPlan(_row_spec(algo, "cuda", "exact", device),
                         S.n, U.n, 1)
        for _, call in _row_methods(plan, algo, "cuda", S, U):
            call()
    torch.cuda.synchronize()


def audit_plan_matrix(report: Report, *, device: str = "cpu", rows=None,
                      launch_gate=None, launches=None) -> dict:
    """Probe and audit every engine row; returns {target: counts}."""
    rows = list(rows or iter_plan_rows())
    if torch.device(device).type == "cuda":
        _warm_up(device)
    out = {}
    local = [r for r in rows if r[1] != "distributed"]
    dist_rows = [r for r in rows if r[1] == "distributed"]
    for algo, backend, capacity in local:
        for method, c in audit_plan_row(
                report, algo, backend, capacity, device=device,
                launch_gate=launch_gate, launches=launches).items():
            out[f"{algo}/{backend}/{capacity}:{method}"] = c
    if dist_rows:
        with gloo_group() as group:
            for algo, backend, capacity in dist_rows:
                for method, c in audit_plan_row(
                        report, algo, backend, capacity, device=device,
                        group=group).items():
                    out[f"{algo}/{backend}/{capacity}:{method}"] = c
    return out


# ---------------------------------------------------------------------------
# the kernel matrix: K1-K8 at the reference's production shapes (card)
# ---------------------------------------------------------------------------

def _paper_tables(n_total: int, cap: int, seed: int, dev):
    from ..core import paper_workload, sbm
    S, U = paper_workload(seed, n_total, 100.0, device=dev)
    t = sbm._twopass_phase1(S.lo[:, 0], S.hi[:, 0], U.lo[:, 0],
                            U.hi[:, 0], cap)
    return t[:5]        # perm_s, perm_u, starts, counts, offs


def _k1(dev):
    from ..kernels import sbm_sweep
    g = torch.Generator(device=dev).manual_seed(1)
    T = 2048 * 2049               # ≈ 2(n + m) at 1e6, the reference's
    flags = [torch.randint(0, 2, (T,), generator=g, device=dev,
                           dtype=torch.int32) for _ in range(2)]
    return lambda: sbm_sweep.sbm_sweep(*flags)


def _k2(dev):
    from ..kernels import emit
    ps, pu, starts, counts, offs = _paper_tables(200_000, 1 << 20, 3, dev)
    return lambda: emit.twopass_emit(offs, counts, starts, ps, pu,
                                     max_pairs=1 << 20)


def _k5(dev):
    from ..kernels import emit
    ps, pu, starts, counts, offs = _paper_tables(2_000_000, 1 << 21, 4, dev)
    tab = emit.pack_emitter_tables(
        offs, counts, starts, n=ps.shape[0], m=pu.shape[0],
        min_len=emit.stream_window(emit.DEF_BLOCK))
    return lambda: emit.twopass_emit_streaming(tab, ps, pu,
                                               max_pairs=1 << 21)


def _k6(dev):
    from ..kernels import emit
    ps, pu, starts, counts, offs = _paper_tables(10_000_000, 1 << 21, 5,
                                                 dev)
    tab = emit.pack_emitter_tables(offs, counts, starts, n=ps.shape[0],
                                   m=pu.shape[0])
    return lambda: emit.csr_decode_window(tab, ps, pu, 0, 1 << 16)


def _bfm_bounds(dev):
    g = torch.Generator(device=dev).manual_seed(6)
    n = 30_720                    # 256-multiples, n·m under INT32_MAX
    lo = [torch.rand((n, 2), generator=g, device=dev) * 1e4
          for _ in range(2)]
    return lo[0], lo[0] + 20.0, lo[1], lo[1] + 20.0


def _k3(dev):
    from ..kernels import bfm
    b = _bfm_bounds(dev)
    return lambda: bfm.bfm_tile_counts(*b, ts=256, tu=256)


def _k4(dev):
    from ..kernels import bfm
    b = _bfm_bounds(dev)
    return lambda: bfm.bfm_mask(*b)


def _k7(dtype):
    def prepare(dev):
        from ..kernels import sparse_attn
        g = torch.Generator(device=dev).manual_seed(7)
        BH, S, dh, blk, win = 8, 2048, 128, 128, 512
        q, k, v = (torch.randn((BH, S, dh), generator=g, device=dev,
                               dtype=dtype) for _ in range(3))
        ends = torch.arange(1, S // blk + 1, device=dev,
                            dtype=torch.int32) * blk
        starts = (ends - win).clamp(min=0)
        return lambda: sparse_attn.sparse_attn_bh(
            q, k, v, starts, ends, bq=blk, bkv=blk, sink_end=256)
    return prepare


def _k8_thread(dev):
    from ..core import paper_workload
    from ..kernels import itm as k8
    S, U = paper_workload(42, 1_000_000, 100.0, device=dev)
    tree = itm.build_tree(S)
    q_lo, q_hi = U.lo[:, 0].contiguous(), U.hi[:, 0].contiguous()

    def run():
        _, counts = k8.itm_walk(tree, q_lo, q_hi)
        cap = 1 << max(int(counts.max()) - 1, 0).bit_length()
        return k8.itm_walk(tree, q_lo, q_hi, cap)
    return run


def _k8_cta(dev):
    from ..core import paper_workload
    from ..kernels import itm as k8
    S, _ = paper_workload(2, 1_000_000, 5.0, device=dev)
    tree = itm.build_tree(S)
    rng = np.random.default_rng(102)
    lo = rng.uniform(0, 1e6 - 5e3, 64).astype(np.float32)
    q_lo = torch.from_numpy(lo).to(dev)
    q_hi = torch.from_numpy(lo + np.float32(5e3)).to(dev)

    def run():
        k8.itm_walk(tree, q_lo, q_hi)
        return k8.itm_walk(tree, q_lo, q_hi, 8192)
    return run


def kernel_matrix_entries():
    """(name, prepare(dev) -> run) for every kernel, at the reference's
    production shapes (``src/repro/analysis/matrix.py:254-291``) and, for
    K8, fig. 9 (b = 500,000, the thread regime) and serving's batch of
    64 boxes on ``paper_workload(2, 1e6, 5)``'s tree (the CTA regime)."""
    return [
        ("K1 sbm_sweep (2048·2049 endpoints)", _k1),
        ("K2 twopass_emit (resident, n = m = 1e5, cap 2^20)", _k2),
        ("K5 twopass_emit_streaming (n = m = 1e6, cap 2^21)", _k5),
        ("K6 csr_decode_window (n = m = 5e6, 2^16 slots)", _k6),
        ("K3 bfm_tile_counts (30,720², d = 2)", _k3),
        ("K4 bfm_mask (30,720², d = 2)", _k4),
        ("K7 sparse_attn float32 (BH 8, S 2048, dh 128, sink 256)",
         _k7(torch.float32)),
        ("K7 sparse_attn bfloat16 (BH 8, S 2048, dh 128, sink 256)",
         _k7(torch.bfloat16)),
        ("K8 itm_walk thread regime (fig. 9, b = 500,000)", _k8_thread),
        ("K8 itm_walk CTA regime (b = 64, cap 8192)", _k8_cta),
    ]


def audit_kernel_matrix(report: Report, *, device: str = "cpu",
                        limits=None, resources=None,
                        geometries: list | None = None) -> None:
    """Signatures and route parity; on the card, every matrix entry
    launched under the launch capture, each launch audited first."""
    kernel_audit.check_signatures(report)
    kernel_audit.audit_emit_route_parity(report)
    if torch.device(device).type != "cuda":
        return
    gate = kernel_audit.launch_gate(report, limits=limits,
                                    resources=resources,
                                    geometries=geometries)
    for name, prepare in kernel_matrix_entries():
        records = audit_kernel_entry(report, name,
                                     prepare(torch.device(device)), gate=gate)
        report.kernel_entries[name] = sorted({r.entry for r in records})
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def audit_kernel_entry(report: Report, name: str, run, *,
                       gate=None) -> list:
    """``run()`` under the launch capture; an entry that launched nothing
    is ``K_NO_CAPTURE``.  Returns the launch records."""
    records: list = []
    with capture_launches(records, gate):
        run()
    if not records:
        report.add("kernel", "K_NO_CAPTURE", name,
                   "running this entry launched no kernel — the audit "
                   "lost coverage of it (wrapper renamed or "
                   "short-circuited?)")
    report.note_audit("kernel", f"{name}: {len(records)} launch(es) "
                      f"({', '.join(sorted({r.entry for r in records}))})")
    return records


def audit_steady_matrix(report: Report, *, device: str = "cpu") -> None:
    """Grow bounds of the three resolvers and the live probes."""
    steady.audit_resolvers(report)
    S = probe_regions(PROBE["n"], seed=0, device=device)
    U = probe_regions(PROBE["m"], seed=1, device=device)
    steady.audit_steady_probes(report, S, U, device=device)


CARD_ONLY = {
    "kernel matrix capture": "K1-K8 launched at production shapes "
    "(K_NO_CAPTURE; K_INT32_ARG, K_SMEM_BUDGET, K_LAUNCH_LIMIT on real "
    "launches) needs the card",
    "launch audit of the plan rows": "the cuda backend's plan rows launch "
    "kernels only on the card",
    "compiled-function resources": "registers, stack, static shared and "
    "spills are read with cuobjdump from libraries built on the card",
    "sync cross-check": "T_SYNC_COUNT holds the audit's sync count against "
    "torch.cuda.set_sync_debug_mode, which needs the card",
}


def run_all(*, root=None, device: str = "cuda") -> Report:
    """The whole audit on ``device`` (``cuda`` needs a card: there is no
    fallback to the CPU)."""
    from .lint import lint_paths

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "run_all(device='cuda') needs a CUDA card and "
            "torch.cuda.is_available() is False; pass device='cpu' "
            "(--device cpu) for the CPU checks")
    t0 = time.perf_counter()
    report = Report(dev.type)
    gate = limits = None
    if dev.type == "cuda":
        from ..kernels import _build
        _build.build_all()
        limits = kernel_audit.device_limits(dev)
        report.limits = limits
        report.resources = kernel_audit.audit_resources(report)
        gate = kernel_audit.launch_gate(report, limits=limits,
                                        resources=report.resources,
                                        geometries=report.launches)
    else:
        for check, reason in CARD_ONLY.items():
            report.note_not_run(check, reason)
    report.plan_counts = audit_plan_matrix(
        report, device=dev.type, launch_gate=gate,
        launches=[] if dev.type == "cuda" else None)
    audit_kernel_matrix(report, device=dev.type, limits=limits,
                        resources=report.resources,
                        geometries=report.launches)
    audit_steady_matrix(report, device=dev.type)
    root = Path(root) if root else Path(__file__).resolve().parents[3]
    lint_paths(root, report=report)
    report.seconds = time.perf_counter() - t0
    return report
