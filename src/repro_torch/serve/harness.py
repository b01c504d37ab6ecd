"""Self-checking multi-tenant churn harness (what ``--smoke`` runs), the
port's copy of the JAX package's ``serve/harness.py``.

One *tick* per tenant = one production serving cycle:

1. ``update_regions`` — a validated move batch lands in the store (the
   published snapshot is now stale by one version);
2. a query burst answered **mid-churn** — before any rebuild runs —
   checked set-identical to the brute oracle of the *snapshot* it was
   answered from (staleness is bounded and visible, answers are still
   exact for their version);
3. the double-buffered rebuild publishes;
4. a second burst answered at staleness 0, checked against the fresh
   oracle.

After ``warmup`` ticks the remaining ticks run inside
``analysis.steady.steady_state`` over every tenant's plan: steady-state
churn must load no kernel library and resolve no new buffer capacity
(move batches are pow2-padded, query batches are sentinel-padded to
``max_batch``, grow capacities are memoized).

Regions, moves and boxes are the reference harness's draws from the same
seeds (``np.random.default_rng``, ``core.paper_workload``), so both
packages serve identical traffic.
"""
from __future__ import annotations

import time

import numpy as np

from ..analysis.steady import steady_state
from ..core.engine import MatchSpec
from ..core.regions import paper_workload
from .admission import AdmissionPolicy
from .batching import BatchPolicy
from .server import DDMServer

SPACE = 1.0e6


def make_query_boxes(rng, count: int, d: int, width: float = 5e3):
    lo = rng.uniform(0, SPACE - width, (count, d)).astype(np.float32)
    return lo, (lo + width).astype(np.float32)


def make_moves(rng, n: int, b: int, d: int):
    idx = rng.choice(n, size=min(b, n), replace=False)
    lo = rng.uniform(0, 0.9 * SPACE, (idx.shape[0], d)).astype(np.float32)
    hi = lo + rng.uniform(1.0, 5e3, (idx.shape[0], d)).astype(np.float32)
    return idx, lo, hi


def run_churn(*, tenants: int = 3, n_total: int = 2048, ticks: int = 6,
              warmup: int = 2, moves_per_tick: int = 64,
              queries_per_tick: int = 48, max_batch: int = 64,
              cap_hint: int = 512, seed: int = 0, d_cycle=(1, 2),
              warm_start: bool = False,
              threaded: bool = False, progress=None,
              device: str = "cuda") -> dict:
    """Drive a ``DDMServer`` on ``device`` through sustained churn.

    Raises ``AssertionError`` on any parity violation and
    ``SteadyStateError`` on a library load or new capacity after the
    warm-up.  Returns summary stats (per-phase latencies in seconds,
    rebuild durations, the metrics dict).
    """
    server = DDMServer(batch=BatchPolicy(max_batch=max_batch),
                       admission=AdmissionPolicy(max_queue=16 * max_batch),
                       device=device, warm_start=warm_start)
    rngs = {}
    for i in range(tenants):
        name = f"tenant{i}"
        d = d_cycle[i % len(d_cycle)]
        S, U = paper_workload(seed=seed + i, n_total=n_total, alpha=5.0,
                              d=d, device=device)
        server.add_tenant(name, S, U,
                          spec=MatchSpec(algo="itm", capacity="grow",
                                         max_pairs=cap_hint, device=device),
                          cap_hint=cap_hint)
        rngs[name] = np.random.default_rng(seed + 100 + i)
    if threaded:
        server.start()

    stats = {"stale_query_s": [], "fresh_query_s": [],
             "rebuild_s": [], "parity_checks": 0, "tick_s": []}

    def burst(name, expect_stale: bool):
        """One query burst; returns futures -> verified results."""
        t = server.tenant(name)
        rng = rngs[name]
        q_lo, q_hi = make_query_boxes(rng, queries_per_tick, t.svc.d)
        targets = ["sub" if j % 2 == 0 else "upd"
                   for j in range(queries_per_tick)]
        futs = [server.submit(name, targets[j], q_lo[j], q_hi[j])
                for j in range(queries_per_tick)]
        if not threaded:
            server.pump(queries=True, rebuilds=False)
        results = [f.result(timeout=60.0) for f in futs]
        for j, res in enumerate(results):
            if expect_stale:
                assert res.staleness >= 1, (name, res)
            # parity: the answer must equal the brute oracle of the
            # snapshot version it was served from — a torn read (a mix
            # of old and new extents) fails this for SOME box
            snap = t.live if res.version == t.live.version else None
            if snap is not None:
                want = snap.oracle_ids(targets[j], q_lo[j], q_hi[j])
                got = res.id_set()
                assert got == want, (
                    f"{name} tick parity: {len(got ^ want)} ids "
                    f"differ at version {res.version}")
                stats["parity_checks"] += 1
        return results

    def tick(name):
        t = server.tenant(name)
        rng = rngs[name]
        t0 = time.perf_counter()
        idx, lo, hi = make_moves(rng, t.svc.s_lo.shape[0],
                                 moves_per_tick, t.svc.d)
        server.update_regions(name, "sub", idx, lo, hi)
        # mid-churn burst: answered from the stale snapshot, exact for
        # its version, staleness surfaced
        if not threaded:
            stale = burst(name, expect_stale=True)
            stats["stale_query_s"].extend(r.latency_s for r in stale)
            r0 = time.perf_counter()
            server.pump(queries=False, rebuilds=True)
            stats["rebuild_s"].append(time.perf_counter() - r0)
        else:
            # threaded mode: the rebuild worker races the burst; both
            # stale and fresh answers are legal, parity still holds
            stale = burst(name, expect_stale=False)
            stats["stale_query_s"].extend(r.latency_s for r in stale)
            deadline = time.perf_counter() + 60.0
            while (t.staleness and time.perf_counter() < deadline):
                time.sleep(1e-3)
            assert t.staleness == 0, f"{name}: rebuild never caught up"
        fresh = burst(name, expect_stale=False)
        for r in fresh:
            assert r.staleness == 0, (name, r)
        stats["fresh_query_s"].extend(r.latency_s for r in fresh)
        stats["tick_s"].append(time.perf_counter() - t0)

    names = [f"tenant{i}" for i in range(tenants)]
    try:
        for w in range(warmup):
            for name in names:
                tick(name)
            if progress:
                progress(f"warmup tick {w + 1}/{warmup} done")

        # summary percentiles reflect steady state only: warm-up ticks
        # carry the first allocations, which get their own stat
        def pctl(vals, q):
            return float(np.percentile(np.asarray(vals), q)) if vals else 0.0

        stats["warmup_p99_query_s"] = pctl(
            stats["stale_query_s"] + stats["fresh_query_s"], 99)
        for key in ("stale_query_s", "fresh_query_s", "rebuild_s", "tick_s"):
            stats[key] = []

        plans = [server.tenant(n).plan for n in names]
        with steady_state(*plans):
            for s in range(ticks - warmup):
                for name in names:
                    tick(name)
                if progress:
                    progress(f"steady tick {s + 1}/{ticks - warmup} done")
    finally:
        if threaded:
            server.stop()

    stats.update({
        "p50_query_s": pctl(stats["stale_query_s"]
                            + stats["fresh_query_s"], 50),
        "p99_query_s": pctl(stats["stale_query_s"]
                            + stats["fresh_query_s"], 99),
        "p99_stale_query_s": pctl(stats["stale_query_s"], 99),
        "rebuild_p50_s": pctl(stats["rebuild_s"], 50),
        "rebuild_p99_s": pctl(stats["rebuild_s"], 99),
        "metrics": server.metrics_dict(),
    })
    return stats
