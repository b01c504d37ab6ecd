"""Port parity: ``repro_torch.serve`` against the JAX package's
``repro.serve``, and the serving layer's own behaviour.

The port's ``DDMServer`` runs on ``device="cpu"`` (the ``cuda`` backend's
wrappers run K8's plain walk for CPU tensors).  The same tenants, moves
and query boxes go through both servers: every ``QueryResult`` must agree
in id set, ``version`` and ``staleness``, and the metrics counters,
admission decisions and JSON schema must be equal.  Then the reference's
behaviour tests (``tests/test_serve.py``), ported: torn reads
mid-rebuild, snapshot immutability, fairness, coalescing, the validation
messages, ``pad_moves_pow2``, the steady-state guard (the counterpart of
``no_retrace``) and the warm start (the counterpart of the compilation
cache), and ``python -m repro_torch.serve --smoke --device cpu``.
"""
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro.serve as jserve  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.analysis.steady import (SteadyStateError,  # noqa: E402
                                         steady_state)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.serve import compile_cache, harness  # noqa: E402
from repro_torch.serve.tenancy import pad_moves_pow2  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
BOX = (np.float32([0.0]), np.float32([1e5]))


def _workload(seed, n_total, d):
    """paper_workload's draws, as numpy (the two packages' generators are
    bit-equal), for both servers."""
    S, U = jcore.paper_workload(seed=seed, n_total=n_total, alpha=5.0, d=d)
    return [np.asarray(x) for x in (S.lo, S.hi, U.lo, U.hi)]


def _jserver(**kw):
    kw.setdefault("batch", jserve.BatchPolicy(max_batch=16, max_delay_s=1e-3))
    return jserve.DDMServer(**kw)


def _tserver(**kw):
    kw.setdefault("batch", tserve.BatchPolicy(max_batch=16, max_delay_s=1e-3))
    return tserve.DDMServer(device="cpu", **kw)


def _jadd(server, name, arrs, cap_hint=256):
    return server.add_tenant(name, jcore.make_regions(*arrs[:2]),
                             jcore.make_regions(*arrs[2:]), cap_hint=cap_hint)


def _tadd(server, name, arrs, cap_hint=256, backend="cuda"):
    spec = tcore.MatchSpec(algo="itm", backend=backend, capacity="grow",
                           max_pairs=cap_hint, device="cpu")
    return server.add_tenant(name, convert.regions_from_numpy(*arrs[:2], "cpu"),
                             convert.regions_from_numpy(*arrs[2:], "cpu"),
                             spec=spec, cap_hint=cap_hint)


def _add(server, name, n=64, seed=0, d=1, cap_hint=256):
    return _tadd(server, name, _workload(seed, 2 * n, d), cap_hint)


# ---------------------------------------------------------------------------
# parity with the reference server
# ---------------------------------------------------------------------------

def _drive(server, add, tenants):
    """A scripted serving run: per tick and tenant a move batch, a burst
    answered mid-churn, the rebuild, a burst at staleness 0.  Returns
    every answer as (tenant, tick, phase, target, ids, version,
    staleness) and the metrics counters."""
    for name, (arrs, _) in tenants.items():
        add(server, name, arrs)
    out = []
    for tick in range(3):
        for name, (arrs, d) in tenants.items():
            rng = np.random.default_rng(1000 * tick + len(name))
            idx, lo, hi = harness.make_moves(rng, arrs[0].shape[0], 24, d)
            server.update_regions(name, "sub" if tick % 2 == 0 else "upd",
                                  idx, lo, hi)
            for phase in ("stale", "fresh"):
                q_lo, q_hi = harness.make_query_boxes(rng, 20, d, 2e4)
                futs = [server.submit(name, ("sub", "upd")[j % 2], q_lo[j],
                                      q_hi[j]) for j in range(20)]
                server.pump(rebuilds=phase == "fresh")
                if phase == "stale":
                    server.pump()
                for j, f in enumerate(futs):
                    r = f.result(timeout=30)
                    out.append((name, tick, phase, ("sub", "upd")[j % 2],
                                sorted(r.id_set()), r.version, r.staleness))
    counters = {name: tm["counters"]
                for name, tm in server.metrics_dict()["tenants"].items()}
    return out, counters


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_answers_versions_and_counters_equal_reference(backend):
    tenants = {"a": (_workload(3, 256, 1), 1), "bb": (_workload(4, 192, 2), 2)}
    want, want_c = _drive(_jserver(), _jadd, tenants)
    got, got_c = _drive(_tserver(),
                        lambda s, n, a: _tadd(s, n, a, backend=backend),
                        tenants)
    assert len(got) == len(want) == 2 * 3 * 2 * 20
    for g, w in zip(got, want):
        assert g == w
    assert {(r[2], r[6]) for r in got} == {("stale", 1), ("fresh", 0)}
    assert sum(len(r[4]) for r in got) > 0
    assert got_c == want_c


def _schema(d):
    if isinstance(d, dict):
        return {k: _schema(v) for k, v in d.items()}
    return type(d).__name__


def test_metrics_json_schema_equals_reference():
    recs = []
    for server, add in ((_jserver(), _jadd), (_tserver(), _tadd)):
        add(server, "a", _workload(0, 128, 1))
        server.query("a", "sub", *BOX)
        recs.append(server.metrics_dict())
        import json
        assert json.loads(server.metrics_json()) == recs[-1]
    assert _schema(recs[1]) == _schema(recs[0])
    tm = recs[1]["tenants"]["a"]
    assert tm["counters"] == recs[0]["tenants"]["a"]["counters"]
    assert tm["counters"]["completed"] == 1
    assert tm["gauges"]["snapshot_regions"] == 128
    assert tm["gauges"]["snapshot_bytes"] > 0


@pytest.mark.parametrize("shed,bound", [("reject", 4), ("drop_oldest", 3)])
def test_admission_decisions_equal_reference(shed, bound):
    seen = []
    for server, add, pkg in ((_jserver, _jadd, jserve),
                             (_tserver, _tadd, tserve)):
        srv = server(admission=pkg.AdmissionPolicy(max_queue=bound,
                                                   shed=shed))
        add(srv, "a", _workload(0, 128, 1))
        log, futs = [], []
        for _ in range(bound + 3):
            try:
                futs.append(srv.submit("a", "sub", *BOX))
                log.append("admitted")
            except pkg.AdmissionError as e:
                log.append(f"rejected: {e}")
        srv.pump()
        for f in futs:
            try:
                log.append(len(f.result(timeout=5).ids))
            except pkg.AdmissionError as e:
                log.append(f"evicted: {e}")
        seen.append((log, srv.metrics_dict()["tenants"]["a"]["counters"]))
    assert seen[1] == seen[0]


@pytest.mark.parametrize("bad", ["range", "negative", "float", "nan", "kind"])
def test_validation_messages_equal_reference(bad):
    idx, lo, hi, kind = [3, 40], [[0.0], [0.0]], [[1.0], [1.0]], "sub"
    if bad == "negative":
        idx = [-1]
        lo, hi = lo[:1], hi[:1]
    elif bad == "float":
        idx = [1.5]
        lo, hi = lo[:1], hi[:1]
    elif bad == "nan":
        idx, lo, hi = [1], [[np.nan]], [[1.0]]
    elif bad == "kind":
        idx, lo, hi, kind = [1], [[0.0]], [[1.0]], "pub"
    msgs = []
    for server, add in ((_jserver(), _jadd), (_tserver(), _tadd)):
        add(server, "a", _workload(0, 64, 1))
        with pytest.raises(ValueError) as e:
            server.update_regions("a", kind, idx, lo, hi)
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]


# ---------------------------------------------------------------------------
# query correctness + staleness
# ---------------------------------------------------------------------------

def test_query_matches_brute_oracle_every_tick():
    server = _tserver()
    t = _add(server, "a", n=128, seed=3, d=2)
    rng = np.random.default_rng(0)
    for tick in range(4):
        idx = rng.choice(128, size=16, replace=False)
        lo = rng.uniform(0, 9e5, (16, 2)).astype(np.float32)
        hi = lo + rng.uniform(1, 5e3, (16, 2)).astype(np.float32)
        server.update_regions("a", "sub", idx, lo, hi)
        server.pump()
        for target in ("sub", "upd"):
            q_lo = rng.uniform(0, 9.9e5, (2,)).astype(np.float32)
            q_hi = q_lo + 1e4
            res = server.query("a", target, q_lo, q_hi)
            assert res.staleness == 0
            assert res.id_set() == t.live.oracle_ids(target, q_lo, q_hi)


def test_stale_reads_are_exact_for_their_version():
    server = _tserver()
    t = _add(server, "a", n=128, seed=1)
    rng = np.random.default_rng(1)
    old_snap = t.live
    idx = rng.choice(128, size=32, replace=False)
    lo = rng.uniform(0, 9e5, (32, 1)).astype(np.float32)
    server.update_regions("a", "sub", idx, lo, lo + 100)
    q_lo, q_hi = np.float32([0.0]), np.float32([9.9e5])
    fut = server.submit("a", "sub", q_lo, q_hi)
    server.pump(rebuilds=False)
    res = fut.result(timeout=10)
    assert (res.staleness, res.version) == (1, old_snap.version)
    assert res.id_set() == old_snap.oracle_ids("sub", q_lo, q_hi)
    server.pump()
    res2 = server.query("a", "sub", q_lo, q_hi)
    assert res2.staleness == 0
    assert res2.id_set() == t.live.oracle_ids("sub", q_lo, q_hi)


# ---------------------------------------------------------------------------
# the swap protocol: never a torn mix, readers never blocked
# ---------------------------------------------------------------------------

def _cluster(n, center, width=10.0):
    lo = np.full((n, 1), center - width / 2, np.float32)
    lo += np.linspace(0, 1, n, dtype=np.float32)[:, None]
    return lo, lo + width


def test_reader_mid_rebuild_sees_full_old_or_full_new_set():
    """Every response equals the complete region set of SOME version —
    cluster A (even versions) or cluster B (odd) — while a writer thread
    moves ALL regions back and forth.  A torn read returns a strict
    subset and fails."""
    n = 48
    A, B = 1e3, 5e5
    server = _tserver(batch=tserve.BatchPolicy(max_batch=8,
                                               max_delay_s=5e-4))
    t = _tadd(server, "t", [*_cluster(n, A), *_cluster(n, B)], cap_hint=128)
    all_ids = set(range(n))
    box_a = (np.float32([A - 100]), np.float32([A + 100]))

    def move_all(center, rng):
        lo = np.full((n, 1), center - 50, np.float32) \
            + rng.uniform(0, 1, (n, 1)).astype(np.float32)
        server.update_regions("t", "sub", np.arange(n), lo, lo + 10)

    server.start()
    try:
        assert server.query("t", "sub", *box_a).id_set() == all_ids
        stop = threading.Event()
        errors = []

        def writer():
            rng = np.random.default_rng(2)
            v = 0
            while not stop.is_set() and v < 40:
                v += 1
                move_all(B if v % 2 else A, rng)
                time.sleep(2e-3)

        wt = threading.Thread(target=writer)
        wt.start()
        t_end = time.time() + 1.5
        checked = 0
        while time.time() < t_end:
            try:
                res = server.query("t", "sub", *box_a, timeout=30)
            except tserve.AdmissionError:
                continue
            got = res.id_set()
            want = all_ids if res.version % 2 == 0 else set()
            if got != want:
                errors.append((res.version, len(got)))
            checked += 1
        stop.set()
        wt.join(timeout=30)
        assert not wt.is_alive()
        assert not errors, errors[:5]
        assert checked > 20, f"only {checked} mid-churn reads exercised"
    finally:
        server.stop()


def test_queries_complete_while_rebuild_in_flight():
    server = _tserver(batch=tserve.BatchPolicy(max_batch=8,
                                               max_delay_s=5e-4))
    t = _add(server, "a", n=128, seed=5)
    gate = threading.Event()
    in_rebuild = threading.Event()

    def hook(phase, name):
        if phase == "capture":
            in_rebuild.set()
            assert gate.wait(timeout=30)

    server.rebuild_hook = hook
    server.start()
    try:
        old_version = t.live.version
        rng = np.random.default_rng(7)
        idx = rng.choice(128, size=16, replace=False)
        lo = rng.uniform(0, 9e5, (16, 1)).astype(np.float32)
        server.update_regions("a", "sub", idx, lo, lo + 100)
        assert in_rebuild.wait(timeout=30), "rebuild never started"
        res = server.query("a", "sub", np.float32([0.0]),
                           np.float32([9.9e5]), timeout=10)
        assert res.staleness >= 1 and res.version == old_version
        gate.set()
        deadline = time.time() + 30
        while t.staleness and time.time() < deadline:
            time.sleep(1e-3)
        assert t.staleness == 0, "rebuild never published after release"
    finally:
        gate.set()
        server.stop()


def test_snapshot_immutable_under_store_churn():
    """A snapshot holds copies: moves into the store change neither its
    host arrays nor its device regions and trees."""
    server = _tserver()
    t = _add(server, "a", n=64, seed=9)
    snap = t.live
    before = (snap.s_lo.copy(), snap.S.lo.clone(), snap.tree_S.lo.clone())
    server.update_regions("a", "sub", np.arange(64),
                          np.zeros((64, 1), np.float32),
                          np.ones((64, 1), np.float32))
    assert t.svc.version == 1 and snap.version == 0
    np.testing.assert_array_equal(snap.s_lo, before[0])
    assert torch.equal(snap.S.lo, before[1])
    assert torch.equal(snap.tree_S.lo, before[2])
    assert not np.array_equal(t.svc.s_lo, before[0])


# ---------------------------------------------------------------------------
# the steady-state guard, plan memoization, the warm start
# ---------------------------------------------------------------------------

def test_steady_state_guard_quiet_in_steady_state():
    server = _tserver()
    t = _add(server, "a", n=128, seed=6, cap_hint=256)
    rng = np.random.default_rng(0)

    def one_round():
        idx = rng.choice(128, size=8, replace=False)
        lo = rng.uniform(0, 9e5, (8, 1)).astype(np.float32)
        server.update_regions("a", "sub", idx, lo, lo + 50)
        for target in ("sub", "upd"):
            server.query("a", target, np.float32([1e3]), np.float32([5e5]))
        server.pump()

    one_round()
    assert list(t.plan.new_capacities) == [("query", 256)]
    with steady_state(t.plan):
        for _ in range(3):
            one_round()


def test_steady_state_guard_fires_on_a_new_capacity():
    server = _tserver()
    t = _add(server, "a", n=128, seed=6, cap_hint=4)
    server.query("a", "sub", np.float32([1e3]), np.float32([1.1e3]))
    with pytest.raises(SteadyStateError, match=r"'query', \d+"):
        with steady_state(t.plan):
            # a box over everything needs more than the warm capacity
            server.query("a", "sub", np.float32([0.0]), np.float32([1e6]))


def test_steady_state_guard_fires_on_a_library_load(monkeypatch):
    monkeypatch.setattr(_build, "load_log", ["itm_walk"])
    with pytest.raises(SteadyStateError, match="sbm_sweep"):
        with steady_state():
            _build.load_log.append("sbm_sweep")


def test_plan_memoized_per_tenant_key():
    spec = tcore.MatchSpec(algo="itm", capacity="grow", max_pairs=64,
                           device="cpu")
    p_a1 = tcore.build_plan(spec, 64, 64, 1, key=("serve", 0, "a"))
    assert tcore.build_plan(spec, 64, 64, 1, key=("serve", 0, "a")) is p_a1
    assert tcore.build_plan(spec, 64, 64, 1, key=("serve", 0, "b")) \
        is not p_a1
    s1, s2 = _tserver(), _tserver()
    assert _add(s1, "a").plan is not _add(s2, "a").plan


def test_warm_start_is_idempotent():
    loaded = list(_build.load_log)
    assert compile_cache.enable("cpu") == ()
    assert compile_cache.enable("cpu") == ()
    assert _tserver(warm_start=True).device == "cpu"
    assert _build.load_log == loaded
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            compile_cache.enable("cuda")


# ---------------------------------------------------------------------------
# admission, fairness, batching, errors
# ---------------------------------------------------------------------------

def test_fairness_light_tenant_not_starved_by_flood():
    server = _tserver(batch=tserve.BatchPolicy(max_batch=8),
                      admission=tserve.AdmissionPolicy(max_queue=512))
    _add(server, "heavy", seed=1)
    _add(server, "light", seed=2)
    heavy = [server.submit("heavy", "sub", *BOX) for _ in range(64)]
    light = [server.submit("light", "sub", *BOX) for _ in range(4)]
    assert server._dispatch_once(force=True) == 12
    assert all(f.done() for f in light)
    assert sum(f.done() for f in heavy) == 8
    server.pump()
    assert all(f.done() for f in heavy)


def test_batch_coalescing_and_occupancy_metric():
    server = _tserver(batch=tserve.BatchPolicy(max_batch=16))
    _add(server, "a")
    futs = [server.submit("a", "sub", *BOX) for _ in range(10)]
    server.pump(rebuilds=False)
    assert all(f.done() for f in futs)
    m = server.metrics_dict()["tenants"]["a"]
    assert m["counters"]["batches"] == 1
    assert m["batch_occupancy"]["max"] == pytest.approx(10 / 16)


def test_pad_moves_pow2_is_store_equivalent():
    idx = np.array([4, 9, 2], np.int64)
    lo = np.arange(3, dtype=np.float32).reshape(3, 1)
    hi = lo + 1
    pidx, plo, phi = pad_moves_pow2(idx, lo, hi)
    assert pidx.shape[0] == 4 and pidx[-1] == 2
    S, U = tcore.paper_workload(seed=0, n_total=64, alpha=5.0, device="cpu")
    a = tcore.DDMService(S, U, spec=tcore.MatchSpec(algo="itm",
                                                    device="cpu"))
    b = tcore.DDMService(S, U, spec=tcore.MatchSpec(algo="itm",
                                                    device="cpu"))
    a.apply_moves("sub", idx, lo, hi)
    b.apply_moves("sub", pidx, plo, phi)
    np.testing.assert_array_equal(a.s_lo, b.s_lo)
    np.testing.assert_array_equal(a.s_hi, b.s_hi)


def test_unknown_tenant_and_target_errors():
    server = _tserver()
    _add(server, "a")
    with pytest.raises(ValueError, match="unknown tenant 'b'"):
        server.query("b", "sub", np.float32([0.0]), np.float32([1.0]))
    with pytest.raises(ValueError, match="target must be"):
        server.query("a", "all", np.float32([0.0]), np.float32([1.0]))
    with pytest.raises(ValueError, match="already registered"):
        _add(server, "a")


def test_default_server_runs_on_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    S, U = tcore.paper_workload(seed=0, n_total=64, alpha=5.0, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.DDMServer().add_tenant("a", S, U)


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", [[], ["--threaded"]])
def test_serve_smoke_entry_point_on_the_cpu(mode, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve", "--smoke", "--device",
         "cpu", "--n", "512", "--json", str(tmp_path / "rec.json"), *mode],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "SERVE_SMOKE_OK"
    import json
    rec = json.loads((tmp_path / "rec.json").read_text())
    assert rec["parity_checks"] > 0
    assert rec["params"]["device"] == "cpu"
    assert set(rec["metrics"]["tenants"]) == {"tenant0", "tenant1",
                                              "tenant2"}
