"""Port parity: ``repro_torch.core.dynamic.DDMService`` against
``repro.core.dynamic.DDMService``.

The same seeded regions and move batches go through both services: the
connect ledger, every tick's ``(added, removed)`` deltas, the versions,
the validation messages and the snapshot answers must be equal, and the
ledger after churn must equal the brute-force mask.  The port runs on
``device="cpu"`` (both backends; ``cuda`` runs K8's plain version
here).  Also runs ``examples/ddm_simulation_torch.py`` on the CPU.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
from repro.core import dynamic as jdyn  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import brute  # noqa: E402
from repro_torch.core import dynamic as tdyn  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def _services(d, n_total=240, alpha=8.0, seed=3, backend="torch",
              cap_hint=4):
    S, U = jcore.paper_workload(seed=seed, n_total=n_total, alpha=alpha, d=d)
    js = jdyn.DDMService(S, U, cap_hint=cap_hint)
    spec = tcore.MatchSpec(algo="itm", backend=backend, capacity="grow",
                           device="cpu")
    ts = tdyn.DDMService(
        convert.regions_from_numpy(np.asarray(S.lo), np.asarray(S.hi), "cpu"),
        convert.regions_from_numpy(np.asarray(U.lo), np.asarray(U.hi), "cpu"),
        cap_hint=cap_hint, spec=spec)
    return js, ts


def _moves(rng, n, b, d, dup=False):
    idx = rng.integers(0, n, b) if dup else rng.choice(n, b, replace=False)
    lo = rng.uniform(0, 9e5, (b, d)).astype(np.float32)
    hi = lo + rng.uniform(1.0, 2e4, (b, d)).astype(np.float32)
    return idx, lo, hi


def _truth(svc):
    S = convert.regions_from_numpy(svc.s_lo, svc.s_hi, "cpu")
    U = convert.regions_from_numpy(svc.u_lo, svc.u_hi, "cpu")
    mask = brute.bfm_mask(S, U).numpy()
    return {(int(a), int(b)) for a, b in zip(*np.nonzero(mask))}


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("d", [1, 2])
def test_update_regions_deltas_equal_reference(d, backend):
    js, ts = _services(d, backend=backend)
    assert ts.connect() == js.connect()
    assert len(ts.pairs) > 0
    rng = np.random.default_rng(10 + d)
    n = js.s_lo.shape[0]
    for tick in range(6):
        kind = "sub" if tick % 2 == 0 else "upd"
        idx, lo, hi = _moves(rng, n, 17, d, dup=tick >= 4)
        want = js.update_regions(kind, idx, lo, hi)
        got = ts.update_regions(kind, idx, lo, hi)
        assert got == want, f"tick {tick}"
        assert ts.pairs == js.pairs and ts.version == js.version
    assert ts.pairs == _truth(ts)
    np.testing.assert_array_equal(ts.s_lo, js.s_lo)
    np.testing.assert_array_equal(ts.u_hi, js.u_hi)


def test_single_region_updates_follow_the_brute_mask():
    js, ts = _services(1, n_total=200, alpha=10.0, seed=22)
    ts.connect()
    js.connect()
    rng = np.random.default_rng(0)
    for step in range(8):
        kind = "sub" if step % 2 == 0 else "upd"
        idx = int(rng.integers(0, 100))
        lo = float(rng.uniform(0, 9e5))
        hi = lo + float(rng.uniform(1.0, 5e3))
        got = ts.update_region(kind, idx, lo, hi)
        assert got == js.update_region(kind, idx, lo, hi)
        added, removed = got
        assert not (added & removed)
        assert all((s if kind == "sub" else u) == idx
                   for s, u in added | removed)
        assert ts.pairs == _truth(ts), f"step {step}"


def test_zero_churn_and_apply_moves():
    js, ts = _services(2)
    ts.connect()
    js.connect()
    none = np.zeros((0, 2), np.float32)
    zero = np.zeros(0, np.int64)
    assert ts.update_regions("sub", zero, none, none) == (set(), set())
    assert ts.version == 0 and ts.apply_moves("upd", zero, none, none) == 0
    rng = np.random.default_rng(4)
    idx, lo, hi = _moves(rng, 120, 9, 2, dup=True)
    moved = ts.apply_moves("upd", idx, lo, hi)
    assert moved == js.apply_moves("upd", idx, lo, hi)
    assert moved == len(set(idx.tolist())) and ts.version == js.version == 1
    np.testing.assert_array_equal(ts.u_lo, js.u_lo)
    # the ledger was not updated; a fresh connect finds the new truth
    assert ts.connect() == js.connect() == _truth(ts)


def test_last_write_wins():
    _, ts = _services(1)
    ts.connect()
    lo = np.array([[10.0], [500_000.0]], np.float32)
    ts.update_regions("sub", np.array([3, 3]), lo, lo + 100.0)
    assert ts.s_lo[3, 0] == 500_000.0 and ts.s_hi[3, 0] == 500_100.0
    assert ts.pairs == _truth(ts)


@pytest.mark.parametrize("case", ["range", "negative", "nonfinite",
                                  "dtype", "kind", "many"])
def test_bad_batches_raise_the_reference_messages(case):
    js, ts = _services(1)
    lo = np.array([[1.0], [2.0]], np.float32)
    hi = lo + 1
    kind, idx = "sub", np.array([0, 1])
    if case == "range":
        idx = np.array([0, 120])
    elif case == "negative":
        idx = np.array([-1, 1])
    elif case == "nonfinite":
        hi = np.array([[np.inf], [3.0]], np.float32)
    elif case == "dtype":
        idx = np.array([0.0, 1.0])
    elif case == "kind":
        kind = "both"
    elif case == "many":
        idx = np.arange(-8, 0)
        lo = np.ones((8, 1), np.float32)
        hi = lo + 1
    with pytest.raises(ValueError) as want:
        js.update_regions(kind, idx, lo, hi)
    for call in (ts.update_regions, ts.apply_moves):
        with pytest.raises(ValueError) as got:
            call(kind, idx, lo, hi)
        assert str(got.value) == str(want.value)
    assert ts.version == 0


def test_describe_move_index_errors_equal_reference():
    idx = np.array([-3, 0, 7, 50, 2, 9, 11, 12, 13])
    lo = np.zeros((9, 2), np.float32)
    hi = np.ones((9, 2), np.float32)
    hi[[1, 4], 1] = np.nan
    for args in ((idx, lo, hi, 10, "upd"), (idx[:2], lo[:2], hi[:2], 10,
                                             "sub")):
        assert tdyn.describe_move_index_errors(*args) == \
            jdyn.describe_move_index_errors(*args)
    assert tdyn.describe_move_index_errors(idx, lo, hi, 10, "sub",
                                           max_report=2) == \
        jdyn.describe_move_index_errors(idx, lo, hi, 10, "sub", max_report=2)


@pytest.mark.parametrize("d", [1, 2])
def test_query_snapshot_is_stable_under_later_churn(d):
    js, ts = _services(d, seed=8)
    ts.connect()
    js.connect()
    tsnap, jsnap = ts.snapshot(), js.snapshot()
    assert tsnap.version == jsnap.version == 0
    assert tsnap.nbytes == jsnap.nbytes > 0
    rng = np.random.default_rng(d)
    q_lo = rng.uniform(0, 9e5, (16, d)).astype(np.float32)
    q_hi = q_lo + rng.uniform(1e3, 5e4, (16, d)).astype(np.float32)
    first = {}
    for kind in ("sub", "upd"):
        ids, cnt = ts.query_snapshot(tsnap, kind, q_lo, q_hi)
        jids, jcnt = js.query_snapshot(jsnap, kind, q_lo, q_hi)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
        first[kind] = ids.clone()
    for tick in range(3):
        idx, lo, hi = _moves(rng, 120, 40, d)
        ts.update_regions("sub" if tick % 2 == 0 else "upd", idx, lo, hi)
    assert ts.version == 3 and tsnap.version == 0
    for kind in ("sub", "upd"):
        ids, cnt = ts.query_snapshot(tsnap, kind, q_lo, q_hi)
        assert torch.equal(ids, first[kind])
        for i in range(16):
            row = ids[i]
            assert set(row[row >= 0].tolist()) == tsnap.oracle_ids(
                kind, q_lo[i], q_hi[i])
            assert int(cnt[i]) == int((row >= 0).sum())
    # a fresh snapshot sees the churn
    assert ts.snapshot().version == 3
    view = ts.capture()
    assert view.version == 3 and view.device == ts.device
    view.s_lo[:] = 0
    assert ts.s_lo.any()


def test_service_defaults_run_on_the_card():
    S = convert.regions_from_numpy(np.zeros(2, np.float32),
                                   np.ones(2, np.float32), "cpu")
    if torch.cuda.is_available():
        assert tdyn.DDMService(S, S).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            tdyn.DDMService(S, S)
    svc = tdyn.DDMService(S, S, cap_hint=32, spec=tcore.MatchSpec(
        algo="itm", capacity="grow", max_pairs=8, device="cpu"))
    assert svc.spec.max_pairs == 8 and svc.plan.device.type == "cpu"
    plan = tdyn.DDMService(S, S, spec=tcore.MatchSpec(
        algo="itm", capacity="grow", device="cpu"), plan_key="t").plan
    assert plan is tcore.build_plan(plan.spec, 2, 2, 1, key="t")
    assert svc.connect() == {(0, 0), (0, 1), (1, 0), (1, 1)}


def test_example_twin_runs_on_the_cpu(capsys):
    path = REPO / "examples" / "ddm_simulation_torch.py"
    spec = importlib.util.spec_from_file_location("ddm_sim_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cpu", "--ticks", "5"])
    out = capsys.readouterr().out
    assert "ledger == from-scratch SBM match" in out
    assert "tick  5:" in out
