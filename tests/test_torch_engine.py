"""Port parity: ``repro_torch`` ``build_plan`` against ``repro``'s.

For every SBM-family algorithm, capacity policy and d ∈ {1, 2, 3}, the
port's plan on ``device="cpu"`` must give the exact K and a bit-identical
int32 buffer to the JAX package's plan on the mapped backend:
``torch`` ↔ ``xla`` and ``cuda`` ↔ ``pallas`` (interpret mode; on the
CPU the port's ``cuda`` backend runs its kernels' plain versions).
Also pinned: ``validate_pairs`` messages and the empty-set guarantees.
The distributed backend has its own file, ``test_torch_distributed.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
from repro.core.engine import describe_pair_range_errors as j_describe  # noqa: E402,E501

import repro_torch.core as tcore  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.engine import describe_pair_range_errors  # noqa: E402
from repro_torch.kernels import emit, sbm_sweep  # noqa: E402

ALGOS = ("sbm", "sbm_chunked", "sbm_binary")
JAX_BACKEND = {"torch": dict(backend="xla"),
               "cuda": dict(backend="pallas", interpret=True, block=512)}


def _data(d):
    """150 × 170 regions with long extents (so d = 3 still overlaps)
    and integer endpoints in half the dimensions' rows (exact ties)."""
    rng = np.random.default_rng(100 + d)

    def side(k):
        lo = rng.uniform(0, 100, (k, d)).astype(np.float32)
        lo[::2] = np.floor(lo[::2])
        hi = lo + rng.uniform(2, 30, (k, d)).astype(np.float32)
        hi[::2] = np.ceil(hi[::2])
        return lo, hi

    return side(150) + side(170)


_JAX_CACHE = {}


def _jax_pairs(jbackend, capacity, d, max_pairs):
    """Reference ``(K, buffer)``.  ``pairs()`` is one code path for the
    whole SBM family in the reference (``_pairs_sbm_dim0``), so it runs
    once per setting, with ``algo="sbm"``."""
    key = ("pairs", jbackend, capacity, d, max_pairs)
    if key not in _JAX_CACHE:
        s_lo, s_hi, u_lo, u_hi = _data(d)
        S, U = jcore.make_regions(s_lo, s_hi), jcore.make_regions(u_lo, u_hi)
        spec = jcore.MatchSpec(capacity=capacity, max_pairs=max_pairs,
                               **JAX_BACKEND[jbackend])
        res, k = jcore.build_plan(spec, S.n, U.n, d).pairs(S, U)
        _JAX_CACHE[key] = (k, np.asarray(res))
    return _JAX_CACHE[key]


def _jax_count(algo, jbackend):
    """Reference 1-D ``count()``, which differs per algorithm."""
    key = ("count", algo, jbackend)
    if key not in _JAX_CACHE:
        s_lo, s_hi, u_lo, u_hi = _data(1)
        S, U = jcore.make_regions(s_lo, s_hi), jcore.make_regions(u_lo, u_hi)
        spec = jcore.MatchSpec(algo=algo, **JAX_BACKEND[jbackend])
        _JAX_CACHE[key] = jcore.build_plan(spec, S.n, U.n, 1).count(S, U)
    return _JAX_CACHE[key]


def _k_exact(d):
    s_lo, s_hi, u_lo, u_hi = _data(d)
    ok = np.all((s_lo[:, None] < u_hi[None]) & (u_lo[None] < s_hi[:, None]),
                axis=-1)
    return int(ok.sum())


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("capacity", ["exact", "fixed", "grow"])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_plan_matches_reference(backend, capacity, d):
    s_lo, s_hi, u_lo, u_hi = _data(d)
    S = convert.regions_from_numpy(s_lo, s_hi, "cpu")
    U = convert.regions_from_numpy(u_lo, u_hi, "cpu")
    k_true = _k_exact(d)
    assert k_true > 100
    # fixed truncates; grow starts from a floor below K so it must double
    max_pairs = {"exact": None, "fixed": k_true // 2,
                 "grow": k_true // 3}[capacity]
    for algo in ALGOS:
        spec = tcore.MatchSpec(algo=algo, backend=backend,
                               capacity=capacity, max_pairs=max_pairs,
                               device="cpu")
        plan = tcore.build_plan(spec, S.n, U.n, d)
        res, k = plan.pairs(S, U)
        count = plan.count(S, U)
        want_k, want_buf = _jax_pairs(backend, capacity, d, max_pairs)
        assert count == k == want_k == k_true, algo
        if d == 1:
            assert count == _jax_count(algo, backend), algo
        got = convert.pairs_to_numpy(res)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want_buf, err_msg=algo)
        plan.validate_pairs(res, k)


def test_validate_pairs_messages_match_reference():
    s_lo, s_hi, u_lo, u_hi = _data(1)
    S = convert.regions_from_numpy(s_lo, s_hi, "cpu")
    U = convert.regions_from_numpy(u_lo, u_hi, "cpu")
    jS, jU = jcore.make_regions(s_lo, s_hi), jcore.make_regions(u_lo, u_hi)
    tplan = tcore.build_plan(tcore.MatchSpec(device="cpu"), S.n, U.n, 1)
    jplan = jcore.build_plan(jcore.MatchSpec(), jS.n, jU.n, 1)
    bad = np.array([[0, 5], [3, 170], [150, 2], [-1, 4], [-1, -1],
                    [7, -3]] + [[1, 1]] * 8, np.int32)
    assert describe_pair_range_errors(bad, 170, 150) == j_describe(
        bad, 170, 150)
    for arr, count in [(bad, None), (bad, 3)]:
        msgs = []
        for plan, buf in ((tplan, torch.from_numpy(arr.copy())),
                          (jplan, arr)):
            with pytest.raises(ValueError) as ei:
                plan.validate_pairs(buf, count)
            msgs.append(str(ei.value).split("; plan=")[0])
        assert msgs[0] == msgs[1]
    res, k = tplan.pairs(S, U)
    jres, jk = jplan.pairs(jS, jU)
    tplan.validate_pairs(res, k)
    with pytest.raises(ValueError) as ti:
        tplan.validate_pairs(res, k - 1)
    with pytest.raises(ValueError) as ji:
        jplan.validate_pairs(jres, jk - 1)
    assert (str(ti.value).split("; plan=")[0]
            == str(ji.value).split("; plan=")[0])


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("capacity", ["exact", "fixed", "grow"])
def test_empty_sets_give_zero_and_all_pad_without_launch(backend, capacity):
    lo = np.arange(6, dtype=np.float32)[:, None].repeat(2, axis=1)
    full = convert.regions_from_numpy(lo, lo + 2, "cpu")
    empty = convert.regions_from_numpy(lo[:0], lo[:0], "cpu")
    launches = (sbm_sweep.sbm_sweep.launches, emit.twopass_emit.launches)
    for S, U in ((empty, full), (full, empty), (empty, empty)):
        spec = tcore.MatchSpec(backend=backend, capacity=capacity,
                               max_pairs=4, device="cpu")
        plan = tcore.build_plan(spec, S.n, U.n, 2)
        assert plan.count(S, U) == 0
        res, k = plan.pairs(S, U)
        assert k == 0 and res.count == 0
        buf = convert.pairs_to_numpy(res)
        assert buf.shape[1] == 2 and buf.shape[0] >= 1
        assert (buf == -1).all()
    assert launches == (sbm_sweep.sbm_sweep.launches,
                        emit.twopass_emit.launches)


def test_spec_validation_and_unported_methods():
    with pytest.raises(ValueError, match="algo must be one of"):
        tcore.MatchSpec(algo="nope")
    with pytest.raises(ValueError, match="backend must be one of"):
        tcore.MatchSpec(backend="pallas")
    with pytest.raises(ValueError, match="requires max_pairs"):
        tcore.MatchSpec(capacity="fixed")
    spec = tcore.MatchSpec(device="cpu")
    assert spec.backend == "cuda" and tcore.MatchSpec().device == "cuda"
    plan = tcore.build_plan(spec, 3, 3, 1)
    assert tcore.build_plan(spec, 3, 3, 1) is plan
    assert tcore.build_plan(spec, 3, 3, 1, key="t") is not plan
    lo = np.zeros(3, np.float32)
    R = convert.regions_from_numpy(lo, lo + 1, "cpu")
    with pytest.raises(ValueError, match="plan compiled for"):
        plan.count(R, convert.regions_from_numpy(lo[:2], lo[:2] + 1, "cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tcore.build_plan(tcore.MatchSpec(), 3, 3, 1)
