"""Port parity for brute-force and grid matching and ``mask()``.

The port's BFM kernels K3 (tile counts) and K4 (mask) run their plain
versions on the CPU; those are held against the JAX package's Pallas
kernels in interpret mode and its pure-jnp oracles, at tile-ragged
shapes, d ∈ {1, 2, 3}, empty sets and degenerate ``lo == hi`` regions.
``bfm_pairs`` (truncation included), ``gbm_count``, ``block_mask``,
``pairs_to_set`` and the engine's ``bfm``/``gbm`` plans and ``mask()``
are held against the reference on the same numpy inputs.  K is exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.core import brute as jbrute  # noqa: E402
from repro.core import dd_match as jdd  # noqa: E402
from repro.core import grid as jgrid  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import brute, dd_match, grid  # noqa: E402
from repro_torch.core.pairs import DensePairs  # noqa: E402
from repro_torch.kernels import bfm, ops, ref  # noqa: E402


def _boxes(seed, n, m, d, degenerate=False, ties=False):
    rng = np.random.default_rng(seed)

    def side(k):
        lo = rng.uniform(0, 40, (k, d)).astype(np.float32)
        hi = lo + rng.uniform(1, 12, (k, d)).astype(np.float32)
        if ties:
            lo, hi = np.floor(lo), np.ceil(hi)
        if degenerate:
            hi[::5] = lo[::5]        # lo == hi: outside the precondition
        return lo, hi

    return side(n) + side(m)


def _both(arrs):
    s_lo, s_hi, u_lo, u_hi = arrs
    return ((jcore.make_regions(s_lo, s_hi), jcore.make_regions(u_lo, u_hi)),
            (convert.regions_from_numpy(s_lo, s_hi, "cpu"),
             convert.regions_from_numpy(u_lo, u_hi, "cpu")))


# n, m deliberately not multiples of the 64-wide tiles
CASES = [dict(seed=1, n=150, m=130), dict(seed=2, n=64, m=200, ties=True),
         dict(seed=3, n=97, m=61, degenerate=True)]


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_plain_tile_counts_and_mask_match_pallas_interpret(case, d):
    arrs = _boxes(d=d, **CASES[case])
    (jS, jU), (tS, tU) = _both(arrs)
    before = (bfm.bfm_tile_counts.launches, bfm.bfm_mask.launches)
    # tile counts, padded with ±inf sentinels as both packages' ops do
    s_lo, s_hi = ops._pad_regions(tS.lo, tS.hi, 64)
    u_lo, u_hi = ops._pad_regions(tU.lo, tU.hi, 64)
    got = bfm.bfm_tile_counts(s_lo, s_hi, u_lo, u_hi, ts=64, tu=64)
    want = jops._tile_counts(jS.lo, jS.hi, jU.lo, jU.hi, 64, 64, True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        ref.bfm_tile_counts(s_lo, s_hi, u_lo, u_hi, 64, 64).numpy(),
        np.asarray(jref.bfm_tile_counts(*[jnp.asarray(x.numpy()) for x in
                                          (s_lo, s_hi, u_lo, u_hi)],
                                        ts=64, tu=64)))
    k = jops.bfm_count_pallas(jS, jU, ts=64, tu=64, interpret=True)
    assert ops.bfm_count_cuda(tS, tU, ts=64, tu=64) == k
    # the mask, ragged edge and all
    want_mask = np.asarray(jops.bfm_mask_pallas(jS, jU, ts=64, tu=64,
                                                interpret=True))
    got_mask = ops.bfm_mask_cuda(tS, tU)
    assert got_mask.dtype == torch.bool and got_mask.is_contiguous()
    np.testing.assert_array_equal(got_mask.numpy(), want_mask)
    np.testing.assert_array_equal(
        ref.bfm_mask(tS.lo, tS.hi, tU.lo, tU.hi).numpy(),
        np.asarray(jref.bfm_mask(jS.lo, jS.hi, jU.lo, jU.hi)))
    assert int(want_mask.sum()) == k
    # CPU tensors take the plain versions: no launch
    assert before == (bfm.bfm_tile_counts.launches, bfm.bfm_mask.launches)


def _sat_compare(x, y, K):
    """K3's FMA compare sat(y·K - x·K) for every (x, y), emulated in
    float64: K·bound is exact, and the rounded difference is >= 1 exactly
    when the exact one is (1 is representable, rounding is monotone);
    inf - inf gives NaN, which saturates to 0."""
    with np.errstate(invalid="ignore", over="ignore"):
        d = y.astype(np.float64)[None, :] * K - x.astype(np.float64)[:, None] * K
    return np.clip(np.nan_to_num(d, nan=0.0, posinf=1.0, neginf=0.0), 0, 1)


def _adversarial_bounds(seed, emin, emax):
    """float32 bounds with exponents in [emin, emax], each next to its
    1-ulp neighbours, plus zeros, infinities and NaN."""
    rng = np.random.default_rng(seed)
    e = rng.integers(emin, emax + 1, 120)
    v = (rng.uniform(1, 2, 120) * 2.0 ** e).astype(np.float32)
    v[::3] = -v[::3]
    up, down = np.float32(np.inf), np.float32(-np.inf)
    v = np.concatenate([v, np.nextafter(v, up), np.nextafter(v, down),
                        np.float32([0, 2.0 ** emin, 2.0 ** emax, np.inf,
                                    -np.inf, np.nan])])
    return v[(v == 0) | ~np.isfinite(v) | (np.abs(v) >= 2.0 ** emin)]


# exponent ranges: fig. 9's, the widest spread K3's FMA compare takes
# (103 octaves), and one that starts at its lowest exponent (-104)
@pytest.mark.parametrize("emin,emax", [(-4, 19), (-40, 63), (-104, -1)])
def test_fma_scale_makes_the_fma_compare_exact(emin, emax):
    v = _adversarial_bounds(emin + 200, emin, emax)
    K = bfm.fma_scale(torch.from_numpy(v))
    assert K == 2.0 ** (23 - emin)
    with np.errstate(invalid="ignore"):
        want = v[:, None] < v[None, :]
    np.testing.assert_array_equal(_sat_compare(v, v, K), want)
    # the condition is tight: half that K leaves 1-ulp gaps at 1/2
    assert not np.array_equal(_sat_compare(v, v, K / 2), want)


@pytest.mark.parametrize("bad", ["subnormal", "spread_104", "below_2^-104"])
def test_fma_scale_refuses_where_the_fma_compare_is_not_exact(bad):
    v = {"subnormal": [1e-40, 1.0],
         "spread_104": [2.0 ** -40, 2.0 ** 64],
         "below_2^-104": [2.0 ** -105, 1.0]}[bad]
    assert bfm.fma_scale(torch.tensor(v, dtype=torch.float32)) == 0.0
    only_special = torch.tensor([0.0, float("inf"), float("nan")])
    assert bfm.fma_scale(only_special) == 1.0


@pytest.mark.parametrize("emin,emax", [(-4, 19), (-40, 63), (-104, -1)])
def test_fma_scale_takes_the_range_over_all_four_bounds(emin, emax):
    # the extremes sit in different tensors, one of them holds no finite
    # nonzero bound; K is that of the four together
    v = _adversarial_bounds(emin + 300, emin, emax)
    parts = [torch.from_numpy(v[np.abs(v) < 2.0 ** (emin + 1)]),
             torch.from_numpy(v[np.abs(v) >= 2.0 ** (emin + 1)]),
             torch.tensor([0.0, float("inf"), float("nan")]),
             torch.from_numpy(v[::-1].copy())]
    assert bfm.fma_scale(*parts) == bfm.fma_scale(torch.from_numpy(v)) \
        == 2.0 ** (23 - emin)
    # a subnormal in any one of them refuses the FMA form
    sub = torch.tensor([1e-40, 1.0])
    assert bfm.fma_scale(*parts[:3], sub) == 0.0


@pytest.mark.parametrize("tile", [1, 7, 64, 4096])
def test_bfm_count_per_sub_matches_reference(tile):
    arrs = _boxes(4, 90, 110, 2, ties=True)
    (jS, jU), (tS, tU) = _both(arrs)
    got = brute.bfm_count_per_sub(tS, tU, tile=tile)
    want = jbrute.bfm_count_per_sub(jS, jU, tile=tile)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert brute.bfm_count(tS, tU, tile=tile) == jbrute.bfm_count(
        jS, jU, tile=tile)


@pytest.mark.parametrize("d", [1, 2, 3])
def test_bfm_pairs_bit_equal_to_reference_with_truncation(d):
    arrs = _boxes(5, 80, 70, d, ties=True)
    (jS, jU), (tS, tU) = _both(arrs)
    k = int(np.asarray(jbrute.bfm_mask(jS, jU)).sum())
    assert k > 20
    for max_pairs in (1, k // 3, k, k + 9):
        want, wk = jbrute.bfm_pairs(jS, jU, max_pairs=max_pairs)
        got, gk = brute.bfm_pairs(tS, tU, max_pairs)
        assert gk == int(wk) == k
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        # the cuda backend's path: K4 (plain on the CPU), then compaction
        want_p, wk_p = jops.bfm_pairs_pallas(jS, jU, max_pairs, ts=64,
                                             tu=64, interpret=True)
        got_p, gk_p = ops.bfm_pairs_cuda(tS, tU, max_pairs)
        assert gk_p == wk_p == k
        np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))


def test_bfm_pairs_int32_guard_matches_reference():
    n = 46_341                    # n * n = 2,147,488,281 > INT32_MAX
    lo = np.arange(n, dtype=np.float32)
    jS = jcore.make_regions(lo, lo + 1)
    tS = convert.regions_from_numpy(lo, lo + 1, "cpu")
    with pytest.raises(ValueError) as want:
        jops.bfm_pairs_pallas(jS, jS, 4, interpret=True)
    with pytest.raises(ValueError) as got:
        ops.bfm_pairs_cuda(tS, tS, 4)
    assert str(got.value) == str(want.value)
    assert "exceeds INT32_MAX" in str(got.value)


def test_empty_sets_bfm_ops():
    arrs = _boxes(6, 10, 12, 2)
    _, (tS, tU) = _both(arrs)
    tE = convert.regions_from_numpy(np.zeros((0, 2), np.float32),
                                    np.zeros((0, 2), np.float32), "cpu")
    assert ops.bfm_count_cuda(tE, tU) == ops.bfm_count_cuda(tS, tE) == 0
    assert tuple(ops.bfm_mask_cuda(tE, tU).shape) == (0, 12)
    assert tuple(ops.bfm_mask_cuda(tS, tE).shape) == (10, 0)
    out, k = ops.bfm_pairs_cuda(tS, tE, 3)
    assert k == 0 and bool((out == -1).all()) and tuple(out.shape) == (3, 2)
    assert brute.bfm_count(tE, tU) == 0


def _gbm_inputs(kind):
    if kind == "paper":
        S, U = jcore.paper_workload(8, 3000, 20.0)
        return [np.asarray(a) for a in (S.lo, S.hi, U.lo, U.hi)]
    return _boxes(9, 400, 350, 1, ties=True)


@pytest.mark.parametrize("kind", ["paper", "ties"])
@pytest.mark.parametrize("ncells", [1, 7, 3000])
def test_gbm_count_matches_reference(kind, ncells):
    (jS, jU), (tS, tU) = _both(_gbm_inputs(kind))
    want = jgrid.gbm_count(jS, jU, ncells=ncells)
    assert grid.gbm_count(tS, tU, ncells=ncells) == want
    assert want == int(np.asarray(jbrute.bfm_mask(jS, jU)).sum())


def test_gbm_cell_tables_match_reference():
    (jS, jU), (tS, tU) = _both(_gbm_inputs("ties"))
    lb = float(min(tS.lo.min(), tU.lo.min()))
    width = (float(max(tS.hi.max(), tU.hi.max())) - lb) / 7
    jlb, jw = jnp.float32(lb), jnp.float32(width)
    tlb = torch.tensor(lb, dtype=torch.float32)
    tw = torch.tensor(width, dtype=torch.float32)
    lo, hi = tS.lo[:, 0], tS.hi[:, 0]
    for got, want in zip(grid._cell_spans(lo, hi, tlb, tw, 7),
                         jgrid._cell_spans(jS.lo[:, 0], jS.hi[:, 0], jlb,
                                           jw, 7)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    span, cap = grid._capacities(lo, hi, tlb, tw, 7)
    assert (span, cap) == jgrid._capacities(jS.lo[:, 0], jS.hi[:, 0], lb,
                                            width, 7)
    np.testing.assert_array_equal(
        grid._bucketize(lo, hi, tlb, tw, 7, span, cap).numpy(),
        np.asarray(jgrid._bucketize(jS.lo[:, 0], jS.hi[:, 0], jlb, jw, 7,
                                    span, cap)))


def test_gbm_count_rejects_d_gt_1():
    _, (tS, tU) = _both(_boxes(10, 5, 5, 2))
    with pytest.raises(ValueError, match="1-D"):
        grid.gbm_count(tS, tU)


def test_block_mask_matches_reference():
    rng = np.random.default_rng(11)
    q_lo = rng.uniform(0, 10, 33).astype(np.float32)
    kv_lo = rng.uniform(0, 10, 47).astype(np.float32)
    args = (q_lo, q_lo + 2, kv_lo, kv_lo + 1)
    got = dd_match.block_mask(*[torch.from_numpy(a) for a in args])
    want = jdd.block_mask(*[jnp.asarray(a) for a in args])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pairs_to_set_messages_match_reference():
    bad = np.array([[0, 5], [3, 170], [150, 2], [-1, 4], [-1, -1],
                    [7, -3]] + [[1, 1]] * 8, np.int32)
    good = np.array([[0, 5], [3, 7], [-1, -1]], np.int32)
    assert dd_match.pairs_to_set(good, 170, 150) == jdd.pairs_to_set(
        good, 170, 150) == {5, 3 * 170 + 7}
    assert dd_match.pairs_to_set(torch.from_numpy(good), 170) == {5, 517}
    assert dd_match.pairs_to_set(DensePairs(torch.from_numpy(good), 2),
                                 170, 150) == {5, 517}
    for n in (None, 150):
        with pytest.raises(ValueError) as want:
            jdd.pairs_to_set(bad, 170, n, context="plan-x")
        with pytest.raises(ValueError) as got:
            dd_match.pairs_to_set(torch.from_numpy(bad), 170, n,
                                  context="plan-x")
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match=r"\(window at slot 0\)"):
        dd_match.pairs_to_set(DensePairs(torch.from_numpy(bad), 9), 170)


def _engine_data(d):
    return _boxes(100 + d, 150, 170, d, ties=True)


JAX_BACKEND = {"torch": dict(backend="xla"),
               "cuda": dict(backend="pallas", interpret=True)}


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("capacity", ["exact", "fixed", "grow"])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_bfm_gbm_plans_and_mask_match_reference(backend, capacity, d):
    arrs = _engine_data(d)
    (jS, jU), (tS, tU) = _both(arrs)
    k_true = int(np.asarray(jbrute.bfm_mask(jS, jU)).sum())
    assert k_true > 100
    max_pairs = {"exact": None, "fixed": k_true // 2,
                 "grow": k_true // 3}[capacity]
    jspec = jcore.MatchSpec(algo="bfm", capacity=capacity,
                            max_pairs=max_pairs, **JAX_BACKEND[backend])
    jplan = jcore.build_plan(jspec, jS.n, jU.n, d)
    jres, jk = jplan.pairs(jS, jU)
    want_buf = np.asarray(jres)
    want_mask = np.asarray(jplan.mask(jS, jU))
    for algo in ("bfm", "gbm"):
        spec = tcore.MatchSpec(algo=algo, backend=backend,
                               capacity=capacity, max_pairs=max_pairs,
                               device="cpu")
        plan = tcore.build_plan(spec, tS.n, tU.n, d)
        res, k = plan.pairs(tS, tU)
        assert plan.count(tS, tU) == k == jk == k_true, algo
        assert isinstance(res, DensePairs)
        np.testing.assert_array_equal(convert.pairs_to_numpy(res),
                                      want_buf, err_msg=algo)
        plan.validate_pairs(res, k)
        np.testing.assert_array_equal(plan.mask(tS, tU).numpy(), want_mask)
        assert plan.emit_route() is None


def test_bfm_gbm_empty_sets_without_launch():
    lo = np.arange(6, dtype=np.float32)[:, None].repeat(2, axis=1)
    full = convert.regions_from_numpy(lo, lo + 2, "cpu")
    empty = convert.regions_from_numpy(lo[:0], lo[:0], "cpu")
    launches = (bfm.bfm_tile_counts.launches, bfm.bfm_mask.launches)
    for algo in ("bfm", "gbm"):
        for S, U in ((empty, full), (full, empty), (empty, empty)):
            for capacity in ("exact", "fixed", "grow"):
                plan = tcore.build_plan(
                    tcore.MatchSpec(algo=algo, capacity=capacity,
                                    max_pairs=4, device="cpu"), S.n, U.n, 2)
                assert plan.count(S, U) == 0
                res, k = plan.pairs(S, U)
                assert k == 0 and bool((res.data == -1).all())
                m = plan.mask(S, U)
                assert tuple(m.shape) == (S.n, U.n) and not bool(m.any())
    assert launches == (bfm.bfm_tile_counts.launches, bfm.bfm_mask.launches)
