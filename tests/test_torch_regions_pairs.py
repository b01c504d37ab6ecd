"""Port parity: region generators, the predicate, and the pairs contract.

The workload generators of ``repro_torch.core.regions`` must draw the
very same arrays as ``repro.core.regions`` from one seed, and
``DensePairs`` must keep the ``decode``/``windows``/``to_dense``/
``__array__`` contract with its −1 padding.  Everything runs on the
CPU; data crosses between the packages as numpy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
from repro.core.pairs import DensePairs as JDensePairs  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.pairs import DensePairs  # noqa: E402


def _np(R):
    return np.asarray(R.lo), np.asarray(R.hi)


@pytest.mark.parametrize("seed,n_total,alpha,d", [
    (42, 2000, 100.0, 1), (7, 1001, 0.01, 1), (3, 600, 1.0, 2),
    (11, 257, 5.0, 3)])
def test_paper_workload_bit_equal(seed, n_total, alpha, d):
    want = jcore.paper_workload(seed, n_total, alpha, d=d)
    got = tcore.paper_workload(seed, n_total, alpha, d=d, device="cpu")
    for jR, tR in zip(want, got):
        jlo, jhi = _np(jR)
        tlo, thi = convert.regions_to_numpy(tR)
        assert tlo.dtype == np.float32 and tlo.shape == jlo.shape
        np.testing.assert_array_equal(tlo, jlo)
        np.testing.assert_array_equal(thi, jhi)
        assert tR.device.type == "cpu"


def test_koln_like_workload_bit_equal():
    want = jcore.koln_like_workload(0, n_positions=3000)
    got = tcore.koln_like_workload(0, n_positions=3000, device="cpu")
    for jR, tR in zip(want, got):
        np.testing.assert_array_equal(convert.regions_to_numpy(tR)[0],
                                      _np(jR)[0])
        np.testing.assert_array_equal(convert.regions_to_numpy(tR)[1],
                                      _np(jR)[1])


def test_make_regions_shapes_and_predicates():
    rng = np.random.default_rng(0)
    lo = rng.uniform(0, 10, (40, 2)).astype(np.float32)
    hi = lo + rng.uniform(0.1, 3, (40, 2)).astype(np.float32)
    R = convert.regions_from_numpy(lo, hi, "cpu")
    assert (R.n, R.d) == (40, 2) and R.lo.dtype == torch.float32
    R1 = tcore.make_regions(lo[:, 0], hi[:, 0], device="cpu")
    assert (R1.n, R1.d) == (40, 1)
    with pytest.raises(ValueError, match="bad region shapes"):
        tcore.make_regions(lo, hi[:5], device="cpu")
    want_dd = np.asarray(jcore.intersect_dd(lo[:20], hi[:20], lo[20:],
                                            hi[20:]))
    got_dd = tcore.intersect_dd(R.lo[:20], R.hi[:20], R.lo[20:], R.hi[20:])
    np.testing.assert_array_equal(got_dd.numpy(), want_dd)
    want_1d = np.asarray(jcore.intersect_1d(lo[:20, 0], hi[:20, 0],
                                            lo[20:, 0], hi[20:, 0]))
    got_1d = tcore.intersect_1d(R.lo[:20, 0], R.hi[:20, 0], R.lo[20:, 0],
                                R.hi[20:, 0])
    np.testing.assert_array_equal(got_1d.numpy(), want_1d)


def test_cuda_request_raises_without_card():
    lo = np.zeros(3, np.float32)
    hi = np.ones(3, np.float32)
    if torch.cuda.is_available():
        assert tcore.make_regions(lo, hi).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        tcore.make_regions(lo, hi)
    with pytest.raises(RuntimeError, match="cuda"):
        tcore.paper_workload(0, 10, 1.0)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.regions_from_numpy(lo, hi)


def _buffer(cap, count, seed=0):
    rng = np.random.default_rng(seed)
    buf = np.full((cap, 2), -1, np.int32)
    k = min(cap, count)
    buf[:k] = rng.integers(0, 50, (k, 2))
    return buf


@pytest.mark.parametrize("cap,count", [(10, 4), (10, 10), (7, 12), (1, 0),
                                       (300, 150)])
def test_dense_pairs_contract_matches_reference(cap, count):
    buf = _buffer(cap, count)
    got = DensePairs(torch.from_numpy(buf.copy()), count)
    want = JDensePairs(buf.copy(), count)
    assert got.shape == want.shape == (cap, 2)
    assert got.dtype == want.dtype == np.int32
    assert len(got) == cap and got.count == count
    assert got.nbytes == want.nbytes == got.dense_nbytes
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_array_equal(convert.pairs_to_numpy(got), buf)
    np.testing.assert_array_equal(got.to_dense().numpy(), buf)
    for a, b in [(0, cap), (1, cap), (cap // 2, cap), (cap, cap)]:
        np.testing.assert_array_equal(got.decode(a, b).numpy(),
                                      np.asarray(want.decode(a, b)))
    gw = [(w0, w) for w0, w in got.windows(chunk=3)]
    jw = [(w0, w) for w0, w in want.windows(chunk=3)]
    assert [w0 for w0, _ in gw] == [w0 for w0, _ in jw]
    for (_, a), (_, b) in zip(gw, jw):
        np.testing.assert_array_equal(a, b)
    # -1 padding above min(count, cap)
    assert (np.asarray(got)[min(cap, count):] == -1).all()
    np.testing.assert_array_equal(got[: min(cap, count)].numpy(),
                                  buf[: min(cap, count)])
    with pytest.raises(ValueError, match="outside"):
        got.decode(0, cap + 1)
    with pytest.raises(ValueError, match="outside"):
        want.decode(0, cap + 1)
