"""Port parity: ``repro_torch.core.sbm`` against ``repro.core.sbm``.

Every function of the 1-D SBM path must be bit-identical to the JAX
package's on the same numpy inputs: the lex-sorted endpoint stream, the
sweep contributions, the P-segment contributions, the per-subscription
counts, the pass-1 tables and the two-pass emit buffers, and the exact
int64 K.  Cases cover the paper workload over three overlap degrees,
duplicate endpoints (integer grids, many exact ties), degenerate
``lo == hi`` regions, empty sets and truncated buffers.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.core import sbm as jsbm  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import sbm as tsbm  # noqa: E402


def _paper(alpha):
    def make():
        S, U = jcore.paper_workload(5, 1500, alpha)
        return (np.asarray(S.lo[:, 0]), np.asarray(S.hi[:, 0]),
                np.asarray(U.lo[:, 0]), np.asarray(U.hi[:, 0]))
    return make


def _dups():
    rng = np.random.default_rng(1)
    s_lo = rng.integers(0, 40, 300).astype(np.float32)
    s_hi = s_lo + rng.integers(1, 6, 300).astype(np.float32)
    u_lo = rng.integers(0, 40, 260).astype(np.float32)
    u_hi = u_lo + rng.integers(1, 6, 260).astype(np.float32)
    return s_lo, s_hi, u_lo, u_hi


def _degenerate():
    s_lo, s_hi, u_lo, u_hi = _dups()
    s_hi[::7] = s_lo[::7]          # lo == hi: outside the precondition
    u_hi[::5] = u_lo[::5]
    return s_lo, s_hi, u_lo, u_hi


def _empty(side):
    def make():
        rng = np.random.default_rng(2)
        lo = rng.uniform(0, 50, 9).astype(np.float32)
        hi = lo + np.float32(4.0)
        e = np.zeros(0, np.float32)
        return (e, e, lo, hi) if side == "s" else (lo, hi, e, e)
    return make


CASES = {"alpha0.01": _paper(0.01), "alpha1": _paper(1.0),
         "alpha100": _paper(100.0), "dups": _dups,
         "degenerate": _degenerate}
EMPTY = {"s_empty": _empty("s"), "u_empty": _empty("u")}


# the reference leaves pass 1 unjitted (its callers jit it); eager it
# dispatches op by op, so the tests jit it once per shape
_j_phase1 = jax.jit(jsbm._twopass_phase1, static_argnums=4)


def _both(case):
    arrs = case()
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a.copy())
                                           for a in arrs]


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(CASES) + sorted(EMPTY))
def test_endpoint_stream_and_sweep_contribs(name):
    j, t = _both({**CASES, **EMPTY}[name])
    for got, want in zip(tsbm._endpoint_stream(*t), jsbm._endpoint_stream(*j)):
        _eq(got, want)
    c_t = tsbm._sweep_contribs(*t)
    _eq(c_t, jsbm._sweep_contribs(*j))
    assert tsbm._total(c_t) == int(np.sum(np.asarray(
        jsbm._sweep_contribs(*j)), dtype=np.int64))


@pytest.mark.parametrize("p", [1, 3, 8])
@pytest.mark.parametrize("name", sorted(CASES) + sorted(EMPTY))
def test_chunked_contribs(name, p):
    j, t = _both({**CASES, **EMPTY}[name])
    _eq(tsbm._chunked_contribs(*t, p), jsbm._chunked_contribs(*j, p))


@pytest.mark.parametrize("name", sorted(CASES) + sorted(EMPTY))
def test_per_sub_counts_and_totals(name):
    arrs = {**CASES, **EMPTY}[name]()
    jS = jcore.make_regions(arrs[0], arrs[1])
    jU = jcore.make_regions(arrs[2], arrs[3])
    tS = convert.regions_from_numpy(arrs[0], arrs[1], "cpu")
    tU = convert.regions_from_numpy(arrs[2], arrs[3], "cpu")
    _eq(tsbm.sbm_count_per_sub(tS, tU), jsbm.sbm_count_per_sub(jS, jU))
    want = jsbm.sbm_count_binary(jS, jU)
    assert tsbm.sbm_count_binary(tS, tU) == want
    assert tsbm.sbm_count_sweep(tS, tU) == jsbm.sbm_count_sweep(jS, jU)
    assert tsbm.sbm_count_chunked(tS, tU, p=3) == want


@pytest.mark.parametrize("name", sorted(CASES))
def test_twopass_phase1_tables(name):
    """Bit-identical tables, with one known difference in ``offs``.

    The reference's saturating ``associative_scan`` never applies its
    ``min(a + b, lim)`` to the first element, so ``offs[1]`` is
    ``counts[0]`` even past ``max_pairs``.  The port saturates every
    offset (an int64 cumsum clamped at the limit), which keeps ``offs``
    monotone; slot lookup is unaffected, since every later offset is
    still ``>= max_pairs`` (see ``test_twopass_emit_buffers``).
    """
    j, t = _both(CASES[name])
    for max_pairs in (7, 10 ** 6):
        got = tsbm._twopass_phase1(*t, max_pairs)
        want = _j_phase1(*j, max_pairs)
        for i, (g, w) in enumerate(zip(got, want)):
            if i == 4:    # offs
                w = np.minimum(np.asarray(w), np.int32(max_pairs))
            _eq(g, w)


def test_twopass_offsets_saturate_first_emitter():
    """The case where the two differ: emitter 0 alone overflows the cap."""
    s_lo = np.array([0.0], np.float32)
    s_hi = np.array([100.0], np.float32)
    u_lo = np.arange(50, dtype=np.float32)
    u_hi = u_lo + np.float32(0.5)
    args = (s_lo, s_hi, u_lo, u_hi)
    want = _j_phase1(*[jnp.asarray(a) for a in args], 7)[4]
    got = tsbm._twopass_phase1(*[torch.from_numpy(a) for a in args], 7)[4]
    assert np.asarray(want).tolist()[:3] == [0, 50, 7]
    assert got.tolist()[:3] == [0, 7, 7]
    jp = jsbm._twopass_emit(*[jnp.asarray(a) for a in args], 7)[0]
    tp = tsbm._twopass_emit(*[torch.from_numpy(a) for a in args], 7)[0]
    _eq(tp, jp)


# buffer sizes shared by every case, so cases of equal shape reuse the
# reference's compiled executables; each case has K below or above them
# (alpha0.01: K ≈ 8, alpha1 ≈ 750, alpha100 ≈ 75,000, dups ≈ 11,000)
MAX_PAIRS = (1, 997, 1 << 16)


@pytest.mark.parametrize("name", sorted(CASES))
def test_twopass_emit_buffers(name):
    j, t = _both(CASES[name])
    for max_pairs in MAX_PAIRS:
        got = tsbm._twopass_emit(*t, max_pairs)
        want = jsbm._twopass_emit(*j, max_pairs)
        for g, w in zip(got, want):
            _eq(g, w)


@pytest.mark.parametrize("name", sorted(CASES) + sorted(EMPTY))
def test_sbm_pairs_exact_k_and_truncation(name):
    arrs = {**CASES, **EMPTY}[name]()
    jS = jcore.make_regions(arrs[0], arrs[1])
    jU = jcore.make_regions(arrs[2], arrs[3])
    tS = convert.regions_from_numpy(arrs[0], arrs[1], "cpu")
    tU = convert.regions_from_numpy(arrs[2], arrs[3], "cpu")
    _, k = jsbm.sbm_pairs(jS, jU, 1)   # lo == hi: binary count differs
    for max_pairs in MAX_PAIRS:
        got, gk = tsbm.sbm_pairs(tS, tU, max_pairs)
        want, wk = jsbm.sbm_pairs(jS, jU, max_pairs)
        assert gk == wk == k
        _eq(got, want)
        assert got.shape == (max_pairs, 2)
