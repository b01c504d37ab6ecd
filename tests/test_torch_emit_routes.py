"""Port parity for the streaming and CSR emit routes and the route policy.

Kernels K5 (streaming emit) and K6 (CSR decode) run their plain
versions on the CPU.  They are held against the JAX package's dense
pass 2 (``repro.core.sbm._twopass_emit``), never against its streaming
and CSR Pallas kernels, which do not run on the installed JAX (ROADMAP
Queue 3).  Also pinned: ``pack_emitter_tables`` against the reference's,
the Hopper route ladder under a monkeypatched budget, the d > 1 ``csr``
rejection, the ``CSRPairs`` contract, and a decode above slot 2^30 that
a pad offset of ``1 << 30`` would break.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.core import sbm as jsbm  # noqa: E402
from repro.kernels import emit as jemit  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import sbm as tsbm  # noqa: E402
from repro_torch.core.dd_match import pairs_to_set  # noqa: E402
from repro_torch.core.pairs import DensePairs  # noqa: E402
from repro_torch.kernels import emit, ops  # noqa: E402

INT32_MAX = 2 ** 31 - 1
_j_phase1 = jax.jit(jsbm._twopass_phase1, static_argnums=4)


def _paper(seed, n_total, alpha):
    S, U = jcore.paper_workload(seed, n_total, alpha)
    return [np.asarray(a[:, 0]) for a in (S.lo, S.hi, U.lo, U.hi)]


def _ties():
    rng = np.random.default_rng(3)
    s_lo = rng.integers(0, 60, 400).astype(np.float32)
    u_lo = rng.integers(0, 60, 330).astype(np.float32)
    s_hi = s_lo + rng.integers(0, 8, 400).astype(np.float32)   # some lo==hi
    u_hi = u_lo + rng.integers(1, 8, 330).astype(np.float32)
    return [s_lo, s_hi, u_lo, u_hi]


WORKLOADS = {"alpha8": lambda: _paper(1, 900, 8.0),
             "alpha0.5": lambda: _paper(2, 1201, 0.5), "ties": _ties}


def _regions(arrs):
    return (convert.regions_from_numpy(arrs[0], arrs[1], "cpu"),
            convert.regions_from_numpy(arrs[2], arrs[3], "cpu"))


def _k(arrs):
    return int(np.sum(np.asarray(jsbm.sbm_count_per_sub(
        jcore.make_regions(arrs[0], arrs[1]),
        jcore.make_regions(arrs[2], arrs[3]))), dtype=np.int64))


def _caps(k):
    return sorted({1, max(k // 3, 1), k, k + 77})


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_pack_emitter_tables_matches_reference(name):
    arrs = WORKLOADS[name]()
    n, m = arrs[0].shape[0], arrs[2].shape[0]
    k = _k(arrs)
    for max_pairs in _caps(k):
        j = _j_phase1(*[jnp.asarray(a) for a in arrs], max_pairs)
        perm_s, perm_u, starts, counts, offs = [np.asarray(x) for x in j[:5]]
        # the port saturates every offset (ROADMAP Queue 3)
        offs = np.minimum(offs, np.int32(max_pairs))
        for min_len in (0, emit.stream_window(512), 5000):
            want = np.asarray(jemit.pack_emitter_tables(
                jnp.asarray(offs), jnp.asarray(counts), jnp.asarray(starts),
                n=n, m=m, min_len=min_len))
            got = emit.pack_emitter_tables(
                *[torch.from_numpy(x.copy()) for x in (offs, counts,
                                                       starts)],
                n=n, m=m, min_len=min_len).numpy()
            assert got.shape == (4, want.shape[1])
            assert not want[4:].any()        # TPU sublane padding rows
            want = want[:4].copy()
            pad = want[0] == jemit._PAD_OFF
            assert (want[3][pad] == n + m).all()
            want[0][pad] = emit.PAD_OFF      # the one intended difference
            np.testing.assert_array_equal(got, want)
            real = got[0][~pad]
            assert (np.diff(real[real < max_pairs]) > 0).all()


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_streaming_and_csr_bit_equal_to_reference_pass2(name):
    arrs = WORKLOADS[name]()
    S, U = _regions(arrs)
    k = _k(arrs)
    launches = (emit.twopass_emit_streaming.launches,
                emit.csr_decode_window.launches)
    rng = np.random.default_rng(4)
    for max_pairs in _caps(k):
        want, ca, cb = jsbm._twopass_emit(*[jnp.asarray(a) for a in arrs],
                                          max_pairs=max_pairs)
        want = np.asarray(want)
        wk = int(np.sum(np.asarray(ca), dtype=np.int64)
                 + np.sum(np.asarray(cb), dtype=np.int64))
        for route in ("resident", "streaming", "xla"):
            got, gk = ops.twopass_pairs_cuda(S, U, max_pairs, route=route,
                                             block=128)
            assert ops.last_emit_route() == route and gk == wk == k
            np.testing.assert_array_equal(got.numpy(), want, err_msg=route)
        view, ck = ops.twopass_pairs_csr(S, U, max_pairs)
        assert isinstance(view, ops.CSRPairs) and ck == view.count == k
        assert view.cap == max_pairs
        np.testing.assert_array_equal(np.asarray(view), want)
        for w0 in {0, max_pairs // 2, max_pairs - 1,
                   *rng.integers(0, max_pairs, 4).tolist()}:
            stop = min(max_pairs, w0 + int(rng.integers(1, 300)))
            np.testing.assert_array_equal(view.decode(w0, stop).numpy(),
                                          want[w0:stop], err_msg=str(w0))
        for w0, win in view.windows(chunk=97):
            np.testing.assert_array_equal(win, want[w0:w0 + 97])
    # CPU tensors take the plain versions: no launch
    assert launches == (emit.twopass_emit_streaming.launches,
                        emit.csr_decode_window.launches)


def test_plain_streaming_and_csr_equal_the_uncompacted_lookup():
    arrs = _ties()
    n, m = arrs[0].shape[0], arrs[2].shape[0]
    k = _k(arrs)
    for max_pairs in _caps(k):
        perm_s, perm_u, starts, counts, offs = tsbm._twopass_phase1(
            *[torch.from_numpy(a.copy()) for a in arrs], max_pairs)[:5]
        dense = tsbm._twopass_slots(offs, counts, starts, perm_s, perm_u,
                                    max_pairs=max_pairs)
        tab = emit.pack_emitter_tables(offs, counts, starts, n=n, m=m,
                                       min_len=emit.stream_window(512))
        assert torch.equal(emit.twopass_emit_streaming(
            tab, perm_s, perm_u, max_pairs=max_pairs), dense)
        for w0 in (0, 1, max_pairs // 3, max_pairs - 1):
            nsl = min(max_pairs - w0, 211)
            assert torch.equal(
                emit.csr_decode_window(tab, perm_s, perm_u, w0, nsl),
                dense[w0:w0 + nsl])
            assert torch.equal(
                tsbm._twopass_window(offs, counts, starts, perm_s, perm_u,
                                     w0, w0 + nsl), dense[w0:w0 + nsl])
        assert tuple(emit.twopass_emit_streaming(
            tab, perm_s, perm_u, max_pairs=0).shape) == (0, 2)
        assert tuple(emit.csr_decode_window(tab, perm_s, perm_u, 5,
                                            0).shape) == (0, 2)
    with pytest.raises(ValueError, match="int32 slot ids"):
        emit.csr_decode_window(tab, perm_s, perm_u, INT32_MAX - 3, 10)


def test_route_ladder_thresholds_and_monkeypatched_budget(monkeypatch):
    need = ops.emit_route_bytes(3, 4)
    assert need == {"resident": 4 * (8 + 2 * 7 + 7), "streaming": 28}
    # the real budget (the H100's 50 MB L2): resident to n+m ~ 3.1e6,
    # streaming to 1.25e7, then csr (or xla for dense-only callers)
    assert ops.choose_emit_route(1_500_000, 1_624_999) == "resident"
    assert ops.choose_emit_route(1_500_000, 1_625_000) == "streaming"
    assert ops.choose_emit_route(6_250_000, 6_250_000) == "streaming"
    assert ops.choose_emit_route(6_250_000, 6_250_001) == "csr"
    assert ops.choose_emit_route(6_250_000, 6_250_001,
                                 dense_only=True) == "xla"
    assert ops.choose_emit_route(10, 10, budget=4 * 20) == "streaming"
    assert ops.choose_emit_route(10, 10, budget=4 * 20 - 1) == "csr"
    # the engine and twopass_pairs_cuda read the module budget
    arrs = _paper(5, 600, 4.0)
    S, U = _regions(arrs)
    E = S.n + U.n
    k = _k(arrs)
    want = None
    for budget, route in ((16 * E + 4, "resident"), (16 * E + 3,
                                                     "streaming"),
                          (4 * E, "streaming"), (4 * E - 1, "csr")):
        monkeypatch.setattr(ops, "EMIT_L2_TABLE_BUDGET", budget)
        for d in (1, 2):
            SS = convert.regions_from_numpy(
                np.repeat(arrs[0][:, None], d, 1),
                np.repeat(arrs[1][:, None], d, 1), "cpu")
            UU = convert.regions_from_numpy(
                np.repeat(arrs[2][:, None], d, 1),
                np.repeat(arrs[3][:, None], d, 1), "cpu")
            plan = tcore.build_plan(tcore.MatchSpec(device="cpu"), S.n, U.n,
                                    d, key=("ladder", budget))
            expect = "xla" if (d > 1 and route == "csr") else route
            assert plan.emit_route() == expect
            res, rk = plan.pairs(SS, UU)
            assert ops.last_emit_route() == expect and rk == k
            assert isinstance(res, ops.CSRPairs) == (expect == "csr")
            buf = np.asarray(res)
            want = buf if want is None else want
            np.testing.assert_array_equal(buf, want)
    # a spec budget overrides the module's
    plan = tcore.build_plan(tcore.MatchSpec(emit_budget=1 << 40,
                                            device="cpu"), S.n, U.n, 1)
    assert plan.emit_route() == "resident"
    assert tcore.build_plan(tcore.MatchSpec(backend="torch", device="cpu"),
                            S.n, U.n, 1).emit_route() is None


def test_csr_rejected_for_d_gt_1_at_spec_plan_and_op():
    with pytest.raises(ValueError) as want:
        jcore.MatchSpec(emit_route="csr", d=2)
    with pytest.raises(ValueError) as got:
        tcore.MatchSpec(emit_route="csr", d=2, device="cpu")
    assert str(got.value) == str(want.value)
    spec = tcore.MatchSpec(emit_route="csr", device="cpu")
    with pytest.raises(ValueError, match="d > 1 verification"):
        tcore.build_plan(spec, 5, 5, 3)
    S, U = _regions(_ties())
    with pytest.raises(ValueError, match="dense candidate buffer"):
        ops.twopass_pairs_cuda(S, U, 10, route="csr", dense_only=True)
    # the dense routes stay open for d > 1
    for route in ("resident", "streaming", "xla"):
        tcore.build_plan(tcore.MatchSpec(emit_route=route, device="cpu"),
                         5, 5, 3)


# csr is rejected for d > 1 (tested above)
@pytest.mark.parametrize("route,d", [(r, d) for d in (1, 2) for r in (
    "resident", "streaming", "csr", "xla") if not (r == "csr" and d > 1)])
@pytest.mark.parametrize("capacity", ["exact", "fixed", "grow"])
def test_engine_routes_match_reference_xla(route, capacity, d):
    rng = np.random.default_rng(40 + d)
    s_lo = rng.uniform(0, 100, (150, d)).astype(np.float32)
    u_lo = rng.uniform(0, 100, (170, d)).astype(np.float32)
    s_hi = s_lo + rng.uniform(2, 30, (150, d)).astype(np.float32)
    u_hi = u_lo + rng.uniform(2, 30, (170, d)).astype(np.float32)
    jS, jU = jcore.make_regions(s_lo, s_hi), jcore.make_regions(u_lo, u_hi)
    S = convert.regions_from_numpy(s_lo, s_hi, "cpu")
    U = convert.regions_from_numpy(u_lo, u_hi, "cpu")
    k_true = int(np.all((s_lo[:, None] < u_hi[None])
                        & (u_lo[None] < s_hi[:, None]), -1).sum())
    max_pairs = {"exact": None, "fixed": k_true // 2,
                 "grow": k_true // 3}[capacity]
    jres, jk = jcore.build_plan(
        jcore.MatchSpec(capacity=capacity, max_pairs=max_pairs), jS.n,
        jU.n, d).pairs(jS, jU)
    plan = tcore.build_plan(tcore.MatchSpec(
        capacity=capacity, max_pairs=max_pairs, emit_route=route,
        block=128, device="cpu"), S.n, U.n, d)
    res, k = plan.pairs(S, U)
    assert k == jk == k_true == plan.count(S, U)
    assert isinstance(res, ops.CSRPairs) == (route == "csr")
    np.testing.assert_array_equal(np.asarray(res), np.asarray(jres))
    plan.validate_pairs(res, k)
    assert pairs_to_set(res, U.n, S.n) == pairs_to_set(
        np.asarray(jres), U.n, S.n)


def test_csr_view_contract():
    arrs = _ties()
    S, U = _regions(arrs)
    k = _k(arrs)
    view, _ = ops.twopass_pairs_csr(S, U, k + 5)
    E = S.n + U.n
    assert view.nbytes == 4 * (4 * emit.lane_pad(E) + E)
    assert view.dense_nbytes == (k + 5) * 8 and view.shape == (k + 5, 2)
    assert "CSRPairs(cap=" in repr(view)
    assert torch.equal(view.to_dense()[k:], torch.full((5, 2), -1,
                                                       dtype=torch.int32))
    with pytest.raises(ValueError, match="outside"):
        view.decode(3, k + 6)
    plan = tcore.build_plan(tcore.MatchSpec(emit_route="csr", device="cpu"),
                            S.n, U.n, 1)
    plan.validate_pairs(view, k)
    with pytest.raises(ValueError, match="window at slot"):
        tcore.build_plan(tcore.MatchSpec(emit_route="csr", device="cpu"),
                         S.n, 3, 1).validate_pairs(view, k)
    with pytest.raises(ValueError, match="reported count"):
        plan.validate_pairs(view, k - 1)
    empty = ops.CSRPairs.empty(4, "cpu")
    assert empty.nbytes == 0 and empty.count == 0
    assert bool((empty.decode(1, 3) == -1).all())
    E0 = convert.regions_from_numpy(np.zeros(0, np.float32),
                                    np.zeros(0, np.float32), "cpu")
    v0, k0 = ops.twopass_pairs_csr(E0, U, 6)
    assert k0 == 0 and v0.cap == 6 and bool((v0.to_dense() == -1).all())
    res, k1 = plan.pairs(S, U)
    assert isinstance(res, ops.CSRPairs) and k1 == k
    assert not isinstance(
        tcore.build_plan(tcore.MatchSpec(device="cpu"), S.n, U.n,
                         1).pairs(S, U)[0], ops.CSRPairs)
    assert isinstance(DensePairs(res.to_dense(), k).data, torch.Tensor)


def test_csr_decode_above_2_30_reaches_the_last_emitters():
    """n = m = 40,000 all-overlapping regions: K = 1.6e9 > 2^30.

    Every u.lo lies in every [s.lo, s.hi), so every pair is class A: the
    n subscriptions emit m pairs each and the m updates emit none, and
    the packed table is n real rows followed by m pad rows.  The slots
    of the last emitters lie above 2^30, and their search runs into the
    pads: with the reference's pad offset of 1 << 30 (below those slots)
    the table is unsorted there and the search lands in a pad; with
    INT32_MAX it stays sorted.  Each window is checked against a lookup
    over the uncompacted offsets.
    """
    n = m = 40_000
    rng = np.random.default_rng(12)
    s_lo = rng.uniform(0, 1, n).astype(np.float32)
    u_lo = rng.uniform(1, 2, m).astype(np.float32)
    arrs = [s_lo, s_lo + 3, u_lo, u_lo + 3]
    S, U = _regions(arrs)
    K = n * m
    view, k = ops.twopass_pairs_csr(S, U, K)
    assert k == view.count == K and K > 1 << 30
    assert int((view.tab[0] == emit.PAD_OFF).sum()) == m
    perm_s, perm_u, starts, counts, offs = tsbm._twopass_phase1(
        *[torch.from_numpy(a) for a in arrs], K)[:5]
    last = int(offs[n - 1])            # the last real emitter's first slot
    assert last > 1 << 30
    for w0, stop in ((last - 1000, last + 1000), (K - 3000, K),
                     ((1 << 30) - 7, (1 << 30) + 7)):
        got = view.decode(w0, stop)
        want = tsbm._twopass_window(offs, counts, starts, perm_s, perm_u,
                                    w0, stop)
        assert bool((want >= 0).all())
        assert torch.equal(got, want), (w0, stop)
