"""Port parity: ``repro_torch.core.itm`` and the engine's ``itm`` paths
against ``repro.core.itm`` / ``repro.core.engine``.

The same seeded numpy inputs go through both packages.  The five tree
arrays, the per-query counts, the ``(b, cap)`` id buffers (truncated
ones included, which pins the DFS order), the d-dim query buffers and
the engine's ``count``/``pairs``/``query`` results must be bit-equal.
On the CPU the port's ``cuda`` backend runs K8's plain version, so both
port backends are held to the reference's ``xla`` backend.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.core import itm as jitm  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import itm as titm  # noqa: E402
from repro_torch.kernels import itm as k8  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TREE_FIELDS = ("lo", "hi", "minlower", "maxupper", "ids")


def _intervals(rng, n, integer):
    lo = rng.uniform(0, 60, n).astype(np.float32)
    hi = lo + rng.uniform(0.5, 12, n).astype(np.float32)
    if integer:   # tied lo values, and intervals that only touch
        lo, hi = np.floor(lo), np.ceil(hi)
    return lo, hi


def _trees(lo, hi):
    jt = jitm.build_tree(jcore.make_regions(lo, hi))
    tt = titm.build_tree(convert.regions_from_numpy(lo, hi, "cpu"))
    return jt, tt


def _queries(rng, b, d=1):
    q_lo = np.floor(rng.uniform(-5, 65, (b, d))).astype(np.float32)
    q_hi = q_lo + rng.uniform(0.1, 15, (b, d)).astype(np.float32)
    return q_lo, q_hi


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 9, 1000])
def test_tree_arrays_bit_equal(n, integer):
    rng = np.random.default_rng(n + 1000 * integer)
    lo, hi = _intervals(rng, n, integer)
    jt, tt = _trees(lo, hi)
    assert tt.height == jt.height
    for name in TREE_FIELDS:
        want = np.asarray(getattr(jt, name))
        got = getattr(tt, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_itree_round_trips_through_numpy():
    # a JAX-built tree queried by the port, and the port's tree by JAX
    rng = np.random.default_rng(12)
    lo, hi = _intervals(rng, 300, True)
    jt, tt = _trees(lo, hi)
    carried = convert.itree_from_numpy(*(np.asarray(a) for a in jt),
                                       device="cpu")
    for name, a, b in zip(TREE_FIELDS, carried, tt):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    back = jitm.ITree(*(jnp.asarray(a)
                        for a in convert.itree_to_numpy(tt)))
    q_lo, q_hi = _queries(rng, 64)
    ql, qh = q_lo[:, 0], q_hi[:, 0]
    want = jitm.itm_query_pairs(jt, jnp.asarray(ql), jnp.asarray(qh), 9)
    got = jitm.itm_query_pairs(back, jnp.asarray(ql), jnp.asarray(qh), 9)
    mine = titm.itm_query_pairs(carried, _t(ql), _t(qh), 9)
    for w, g, t in zip(want, got, mine):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))


def test_tied_lo_keeps_index_order():
    # every lo equal: the stable sort must keep ids in index order, so
    # the in-order walk of the tree lists ids 0..n-1
    lo = np.full(9, 3.0, np.float32)
    hi = np.arange(4, 13, dtype=np.float32)
    jt, tt = _trees(lo, hi)
    np.testing.assert_array_equal(tt.ids.numpy(), np.asarray(jt.ids))
    inorder = titm._inorder(tt.height, "cpu")
    assert tt.ids[1:][torch.argsort(inorder)][:9].tolist() == list(range(9))


@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("n", [1, 9, 1000])
def test_query_counts_bit_equal(n, integer):
    rng = np.random.default_rng(7 * n + integer)
    lo, hi = _intervals(rng, n, integer)
    jt, tt = _trees(lo, hi)
    q_lo, q_hi = _queries(rng, 257)
    want = np.asarray(jitm.itm_query_counts(jt, jnp.asarray(q_lo[:, 0]),
                                            jnp.asarray(q_hi[:, 0])))
    got = titm.itm_query_counts(tt, _t(q_lo[:, 0]), _t(q_hi[:, 0]))
    np.testing.assert_array_equal(got.numpy(), want)
    # the K8 wrapper takes its plain version on the CPU, launching nothing
    before = k8.itm_walk.launches
    np.testing.assert_array_equal(
        ops.itm_query_counts_cuda(tt, _t(q_lo[:, 0]), _t(q_hi[:, 0])).numpy(),
        want)
    assert k8.itm_walk.launches == before


@pytest.mark.parametrize("cap_case", ["one", "below", "max", "above"])
@pytest.mark.parametrize("integer", [False, True])
def test_query_pairs_bit_equal_with_and_without_truncation(integer, cap_case):
    rng = np.random.default_rng(31 + integer)
    lo, hi = _intervals(rng, 500, integer)
    jt, tt = _trees(lo, hi)
    q_lo, q_hi = _queries(rng, 200)
    ql, qh = q_lo[:, 0], q_hi[:, 0]
    top = int(np.asarray(jitm.itm_query_counts(jt, jnp.asarray(ql),
                                               jnp.asarray(qh))).max())
    assert top > 4
    cap = {"one": 1, "below": top // 2, "max": top, "above": top + 5}[cap_case]
    jids, jcnt = jitm.itm_query_pairs(jt, jnp.asarray(ql), jnp.asarray(qh),
                                      cap)
    for ids, cnt in (titm.itm_query_pairs(tt, _t(ql), _t(qh), cap),
                     ops.itm_query_pairs_cuda(tt, _t(ql), _t(qh), cap)):
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))


def test_query_pairs_dd_bit_equal_at_d2():
    rng = np.random.default_rng(5)
    lo = np.floor(rng.uniform(0, 60, (400, 2))).astype(np.float32)
    hi = lo + np.ceil(rng.uniform(0.5, 20, (400, 2))).astype(np.float32)
    q_lo, q_hi = _queries(rng, 150, d=2)
    jt, tt = _trees(lo[:, 0], hi[:, 0])
    cap = int(np.asarray(jitm.itm_query_counts(
        jt, jnp.asarray(q_lo[:, 0]), jnp.asarray(q_hi[:, 0]))).max())
    jids, jcnt = jitm.itm_query_pairs_dd(jt, jnp.asarray(lo), jnp.asarray(hi),
                                         jnp.asarray(q_lo), jnp.asarray(q_hi),
                                         cap)
    assert int(np.asarray(jcnt).sum()) > 0
    for fn in (titm.itm_query_pairs_dd, ops.itm_query_pairs_dd_cuda):
        ids, cnt = fn(tt, _t(lo), _t(hi), _t(q_lo), _t(q_hi), cap)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))


@pytest.mark.parametrize("swap", ["auto", "S", "U"])
def test_itm_count_function(swap):
    rng = np.random.default_rng(9)
    s = _intervals(rng, 300, True)
    u = _intervals(rng, 200, False)
    want = jitm.itm_count(jcore.make_regions(*s), jcore.make_regions(*u),
                          swap)
    got = titm.itm_count(convert.regions_from_numpy(*s, "cpu"),
                         convert.regions_from_numpy(*u, "cpu"), swap)
    assert got == want > 0


def test_walk_counts_visits_and_handles_empty_batches():
    rng = np.random.default_rng(2)
    lo, hi = _intervals(rng, 100, False)
    _, tt = _trees(lo, hi)
    q = torch.zeros(0)
    buf, cnt, visits = titm._lockstep(tt, q, q, 4)
    assert buf.shape == (0, 4) and cnt.shape == visits.shape == (0,)
    q_lo, q_hi = _queries(rng, 10)
    _, cnt, visits = titm._lockstep(tt, _t(q_lo[:, 0]), _t(q_hi[:, 0]))
    assert bool((visits >= 1).all()) and bool((visits >= cnt).all())
    ids, counts = ref.itm_walk(tt, _t(q_lo[:, 0]), _t(q_hi[:, 0]))
    assert ids.shape == (10, 0) and torch.equal(counts, cnt)


# ---------------------------------------------------------------------------
# the engine's itm paths
# ---------------------------------------------------------------------------

def _engine_data(d, n=90, m=110):
    rng = np.random.default_rng(40 + d)

    def side(k):
        lo = rng.uniform(0, 100, (k, d)).astype(np.float32)
        lo[::2] = np.floor(lo[::2])
        hi = lo + rng.uniform(2, 30, (k, d)).astype(np.float32)
        hi[::2] = np.ceil(hi[::2])
        return lo, hi

    return side(n) + side(m)


def _both_plans(d, capacity, swap, backend, max_pairs=None, n=90, m=110):
    s_lo, s_hi, u_lo, u_hi = _engine_data(d, n, m)
    JS, JU = jcore.make_regions(s_lo, s_hi), jcore.make_regions(u_lo, u_hi)
    TS = convert.regions_from_numpy(s_lo, s_hi, "cpu")
    TU = convert.regions_from_numpy(u_lo, u_hi, "cpu")
    jp = jcore.build_plan(jcore.MatchSpec(
        algo="itm", capacity=capacity, max_pairs=max_pairs, swap=swap),
        n, m, d)
    tp = tcore.build_plan(tcore.MatchSpec(
        algo="itm", backend=backend, capacity=capacity, max_pairs=max_pairs,
        swap=swap, device="cpu"), n, m, d)
    return (jp, JS, JU), (tp, TS, TU)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("swap", ["auto", "S", "U"])
@pytest.mark.parametrize("capacity,max_pairs", [("exact", None),
                                                ("fixed", 37),
                                                ("grow", 16)])
@pytest.mark.parametrize("d", [1, 2])
def test_engine_itm_count_and_pairs_bit_equal(d, capacity, max_pairs, swap,
                                              backend):
    (jp, JS, JU), (tp, TS, TU) = _both_plans(d, capacity, swap, backend,
                                             max_pairs)
    k = jp.count(JS, JU)
    assert tp.count(TS, TU) == k > 0
    jres, jk = jp.pairs(JS, JU)
    tres, tk = tp.pairs(TS, TU)
    assert tk == jk == tres.count == k
    got, want = convert.pairs_to_numpy(tres), np.asarray(jres)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    tp.validate_pairs(tres, tk)
    if capacity == "fixed":
        assert got.shape == (max_pairs, 2) and k > max_pairs


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("capacity,max_pairs", [("exact", None),
                                                ("fixed", 3),
                                                ("grow", 4)])
@pytest.mark.parametrize("d", [1, 2])
def test_engine_query_bit_equal(d, capacity, max_pairs, backend):
    (jp, JS, JU), (tp, TS, TU) = _both_plans(d, capacity, "auto", backend,
                                             max_pairs)
    rng = np.random.default_rng(70 + d)
    q_lo = rng.uniform(0, 100, (60, d)).astype(np.float32)
    q_hi = q_lo + rng.uniform(1, 25, (60, d)).astype(np.float32)
    jt = jitm.build_tree(JS)
    tt = titm.build_tree(TS)
    for step in range(2):   # the second call reuses the memoized cap
        jids, jcnt = jp.query(jt, JS, jnp.asarray(q_lo), jnp.asarray(q_hi))
        tids, tcnt = tp.query(tt, TS, _t(q_lo), _t(q_hi))
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
        np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    assert tids.dtype == tcnt.dtype == torch.int32
    if capacity == "fixed":
        assert tids.shape == (60, max_pairs)


def test_engine_query_early_returns_and_device_check():
    (jp, JS, _), (tp, TS, _) = _both_plans(1, "grow", "auto", "cuda")
    tt = titm.build_tree(TS)
    empty = torch.zeros((0, 1))
    ids, cnt = tp.query(tt, TS, empty, empty)
    jids, jcnt = jp.query(jitm.build_tree(JS), JS, jnp.zeros((0, 1)),
                          jnp.zeros((0, 1)))
    assert ids.shape == np.asarray(jids).shape == (0, 1)
    assert cnt.shape == np.asarray(jcnt).shape == (0,)
    none = convert.regions_from_numpy(np.zeros((0, 1), np.float32),
                                      np.zeros((0, 1), np.float32), "cpu")
    q = torch.ones((3, 1))
    ids, cnt = tp.query(titm.build_tree(none), none, q, q + 1)
    assert ids.tolist() == [[-1]] * 3 and cnt.tolist() == [0] * 3
    with pytest.raises(ValueError, match="lives on meta"):
        tp.query(tt, TS, q.to("meta"), q.to("meta"))


def test_engine_itm_empty_sets_and_spec_checks():
    lo = np.zeros((0, 1), np.float32)
    E = convert.regions_from_numpy(lo, lo, "cpu")
    R = convert.regions_from_numpy(np.zeros(3, np.float32),
                                   np.ones(3, np.float32), "cpu")
    plan = tcore.build_plan(tcore.MatchSpec(algo="itm", device="cpu"), 0, 3,
                            1)
    assert plan.count(E, R) == 0
    res, k = plan.pairs(E, R)
    assert k == 0 and (convert.pairs_to_numpy(res) == -1).all()
    with pytest.raises(ValueError, match="swap must be one of"):
        tcore.MatchSpec(algo="itm", swap="both")
    assert tcore.MatchSpec(algo="itm").device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tcore.build_plan(tcore.MatchSpec(algo="itm"), 3, 3, 1)


def test_itm_pairs_equal_sbm_as_sets():
    s_lo, s_hi, u_lo, u_hi = _engine_data(1, 300, 250)
    S = convert.regions_from_numpy(s_lo, s_hi, "cpu")
    U = convert.regions_from_numpy(u_lo, u_hi, "cpu")
    got = {}
    for algo in ("itm", "sbm"):
        plan = tcore.build_plan(tcore.MatchSpec(algo=algo, device="cpu"),
                                S.n, U.n, 1)
        res, k = plan.pairs(S, U)
        got[algo] = (k, tcore.pairs_to_set(res, U.n))
    assert got["itm"] == got["sbm"]
