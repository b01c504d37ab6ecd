"""Port parity: the hybrid grid+SBM (``algo="hsbm"``) against the JAX
package's ``repro.core.grid`` / ``repro.core.sbm`` hybrid.

The same seeded numpy inputs go through both packages:

* the geometry (``hsbm_geometry``) field-equal, the ncells override and
  the blow-up guard included;
* pass 1's ``sid``/``uid``/``starts``/``counts`` per cell, and exactly
  where no two regions of a side share a lo (the reference's per-cell
  key sort is unstable, so the order of tied rows is not defined);
* ``count()``/``pairs()`` of ``MatchSpec(algo="hsbm")`` on the ``torch``
  backend and on ``cuda`` (whose wrappers run the kernels' plain versions
  for CPU tensors) through every emit route: K exact, pairs set-identical
  to the reference's ``_hsbm_emit`` and to the port's sbm;
* on zero-width regions (lo == hi), where the hybrid's class A counts
  pairs that do not overlap, the port's hsbm pair for pair the
  reference's;
* ``remap_slot_pairs`` and ``HsbmCSRPairs`` windows against the
  reference's remap and ``_hsbm_emit`` slices;
* pass 1's offsets at ``max_pairs = INT32_MAX`` on K = 2.5e9.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import grid as jgrid  # noqa: E402
from repro.core import sbm as jsbm  # noqa: E402
from repro.kernels import emit as jemit  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import grid as tgrid  # noqa: E402
from repro_torch.core import sbm as tsbm  # noqa: E402
from repro_torch.kernels import emit, ops  # noqa: E402
from torch_hsbm_cases import (blowup, edges, hybrid_relation,  # noqa: E402
                              overlap_relation, zero_width)

INT32_MAX = 2 ** 31 - 1
FIELDS = ("ncells", "cap_s", "suf_s", "cap_u", "suf_u", "lb", "width")


def _paper(seed, n_total, alpha, d=1):
    """paper_workload's draws (the port's generator is bit-equal to the
    reference's) as numpy (lo, hi) pairs of S and U."""
    S, U = tcore.paper_workload(seed=seed, n_total=n_total, alpha=alpha, d=d,
                                device="cpu")
    return S.lo.numpy(), S.hi.numpy(), U.lo.numpy(), U.hi.numpy()


def _one_cell():
    n = 96
    lo = np.full((n, 1), 5.0, np.float32)
    return lo, lo + 1, lo + 0.5, lo + 1.5


def _disjoint():
    n = 256
    base = (np.arange(n, dtype=np.float32) * 1000.0)[:, None]
    return base, base + 1.0, base + 0.25, base + 0.75


def _ties():
    """Integer endpoints: many regions share a lo."""
    rng = np.random.default_rng(8)
    s_lo = rng.integers(0, 400, (900, 1)).astype(np.float32)
    u_lo = rng.integers(0, 400, (700, 1)).astype(np.float32)
    return s_lo, s_lo + 7, u_lo, u_lo + 5


CASES = {
    "paper_a8": lambda: _paper(77, 2000, 8.0),
    "paper_a50": lambda: _paper(79, 1500, 50.0),
    "paper_a100": lambda: _paper(3, 4096, 100.0),
    "blowup": blowup,
    "edges": edges,
    "one_cell": _one_cell,
    "disjoint": _disjoint,
    "ties": _ties,
    "zero_width": zero_width,
}
# cell-count overrides that make these small sets bucket (the heuristic
# gives one cell below 2,560 regions)
NCELLS = {"paper_a8": 64, "paper_a50": 16, "paper_a100": None,
          "blowup": None, "edges": 16, "one_cell": None, "disjoint": 32,
          "ties": 8, "zero_width": 16}


def _dim0(arrs):
    return [a[:, 0] for a in arrs]


def _tregions(lo, hi):
    return convert.regions_from_numpy(lo, hi, "cpu")


def _key_set(buf, m):
    buf = np.asarray(buf)
    keep = buf[:, 0] >= 0
    return set((buf[keep, 0].astype(np.int64) * m + buf[keep, 1]).tolist())


def _ref_emit(arrs, g, cap):
    """The reference's plain hybrid pass 2 on the geometry ``g``."""
    pairs, counts = jsbm._hsbm_emit(
        *[jnp.asarray(a) for a in _dim0(arrs)], jnp.float32(g.lb),
        jnp.float32(g.width), max_pairs=cap, **g.statics())
    return np.asarray(pairs), int(np.sum(np.asarray(counts), dtype=np.int64))


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ncells", [None, 1, 4, 64, 1024])
@pytest.mark.parametrize("case", sorted(CASES))
def test_geometry_field_equal_to_reference(case, ncells):
    arrs = _dim0(CASES[case]())
    want = jgrid.hsbm_geometry(*arrs, ncells=ncells)
    got = tgrid.hsbm_geometry(*arrs, ncells=ncells)
    assert {f: getattr(got, f) for f in FIELDS} == \
        {f: getattr(want, f) for f in FIELDS}
    assert (got.n_emit_s, got.n_emit_u) == (want.n_emit_s, want.n_emit_u)
    assert got.statics() == want.statics()


def test_geometry_blowup_guard_bounds_the_tables():
    arrs = blowup()
    s_lo, s_hi, u_lo, u_hi = _dim0(arrs)
    g = tgrid.hsbm_geometry(s_lo, s_hi, u_lo, u_hi)
    rows = g.ncells * (g.cap_s + g.suf_s + g.cap_u + g.suf_u)
    assert rows <= max(4 * (2 * s_lo.shape[0]), 1 << 16)
    S, U = _tregions(*arrs[:2]), _tregions(*arrs[2:])
    k = tcore.build_plan(tcore.MatchSpec(algo="sbm", backend="torch",
                                         device="cpu"), S.n, U.n, 1).count(
                                             S, U)
    for backend in ("torch", "cuda"):
        assert tcore.build_plan(tcore.MatchSpec(
            algo="hsbm", backend=backend, device="cpu"), S.n, U.n,
            1).count(S, U) == k


# ---------------------------------------------------------------------------
# pass 1
# ---------------------------------------------------------------------------

def _per_cell(ids, starts, counts, ncells):
    """Per cell: the multiset of (id, start, count) rows of count > 0, the
    multiset of (start, count) of all rows, and the count sum.  Which of
    several regions tied at the edge of a boundary suffix it repeats
    depends on the order of ties; such a region cannot reach the next
    cell (``grid.hsbm_geometry`` sizes the suffix), so its count is 0."""
    rows = np.stack([ids, starts, counts], 1).reshape(ncells, -1, 3)
    return ([sorted(map(tuple, r[r[:, 2] > 0].tolist())) for r in rows],
            [sorted(map(tuple, r[:, 1:].tolist())) for r in rows],
            counts.reshape(ncells, -1).astype(np.int64).sum(1))


@pytest.mark.parametrize("case", sorted(CASES))
def test_phase1_tables_equal_reference(case):
    arrs = _dim0(CASES[case]())
    g = tgrid.hsbm_geometry(*arrs, ncells=NCELLS[case])
    cap = 1 << 20
    want = [np.asarray(x) for x in jax.jit(
        jsbm._hsbm_phase1, static_argnames=tuple(g.statics()) + (
            "max_pairs",))(*[jnp.asarray(a) for a in arrs],
                           jnp.float32(g.lb), jnp.float32(g.width),
                           max_pairs=cap, **g.statics())]
    lw = torch.tensor([g.lb, g.width], dtype=torch.float32)
    got = [x.numpy() for x in tsbm._hsbm_phase1(
        *[torch.from_numpy(a) for a in arrs], lw[0], lw[1], max_pairs=cap,
        **g.statics())]
    assert all(x.dtype == np.int32 for x in got)
    assert [x.shape for x in got] == [x.shape for x in want]
    n_a = g.n_emit_s
    for side, ids, sl in (("S", 0, slice(0, n_a)), ("U", 1, slice(n_a, None))):
        cells_got = _per_cell(got[ids], got[2][sl], got[3][sl], g.ncells)
        cells_want = _per_cell(want[ids], want[2][sl], want[3][sl], g.ncells)
        assert cells_got[0] == cells_want[0], side
        assert cells_got[1] == cells_want[1], side
        np.testing.assert_array_equal(cells_got[2], cells_want[2])
    ties = any(np.unique(a).shape[0] < a.shape[0] for a in (arrs[0], arrs[2]))
    if not ties:
        # no two regions of a side share a lo: the order is defined
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)
    assert int(got[3].astype(np.int64).sum()) == \
        int(want[3].astype(np.int64).sum())


def test_phase1_offsets_past_2_30_are_the_clamped_int64_cumsum():
    """The hsbm twin of ROADMAP Queue 3 item A: at max_pairs = INT32_MAX
    on K = 2.5e9 the reference's int32 ``min(a + b, lim)`` scan wraps; the
    port's offsets are the int64 cumsum clamped at the cap, every entry
    saturated, and its counts are the reference's."""
    rng = np.random.default_rng(12)
    s_lo = rng.uniform(0, 1, 50_000).astype(np.float32)
    u_lo = rng.uniform(1, 2, 50_000).astype(np.float32)
    arrs = (s_lo, s_lo + 3, u_lo, u_lo + 3)
    g = tgrid.hsbm_geometry(*arrs)
    lw = torch.tensor([g.lb, g.width], dtype=torch.float32)
    got = tsbm._hsbm_phase1(*[torch.from_numpy(a) for a in arrs], lw[0],
                            lw[1], max_pairs=INT32_MAX, **g.statics())
    counts, offs = got[3].numpy(), got[4].numpy()
    assert int(counts.astype(np.int64).sum()) == 50_000 ** 2
    want = np.minimum(np.cumsum(counts, dtype=np.int64), INT32_MAX)
    np.testing.assert_array_equal(offs[1:], want)
    assert offs[0] == 0 and (np.diff(offs.astype(np.int64)) >= 0).all()
    j_counts = np.asarray(jax.jit(
        jsbm._hsbm_phase1, static_argnames=tuple(g.statics()) + (
            "max_pairs",))(*[jnp.asarray(a) for a in arrs],
                           jnp.float32(g.lb), jnp.float32(g.width),
                           max_pairs=INT32_MAX, **g.statics())[3])
    np.testing.assert_array_equal(np.sort(counts), np.sort(j_counts))


# ---------------------------------------------------------------------------
# the engine: count() and pairs()
# ---------------------------------------------------------------------------

ROUTES = [("torch", "auto"), ("cuda", "auto"), ("cuda", "resident"),
          ("cuda", "streaming"), ("cuda", "csr"), ("cuda", "xla")]


# the blow-up inputs have K = 1.2e7: their count is held in
# test_geometry_blowup_guard_bounds_the_tables; the zero-width regions,
# on which the hybrid is not sbm, in test_hsbm_on_zero_width_regions_...
@pytest.mark.parametrize("backend,route", ROUTES)
@pytest.mark.parametrize("case", sorted(set(CASES) - {"blowup",
                                                      "zero_width"}))
def test_hsbm_count_and_pairs_equal_reference_and_sbm(case, backend, route):
    arrs = CASES[case]()
    S, U = _tregions(*arrs[:2]), _tregions(*arrs[2:])
    nc = NCELLS[case]
    g = jgrid.hsbm_geometry(*_dim0(arrs), ncells=nc)
    k_sbm = tcore.build_plan(tcore.MatchSpec(algo="sbm", backend="torch",
                                             device="cpu"),
                             S.n, U.n, 1).count(S, U)
    want_buf, want_k = _ref_emit(arrs, g, max(k_sbm, 1))
    assert want_k == k_sbm
    plan = tcore.build_plan(tcore.MatchSpec(
        algo="hsbm", backend=backend, emit_route=route, hsbm_ncells=nc,
        device="cpu"), S.n, U.n, 1)
    assert plan.count(S, U) == k_sbm
    res, k = plan.pairs(S, U)
    assert k == k_sbm == res.count
    if backend == "cuda":
        assert ops.last_emit_route() == (
            "resident" if route == "auto" else route)
    assert isinstance(res, ops.HsbmCSRPairs) == (route == "csr")
    got = convert.pairs_to_numpy(res)
    assert got.shape == (max(k_sbm, 1), 2)
    assert _key_set(got, U.n) == _key_set(want_buf, U.n)
    sbm_res, _ = tcore.build_plan(tcore.MatchSpec(
        algo="sbm", backend="torch", device="cpu"), S.n, U.n, 1).pairs(S, U)
    assert _key_set(got, U.n) == _key_set(convert.pairs_to_numpy(sbm_res),
                                          U.n)
    plan.validate_pairs(res, count=k)


def _keys_of(mask, m):
    s_i, u_i = np.nonzero(mask)
    return set((s_i.astype(np.int64) * m + u_i).tolist())


@pytest.mark.parametrize("backend,route", ROUTES)
def test_hsbm_on_zero_width_regions_is_the_reference_hybrid(backend, route):
    """On regions with lo == hi the hybrid is not sbm, in the reference
    as in the port.  Its class A takes ``u.lo`` in ``[s.lo, s.hi)``, so a
    zero-width U region at the lo of a non-empty S region is a pair there
    that does not overlap it (``s.lo < u.hi`` fails).  On these 3000 x
    2500 regions: the brute mask has 265,417 pairs, the reference's
    ``_hsbm_emit`` and the port's hsbm 266,114 (697 such pairs more), and
    sbm's count, whose formula assumes non-empty regions, 265,362.  The
    port's hsbm is held to the reference's, pair for pair."""
    arrs = CASES["zero_width"]()
    s_lo, s_hi, u_lo, u_hi = _dim0(arrs)
    S, U = _tregions(*arrs[:2]), _tregions(*arrs[2:])
    nc = NCELLS["zero_width"]
    overlap = overlap_relation(s_lo, s_hi, u_lo, u_hi)
    hybrid = hybrid_relation(s_lo, s_hi, u_lo, u_hi)
    extra = hybrid & ~overlap
    s_i, u_i = np.nonzero(extra)
    assert (u_lo[u_i] == u_hi[u_i]).all() and (s_lo[s_i] == u_lo[u_i]).all()
    assert (s_lo[s_i] < s_hi[s_i]).all() and not (overlap & ~hybrid).any()
    assert (int(overlap.sum()), int(hybrid.sum())) == (265_417, 266_114)
    k_sbm = tcore.build_plan(tcore.MatchSpec(algo="sbm", backend="torch",
                                             device="cpu"),
                             S.n, U.n, 1).count(S, U)
    assert k_sbm == 265_362
    g = jgrid.hsbm_geometry(s_lo, s_hi, u_lo, u_hi, ncells=nc)
    want_buf, want_k = _ref_emit(arrs, g, int(hybrid.sum()))
    assert want_k == int(hybrid.sum())
    assert _key_set(want_buf, U.n) == _keys_of(hybrid, U.n)
    plan = tcore.build_plan(tcore.MatchSpec(
        algo="hsbm", backend=backend, emit_route=route, hsbm_ncells=nc,
        device="cpu"), S.n, U.n, 1)
    assert plan.count(S, U) == want_k
    res, k = plan.pairs(S, U)
    assert k == want_k
    assert _key_set(convert.pairs_to_numpy(res), U.n) == \
        _key_set(want_buf, U.n)


@pytest.mark.parametrize("capacity", ["exact", "fixed", "grow"])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("d,alpha", [(1, 4.0), (2, 60.0)])
def test_hsbm_capacities_and_d2_equal_sbm(d, alpha, backend, capacity):
    arrs = _paper(70 + d, 4000, alpha, d=d)
    S, U = _tregions(*arrs[:2]), _tregions(*arrs[2:])
    ref = tcore.build_plan(tcore.MatchSpec(algo="sbm", backend="torch",
                                           device="cpu"), S.n, U.n, d)
    want_k = ref.count(S, U)
    assert want_k > 0
    want = _key_set(convert.pairs_to_numpy(ref.pairs(S, U)[0]), U.n)
    kw = {"max_pairs": want_k + 5} if capacity == "fixed" else {}
    plan = tcore.build_plan(tcore.MatchSpec(
        algo="hsbm", backend=backend, capacity=capacity, hsbm_ncells=8,
        device="cpu", **kw), S.n, U.n, d)
    assert plan.count(S, U) == want_k
    res, k = plan.pairs(S, U)
    assert k == want_k
    assert _key_set(convert.pairs_to_numpy(res), U.n) == want
    plan.validate_pairs(res, count=k)
    if d == 1:
        # the reference's hybrid on the same inputs
        g = jgrid.hsbm_geometry(*_dim0(arrs), ncells=8)
        assert _key_set(_ref_emit(arrs, g, want_k)[0], U.n) == want


def test_hsbm_truncates_with_the_exact_count():
    arrs = _paper(77, 2000, 8.0)
    S, U = _tregions(*arrs[:2]), _tregions(*arrs[2:])
    for backend in ("torch", "cuda"):
        plan = tcore.build_plan(tcore.MatchSpec(
            algo="hsbm", backend=backend, capacity="fixed", max_pairs=100,
            hsbm_ncells=64, device="cpu"), S.n, U.n, 1)
        res, k = plan.pairs(S, U)
        full = convert.pairs_to_numpy(tsbm.hsbm_pairs(S, U, k, ncells=64)[0])
        np.testing.assert_array_equal(convert.pairs_to_numpy(res), full[:100])
        assert k > 100


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("empty", ["S", "U", "both"])
def test_hsbm_empty_sides(empty, backend):
    lo = np.arange(6, dtype=np.float32)[:, None]
    full, none = _tregions(lo, lo + 2), _tregions(lo[:0], lo[:0])
    S = none if empty in ("S", "both") else full
    U = none if empty in ("U", "both") else full
    plan = tcore.build_plan(tcore.MatchSpec(algo="hsbm", backend=backend,
                                            device="cpu"), S.n, U.n, 1)
    assert plan.count(S, U) == 0
    res, k = plan.pairs(S, U)
    assert k == 0 and (convert.pairs_to_numpy(res) == -1).all()


def test_hsbm_emit_route_under_auto_is_measured():
    plan = tcore.build_plan(tcore.MatchSpec(algo="hsbm", device="cpu"),
                            64, 64, 1)
    assert plan.emit_route() is None
    pinned = tcore.build_plan(tcore.MatchSpec(algo="hsbm", emit_route="csr",
                                              device="cpu"), 64, 64, 1)
    assert pinned.emit_route() == "csr"
    with pytest.raises(ValueError, match="csr"):
        tcore.MatchSpec(algo="hsbm", emit_route="csr", d=2, device="cpu")


def test_route_at_kolns_table_sizes():
    """Koln's hybrid tables (``koln_like_workload(0)``: 50 cells, cap
    21,376, suffix 9,424, so n_emit_s = n_emit_u = 1,540,000) need
    49,280,004 B resident: under the 50 MB L2 budget by 0.7 MB."""
    e = 50 * (21_376 + 9_424)
    assert ops.emit_route_bytes(e, e)["resident"] == 49_280_004
    assert ops.choose_emit_route(e, e) == "resident"
    assert ops.choose_emit_route(e + 60_000, e + 60_000) == "streaming"


# ---------------------------------------------------------------------------
# the remap and the csr view
# ---------------------------------------------------------------------------

def test_remap_slot_pairs_equals_reference():
    rng = np.random.default_rng(3)
    n_a, n_b, n, m = 640, 576, 500, 450
    sid = np.where(rng.random(n_a) < 0.2, -1,
                   rng.integers(0, n, n_a)).astype(np.int32)
    uid = np.where(rng.random(n_b) < 0.2, -1,
                   rng.integers(0, m, n_b)).astype(np.int32)
    c0 = np.concatenate([rng.integers(0, n_a, 300),
                         rng.integers(n_a, n_a + n, 300), [-1] * 50])
    c1 = np.concatenate([rng.integers(n_b, n_b + m, 300),
                         rng.integers(0, n_b, 300), [-1] * 50])
    pairs = np.stack([c0, c1], 1).astype(np.int32)
    want = np.asarray(jemit.remap_slot_pairs(
        jnp.asarray(pairs), jnp.asarray(sid), jnp.asarray(uid), n_a=n_a,
        n_b=n_b))
    got = emit.remap_slot_pairs(torch.from_numpy(pairs), torch.from_numpy(sid),
                                torch.from_numpy(uid))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["paper_a50", "edges", "ties"])
def test_hsbm_csr_windows_equal_plain_pass2_slices(case):
    """Each window of the csr view (K6's plain decode, then the remap)
    equals the same slice of the port's plain hybrid pass 2, and, as a
    set, of the reference's ``_hsbm_emit``; −1 pads past K."""
    arrs = CASES[case]()
    S, U = _tregions(*arrs[:2]), _tregions(*arrs[2:])
    nc = NCELLS[case]
    k = tcore.build_plan(tcore.MatchSpec(algo="sbm", backend="torch",
                                         device="cpu"), S.n, U.n, 1).count(
                                             S, U)
    cap = k + 300
    view, kv = ops.hsbm_pairs_cuda(S, U, cap, ncells=nc, route="csr")
    plain, kp = tsbm.hsbm_pairs(S, U, cap, ncells=nc)
    assert kv == kp == k
    assert view.nbytes == 4 * (view.tab.numel() + 2 * view.sid.numel()
                               + 2 * view.uid.numel())
    for w0, w1 in [(0, 1), (0, 257), (k // 3, k // 3 + 100),
                   (k - 5, k + 5), (k, cap), (0, cap)]:
        assert torch.equal(view.decode(w0, w1), plain[w0:w1]), (w0, w1)
    g = jgrid.hsbm_geometry(*_dim0(arrs), ncells=nc)
    want, _ = _ref_emit(arrs, g, cap)
    assert _key_set(convert.pairs_to_numpy(view), U.n) == _key_set(want, U.n)
    assert (np.asarray(view)[k:] == -1).all()
