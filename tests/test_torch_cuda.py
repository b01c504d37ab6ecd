"""The port's CUDA kernels on the card, against their plain versions.

K1 (``csrc/sbm_sweep.cu``), K2 (``csrc/emit.cu``), K3 (``csrc/bfm.cu``),
K4 (``csrc/bfm_mask.cu``), K5 (``csrc/emit_stream.cu``), K6
(``csrc/csr_decode.cu``), K7 (``csrc/sparse_attn.cu``) and K8
(``csrc/itm_walk.cu``), also on the hsbm, serving and distributed paths,
have no CPU mode, so these tests carry the
``cuda`` marker and skip on a host without a card.  The file imports neither JAX nor the JAX package, so it also runs
on the card host, which has no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because the repository's conftest clears JAX caches.)
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_cases as dist_cases  # noqa: E402
from torch_emit_tables import zero_run_tables  # noqa: E402
from torch_hsbm_cases import blowup, edges, hybrid_relation  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import MatchSpec, build_plan, paper_workload  # noqa: E402
from repro_torch.core import sbm  # noqa: E402
from repro_torch.core import DDMService, itm  # noqa: E402
from repro_torch.kernels import _build, bfm, emit, ops, ref  # noqa: E402
from repro_torch.kernels import itm as k8  # noqa: E402
from repro_torch.kernels import sbm_sweep as sweep  # noqa: E402
from repro_torch.kernels import sparse_attn as tsa  # noqa: E402
from repro_torch.sparse import BlockPlan, block_windows  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    """The CUDA device; skips the test on a host without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _ties(card, n=3000, m=2500, seed=0):
    """Integer endpoints (many exact ties) with some lo == hi regions."""
    rng = np.random.default_rng(seed)
    s_lo = rng.integers(0, 500, n).astype(np.float32)
    s_hi = s_lo + rng.integers(0, 20, n).astype(np.float32)
    u_lo = rng.integers(0, 500, m).astype(np.float32)
    u_hi = u_lo + rng.integers(0, 20, m).astype(np.float32)
    return (convert.regions_from_numpy(s_lo, s_hi, card),
            convert.regions_from_numpy(u_lo, u_hi, card))


def _dim0(R):
    return type(R)(R.lo[:, :1], R.hi[:, :1])


def _flags(card, T, seed, offset=0):
    """Random 0/1 int32 flags (prefixes of either sign), as contiguous
    views starting ``offset`` elements into their buffers."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.integers(0, 2, T + offset).astype(
        np.int32)).to(card)[offset:] for _ in range(2))


# K1's tile is 4096 endpoints; 2^21 + 3 spans 513 tiles and a ragged tail
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("T", [1, 2, 255, 2048, 2049, 4095, 4096, 4097,
                               6000, 1 << 17, (1 << 21) + 3])
def test_sweep_kernel_matches_plain(card, T, offset):
    # offset 1: views off a 16-byte boundary take the scalar instance
    is_lo, is_upd = _flags(card, T, T, offset)
    assert is_lo.is_contiguous() and (is_lo.data_ptr() % 16 != 0) == offset
    before = sweep.sbm_sweep.launches
    got = sweep.sbm_sweep(is_lo, is_upd)
    torch.cuda.synchronize()
    assert sweep.sbm_sweep.launches == before + 1
    assert torch.equal(got, ref.sbm_sweep(is_lo, is_upd))


def test_sweep_kernel_resets_its_scratch_every_call(card):
    # 50 calls queued on one stream: each zeroes its counter and status
    # words before its kernel, so every result is the same
    is_lo, is_upd = _flags(card, 2_000_000, 5)
    want = ref.sbm_sweep(is_lo, is_upd)
    outs = [sweep.sbm_sweep(is_lo, is_upd) for _ in range(50)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for o in outs)


def test_sweep_kernel_on_two_side_streams(card):
    a, b = _flags(card, 1_500_001, 6), _flags(card, 2_000_000, 7)
    want = [ref.sbm_sweep(*a), ref.sbm_sweep(*b)]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = [[], []]
    for _ in range(10):
        for i, (st, x) in enumerate(zip(streams, (a, b))):
            with torch.cuda.stream(st):
                got[i].append(sweep.sbm_sweep(*x))
    torch.cuda.synchronize()
    for i in range(2):
        assert all(torch.equal(g, want[i]) for g in got[i])


def test_sweep_call_issues_one_kernel(card):
    from torch.profiler import ProfilerActivity, profile
    is_lo, is_upd = _flags(card, 2_000_000, 8)
    sweep.sbm_sweep(is_lo, is_upd)           # built and warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sweep.sbm_sweep(is_lo, is_upd)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [x for x in names if "memset" not in x.lower()]
    assert len(kernels) == 1 and "sbm_sweep_kernel" in kernels[0], names
    assert len(names) - len(kernels) <= 1, names


def test_sweep_refused_launch_raises(card):
    # more tiles than the launch function takes: refused before the
    # memset or the kernel, and _build.check raises
    lib = _build.load("sbm_sweep")
    x = torch.zeros(8, dtype=torch.int32, device=card)
    rc = _build.launch(x.device, lib.sbm_sweep_launch, x.data_ptr(),
                       x.data_ptr(), x.data_ptr(), x.data_ptr(), 1 << 62)
    assert rc != 0
    with pytest.raises(RuntimeError, match="sbm_sweep kernel launch failed"):
        _build.check(lib, "sbm_sweep", rc)


def _workload(card, case):
    """Regions of a card-test case: the ties table, or ``paper_a<alpha>``
    at N = 60,000, or ``paper_a<alpha>_2e5`` at N = 2e5 (at alpha 1 and
    0.01 most emitters have count 0, so K2's tiles span more than
    ``emit.EMIT_WMAX`` entries; at 0.01 more than ``EMIT_PERSLOT_SPAN``
    tiles' worth, the per-slot search)."""
    if case == "ties":
        return _ties(card)
    alpha, _, big = case[7:].partition("_")
    return paper_workload(4, 200_000 if big else 60_000, float(alpha),
                          device=card)


def _zero_run_tables(card, seed):
    """``torch_emit_tables.zero_run_tables`` on the card."""
    *tables, k = zero_run_tables(seed)
    return (*(torch.from_numpy(x).to(card) for x in tables), k)


def _emit_tables(card, case, max_pairs):
    """(offs, counts, starts, perm_s, perm_u) at ``max_pairs``."""
    if case.startswith("zero_runs"):
        counts, starts, perm_s, perm_u, _ = _zero_run_tables(
            card, int(case[-1]))
        incl = torch.cumsum(counts, 0, dtype=torch.int64).clamp_(
            max=max_pairs)
        offs = torch.cat([torch.zeros(1, dtype=torch.int32, device=card),
                          incl.to(torch.int32)])
        return offs, counts, starts, perm_s, perm_u
    S, U = _workload(card, case)
    perm_s, perm_u, starts, counts, offs = sbm._twopass_phase1(
        S.lo[:, 0], S.hi[:, 0], U.lo[:, 0], U.hi[:, 0], max_pairs)[:5]
    return offs, counts, starts, perm_s, perm_u


def _emit_k(card, case):
    if case.startswith("zero_runs"):
        return _zero_run_tables(card, int(case[-1]))[-1]
    return sbm.sbm_count_binary(*_workload(card, case))


EMIT_CASES = ["paper_a50", "paper_a0.5", "ties", "paper_a1_2e5",
              "paper_a0.01_2e5", "zero_runs0", "zero_runs1"]


@pytest.mark.parametrize("case", EMIT_CASES)
def test_emit_kernel_matches_plain(card, case):
    k = _emit_k(card, case)
    for max_pairs in sorted({1, max(k // 3, 1), 2 * (k // 4) + 1, k,
                             k + 100}):
        t = _emit_tables(card, case, max_pairs)
        before = emit.twopass_emit.launches
        got = emit.twopass_emit(*t, max_pairs=max_pairs)
        torch.cuda.synchronize()
        assert emit.twopass_emit.launches == before + 1
        assert torch.equal(got, ref.twopass_emit(*t, max_pairs=max_pairs))
        # K5 on the same tables writes the same buffer
        tab = emit.pack_emitter_tables(*t[:3], n=t[3].shape[0],
                                       m=t[4].shape[0])
        assert torch.equal(emit.twopass_emit_streaming(
            tab, t[3], t[4], max_pairs=max_pairs), got)
    before = emit.twopass_emit.launches
    assert tuple(emit.twopass_emit(*t, max_pairs=0).shape) == (0, 2)
    assert emit.twopass_emit.launches == before


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("capacity", ["exact", "fixed", "grow"])
def test_cuda_backend_equals_torch_backend(card, capacity, d):
    S, U = paper_workload(9, 20_000, 200.0, d=d, device=card)
    k = sbm.sbm_count_binary(_dim0(S), _dim0(U))
    max_pairs = None if capacity == "exact" else max(k // 4, 1)
    out = {}
    for backend in ("cuda", "torch"):
        sweep.sbm_sweep.launches = emit.twopass_emit.launches = 0
        plan = build_plan(MatchSpec(backend=backend, capacity=capacity,
                                    max_pairs=max_pairs), S.n, U.n, d)
        res, kp = plan.pairs(S, U)
        out[backend] = (plan.count(S, U), kp, res.data,
                        emit.twopass_emit.launches)
    assert out["cuda"][:2] == out["torch"][:2]
    assert torch.equal(out["cuda"][2], out["torch"][2])
    assert out["cuda"][3] >= 1 and out["torch"][3] == 0


def test_kernel_wrappers_reject_bad_tensors(card):
    x = torch.zeros(8, dtype=torch.int64, device=card)
    with pytest.raises(ValueError, match="int32"):
        sweep.sbm_sweep(x, x)
    t = [torch.zeros(k, dtype=torch.int32, device=card) for k in (5, 4, 4)]
    perm = torch.zeros(2, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="offs"):
        emit.twopass_emit(t[1], t[1], t[2], perm, perm, max_pairs=3)


def _boxes(card, n, m, d, seed, values="grid"):
    """Integer-grid boxes (exact ties, duplicate endpoints) with every
    fifth S region and every seventh U region empty (lo == hi).

    ``values="ulp"`` also puts every third U region's bounds one ulp off
    an S region's (in dimension 0) and adds bounds near 2^-40 and 2^62
    to S, the widest exponent spread K3's FMA compare takes;
    ``values="subnormal"`` adds a subnormal bound as well, which sends
    K3's d1 path to its FSETP compare."""
    rng = np.random.default_rng(seed)

    def side(k):
        lo = rng.integers(0, 60, (k, d)).astype(np.float32)
        hi = lo + rng.integers(1, 15, (k, d)).astype(np.float32)
        return lo, hi

    s_lo, s_hi = side(n)
    s_hi[::5] = s_lo[::5]
    u_lo, u_hi = side(m)
    u_hi[3::7] = u_lo[3::7]
    if values != "grid":     # shifted off 0, whose neighbour is subnormal
        s_lo, s_hi, u_lo, u_hi = (x + 1 for x in (s_lo, s_hi, u_lo, u_hi))
        j = rng.integers(0, n, m)[::3]
        up, down = np.float32(np.inf), np.float32(-np.inf)
        u_hi[::3, 0] = np.nextafter(s_lo[j, 0], up)
        u_lo[::3, 0] = np.nextafter(s_hi[j, 0], down)
        u_lo[::3, 0] = np.minimum(u_lo[::3, 0], u_hi[::3, 0])
        s_lo[-1, 0], s_hi[-1, 0] = np.float32(2.0 ** -40), np.float32(2.0 ** 62)
        if values == "subnormal":
            s_lo[0, 0] = np.float32(1e-40)
    return (convert.regions_from_numpy(s_lo, s_hi, card),
            convert.regions_from_numpy(u_lo, u_hi, card))


def _sentinel_tiles(lo, hi, rows):
    """Append ``rows`` regions that match nothing (lo = +inf, hi = -inf)."""
    d = lo.shape[1]
    return (torch.cat([lo, lo.new_full((rows, d), float("inf"))]),
            torch.cat([hi, hi.new_full((rows, d), float("-inf"))]))


# (n, m, ts, tu, whole tiles of sentinels appended to S and to U), on
# the three kinds of bounds of ``_boxes``.  K3
# takes its d1 path at d = 1 with tu in {16, ..., 512} and ts <= 4096:
# 256 × 256 (fig. 9's tile), 64 × 128, 8 × 16 (one thread per tile),
# 32 × 512 (a warp per tile) and an odd ts = 3 whose m spills one column
# group into a second 4096-column chunk; tu = 8 (smaller than one
# 16-column register block), 2048 × 2048 and every d > 1 take the
# general path.  m covers every store width of K4 (16, 8, 4, 2 and 1
# bytes).  (2048, 4096, 2048, 2048) needs more than 48 KB of shared
# memory per general CTA at d >= 2, the opt-in launch path.
@pytest.mark.parametrize("values", ["grid", "ulp", "subnormal"])
@pytest.mark.parametrize("d", [1, 2, 3, 4])
@pytest.mark.parametrize("n,m,ts,tu,pad", [(256, 1024, 256, 256, 0),
                                           (300, 517, 64, 128, 0),
                                           (1000, 1000, 256, 256, 2),
                                           (5, 1004, 8, 16, 0),
                                           (777, 998, 32, 512, 1),
                                           (2048, 4096, 2048, 2048, 0),
                                           (40, 100, 4, 8, 3),
                                           (33, 4100, 3, 16, 1)])
def test_bfm_kernels_match_plain(card, n, m, ts, tu, pad, d, values):
    S, U = _boxes(card, n, m, d, seed=n + m + d, values=values)
    s_lo, s_hi = _sentinel_tiles(*ops._pad_regions(S.lo, S.hi, ts), pad * ts)
    u_lo, u_hi = _sentinel_tiles(*ops._pad_regions(U.lo, U.hi, tu), pad * tu)
    d1 = d == 1 and tu in (16, 32, 64, 128, 256, 512) and ts <= 4096
    assert _build.load("bfm").bfm_tile_counts_d1_path(ts, tu, d) == d1
    before = (bfm.bfm_tile_counts.launches, bfm.bfm_mask.launches)
    tiles = bfm.bfm_tile_counts(s_lo, s_hi, u_lo, u_hi, ts=ts, tu=tu)
    mask = bfm.bfm_mask(S.lo, S.hi, U.lo, U.hi)
    torch.cuda.synchronize()
    assert (bfm.bfm_tile_counts.launches, bfm.bfm_mask.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(tiles, ref.bfm_tile_counts(s_lo, s_hi, u_lo, u_hi,
                                                  ts, tu))
    if pad:
        assert not bool(tiles[-pad:].any() or tiles[:, -pad:].any())
    assert torch.equal(mask, ref.bfm_mask(S.lo, S.hi, U.lo, U.hi))
    assert int(tiles.sum(dtype=torch.int64)) == int(mask.sum())


@pytest.mark.parametrize("case", ["paper_a50", "paper_a0.5", "ties"])
def test_stream_and_csr_kernels_match_plain(card, case):
    S, U = _workload(card, case)
    k = sbm.sbm_count_binary(S, U)
    rng = np.random.default_rng(5)
    for max_pairs in sorted({1, max(k // 3, 1), 2 * (k // 4) + 1, k,
                             k + 100}):
        perm_s, perm_u, starts, counts, offs = sbm._twopass_phase1(
            S.lo[:, 0], S.hi[:, 0], U.lo[:, 0], U.hi[:, 0], max_pairs)[:5]
        dense = ref.twopass_emit(offs, counts, starts, perm_s, perm_u,
                                 max_pairs=max_pairs)
        tab = emit.pack_emitter_tables(offs, counts, starts, n=S.n, m=U.n,
                                       min_len=emit.stream_window(56_960))
        # 11,520 and 56,960 (the largest tile): > 48 KB of shared memory
        for block in (100, 128, 384, 512, 1000, 2048, 4096, 11_520, 56_960):
            before = emit.twopass_emit_streaming.launches
            got = emit.twopass_emit_streaming(tab, perm_s, perm_u,
                                              max_pairs=max_pairs,
                                              block=block)
            torch.cuda.synchronize()
            assert emit.twopass_emit_streaming.launches == before + 1
            assert torch.equal(got, dense), block
        for w0 in {0, max_pairs - 1, *rng.integers(0, max_pairs, 4).tolist()}:
            nsl = min(max_pairs - w0, int(rng.integers(1, 70_000)))
            before = emit.csr_decode_window.launches
            got = emit.csr_decode_window(tab, perm_s, perm_u, w0, nsl)
            torch.cuda.synchronize()
            assert emit.csr_decode_window.launches == before + 1
            assert torch.equal(got, dense[w0:w0 + nsl])
            assert torch.equal(got, ref.csr_decode_window(tab, perm_s, perm_u,
                                                          w0, nsl))


def _hybrid_case(card, case):
    """(S, U, ncells) of a hybrid card-test case: ``paper_a50``; ``ties``,
    the ``_ties`` table (lo == hi regions included); ``ties_nonempty``,
    integer lows with widths 1..19; ``edges``, lows on and one ulp around
    the cell edges; ``blowup``, the geometry's blow-up guard inputs (the
    heuristic cell count)."""
    if case == "paper_a50":
        return (*_workload(card, case), 16)
    if case == "ties":
        return (*_ties(card), 16)
    if case == "ties_nonempty":
        rng = np.random.default_rng(0)
        lo = rng.integers(0, 500, (2, 3000)).astype(np.float32)
        hi = lo + rng.integers(1, 20, (2, 3000)).astype(np.float32)
        arrs = (lo[0], hi[0], lo[1], hi[1])
    else:
        arrs = {"edges": edges, "blowup": blowup}[case]()
    return (convert.regions_from_numpy(*arrs[:2], card),
            convert.regions_from_numpy(*arrs[2:], card),
            None if case == "blowup" else 16)


@pytest.mark.parametrize("case", ["paper_a50", "ties", "ties_nonempty",
                                  "edges", "blowup"])
def test_emit_kernels_on_hybrid_tables_match_plain(card, case):
    """The hybrid on the card: each region in the cell NumPy's float32
    ``floor((lo - lb) / width)`` gives it, pass 1's tables equal to the
    CPU's, K2, K5 and K6 on the emitter-slot tables (the shifted id
    tables in the permutations' place) equal to their plain versions, and
    each hsbm route, remapped, bit-equal to the plain hybrid pass 2.  K is
    sbm's; on the ``ties`` table, whose lo == hi regions the hybrid's
    class A pairs with the S regions starting there, it is the hybrid
    relation's, as in the reference (tests/test_torch_hsbm.py)."""
    S, U, nc = _hybrid_case(card, case)
    host = [x[:, 0].cpu().numpy() for x in (S.lo, S.hi, U.lo, U.hi)]
    empty = any((lo == hi).any() for lo, hi in (host[:2], host[2:]))
    k = sbm.sbm_count_binary(S, U)
    if empty:
        k = int(hybrid_relation(*host).sum())
    b, g, lb, width = sbm.hsbm_inputs(S, U, ncells=nc)
    Sc, Uc = (convert.regions_from_numpy(lo[:, None], hi[:, None], "cpu")
              for lo, hi in (host[:2], host[2:]))
    bc, gc, lbc, widthc = sbm.hsbm_inputs(Sc, Uc, ncells=nc)
    assert gc == g
    n_a, n_b = g.n_emit_s, g.n_emit_u
    for max_pairs in sorted({1, max(k // 3, 1), k, k + 100}):
        tables = sbm._hsbm_phase1(*b, lb, width, max_pairs=max_pairs,
                                  **g.statics())
        cpu_tables = sbm._hsbm_phase1(*bc, lbc, widthc, max_pairs=max_pairs,
                                      **g.statics())
        for x, y in zip(tables, cpu_tables):
            assert torch.equal(x.cpu(), y)
        sid, uid, starts, counts, offs = tables
        # natives per cell on the card == NumPy's float32 cells
        for ids, lo, cap, suf in ((sid, host[0], g.cap_s, g.suf_s),
                                  (uid, host[2], g.cap_u, g.suf_u)):
            cells = np.clip(np.floor((lo - np.float32(g.lb))
                                     / np.float32(g.width)), 0, g.ncells - 1)
            np.testing.assert_array_equal(
                (ids.view(g.ncells, cap + suf)[:, :cap] >= 0).sum(1).cpu(),
                np.bincount(cells.astype(np.int64), minlength=g.ncells))
        assert sbm._total(counts) == k
        ps, pu = sid + n_a, uid + n_b
        dense = ref.twopass_emit(offs, counts, starts, ps, pu,
                                 max_pairs=max_pairs)
        before = (emit.twopass_emit.launches,
                  emit.twopass_emit_streaming.launches,
                  emit.csr_decode_window.launches)
        got2 = emit.twopass_emit(offs, counts, starts, ps, pu,
                                 max_pairs=max_pairs)
        tab = emit.pack_emitter_tables(
            offs, counts, starts, n=n_a, m=n_b,
            min_len=emit.stream_window(emit.DEF_BLOCK))
        got5 = emit.twopass_emit_streaming(tab, ps, pu, max_pairs=max_pairs)
        w0 = max_pairs // 2
        got6 = emit.csr_decode_window(tab, ps, pu, w0, max_pairs - w0)
        torch.cuda.synchronize()
        assert (emit.twopass_emit.launches,
                emit.twopass_emit_streaming.launches,
                emit.csr_decode_window.launches) == tuple(
                    x + 1 for x in before)
        assert torch.equal(got2, dense) and torch.equal(got5, dense)
        assert torch.equal(got6, dense[w0:])
        plain, pk = sbm._hsbm_emit(*b, lb, width, max_pairs=max_pairs,
                                   **g.statics())
        assert torch.equal(emit.remap_slot_pairs(dense, sid, uid), plain)
        for route in ("resident", "streaming", "csr", "xla"):
            res, rk = ops.hsbm_pairs_cuda(S, U, max_pairs, ncells=nc,
                                          route=route)
            assert rk == k == sbm._total(pk)
            got = res.to_dense() if route == "csr" else res
            assert torch.equal(got, plain), (route, max_pairs)


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("capacity", ["exact", "fixed", "grow"])
def test_hsbm_cuda_backend_equals_torch_backend(card, capacity, d):
    S, U = paper_workload(9, 20_000, 200.0, d=d, device=card)
    kw = {"max_pairs": 5000} if capacity == "fixed" else {}
    want = build_plan(MatchSpec(algo="hsbm", backend="torch",
                                capacity=capacity, **kw), S.n, U.n, d)
    wres, wk = want.pairs(S, U)
    sres, sk = build_plan(MatchSpec(), S.n, U.n, d).pairs(S, U)
    plan = build_plan(MatchSpec(algo="hsbm", capacity=capacity, **kw), S.n,
                      U.n, d)
    assert plan.count(S, U) == want.count(S, U) == sk
    res, k = plan.pairs(S, U)
    assert k == wk == sk
    assert torch.equal(res.data, wres.data)
    keys = [torch.sort(x[x[:, 0] >= 0, 0].long() * U.n
                       + x[x[:, 0] >= 0, 1].long()).values
            for x in (res.data, sres.data)]
    if capacity != "fixed":
        assert torch.equal(*keys)


def test_mask_kernel_past_65535_row_tiles(card):
    # 4.3e6 rows are 134,375 row tiles of 32, more than 65535 and than
    # the persistent grid's CTAs: each CTA's grid-stride loop must cover
    # its share (m = 3: one byte a store)
    S, U = _boxes(card, 4_300_000, 3, 1, seed=8)
    mask = bfm.bfm_mask(S.lo, S.hi, U.lo, U.hi)
    torch.cuda.synchronize()
    assert torch.equal(mask, ref.bfm_mask(S.lo, S.hi, U.lo, U.hi))


def test_csr_kernel_above_2_30(card):
    n = m = 40_000
    rng = np.random.default_rng(12)
    s_lo = rng.uniform(0, 1, n).astype(np.float32)
    u_lo = rng.uniform(1, 2, m).astype(np.float32)
    S = convert.regions_from_numpy(s_lo, s_lo + 3, card)
    U = convert.regions_from_numpy(u_lo, u_lo + 3, card)
    K = n * m
    view, k = ops.twopass_pairs_csr(S, U, K)
    assert k == K
    perm_s, perm_u, starts, counts, offs = sbm._twopass_phase1(
        S.lo[:, 0], S.hi[:, 0], U.lo[:, 0], U.hi[:, 0], K)[:5]
    last = int(offs[n - 1])
    for w0, stop in ((last - 1000, last + 1000), (K - 3000, K)):
        got = view.decode(w0, stop)
        torch.cuda.synchronize()
        assert torch.equal(got, sbm._twopass_window(
            offs, counts, starts, perm_s, perm_u, w0, stop))


# K4 at every store width V (the largest of 16, 8, 4, 2, 1 dividing m:
# 4096 and 4112 take 16, 4104 8, 1004 4, 998 2, 4097 and 517 1) and in
# both register layouts (d = 1; d >= 2, dimensions past the second read
# through L1).  n is not a multiple of the 32-row tile; 20,001 x 12,304
# is 4 column blocks x 626 row tiles, more items than the persistent grid
# has CTAs, so CTAs take several; 3 x 1,200,016 has 293 column blocks of
# 4096, more than CTAs, so a CTA changes column block and reloads its U
# bounds.
@pytest.mark.parametrize("values", ["grid", "ulp", "subnormal"])
@pytest.mark.parametrize("d", [1, 2, 3, 4])
@pytest.mark.parametrize("n,m", [(1000, 4096), (77, 4112), (31, 4104),
                                 (64, 1004), (1001, 998), (300, 4097),
                                 (333, 517), (5, 16), (20_001, 12_304),
                                 (3, 1_200_016)])
def test_mask_kernel_instances_match_plain(card, n, m, d, values):
    S, U = _boxes(card, n, m, d, seed=n + m + d, values=values)
    args = (S.lo, S.hi, U.lo, U.hi)
    before = bfm.bfm_mask.launches
    got = bfm.bfm_mask(*args)
    torch.cuda.synchronize()
    assert bfm.bfm_mask.launches == before + 1
    assert torch.equal(got, ref.bfm_mask(*args))


def _csr_case(card, case):
    """Regions of K6's card tests: the saturated tables of
    ``test_stream_and_csr_kernels_match_plain``, one run of 6000 slots
    per emitter (several tiles each) and count-1 emitters."""
    if case == "ties":
        return _ties(card)
    if case.startswith("paper"):
        return paper_workload(4, 60_000, float(case[7:]), device=card)
    if case == "wide":
        rng = np.random.default_rng(1)
        s_lo = rng.uniform(0, 1, 50).astype(np.float32)
        u_lo = rng.uniform(1, 2, 6000).astype(np.float32)
        return (convert.regions_from_numpy(s_lo, s_lo + 3, card),
                convert.regions_from_numpy(u_lo, u_lo + 3, card))
    lo = 2 * np.arange(5000, dtype=np.float32)
    R = convert.regions_from_numpy(lo, lo + 1, card)
    return R, R


def _tile_spans(tab, w0, nslots):
    """Entries k1 - k0 + 1 that each K6 tile of the window selects."""
    t0 = torch.arange(w0, w0 + nslots, emit.CSR_TILE, device=tab.device)
    t1 = torch.clamp(t0 + emit.CSR_TILE - 1, max=w0 + nslots - 1)
    k0 = (torch.searchsorted(tab[0], t0.int(), right=True) - 1).clamp(min=0)
    k1 = (torch.searchsorted(tab[0], t1.int(), right=True) - 1).clamp(min=0)
    return k1 - k0 + 1


@pytest.mark.parametrize("case", ["paper_a50", "paper_a0.5", "ties", "wide",
                                  "ones"])
def test_csr_kernel_tiles_match_plain(card, case):
    lib = _build.load("csr_decode")
    T = emit.CSR_TILE
    assert (lib.csr_decode_tile(), lib.csr_decode_wmax()) == (T,
                                                              emit.CSR_WMAX)
    S, U = _csr_case(card, case)
    k = sbm.sbm_count_binary(S, U)
    rng = np.random.default_rng(6)
    for cap in sorted({1, max(k // 3, 1), k, k + 100}):
        perm_s, perm_u, starts, counts, offs = sbm._twopass_phase1(
            S.lo[:, 0], S.hi[:, 0], U.lo[:, 0], U.hi[:, 0], cap)[:5]
        dense = ref.twopass_emit(offs, counts, starts, perm_s, perm_u,
                                 max_pairs=cap)
        tab = emit.pack_emitter_tables(offs, counts, starts, n=S.n, m=U.n)
        windows = {(0, 1), (cap - 1, 1), (T // 2 + 3, 3 * T + 5),
                   (max(cap - 2 * T - 7, 0), min(cap, 2 * T + 7)),
                   (max(cap - T // 2, 0), 2 * T + 1), (cap + 5, T + 3),
                   *((int(w), int(rng.integers(1, 3 * T)))
                     for w in rng.integers(0, cap, 3))}
        per_slot = 0
        for w0, nsl in sorted(windows):
            before = emit.csr_decode_window.launches
            got = emit.csr_decode_window(tab, perm_s, perm_u, w0, nsl)
            torch.cuda.synchronize()
            assert emit.csr_decode_window.launches == before + 1
            assert torch.equal(got, ref.csr_decode_window(
                tab, perm_s, perm_u, w0, nsl)), (cap, w0, nsl)
            stop = min(w0 + nsl, cap)
            if w0 < stop:
                assert torch.equal(got[:stop - w0], dense[w0:stop])
            per_slot += int((_tile_spans(tab, w0, nsl)
                             > emit.CSR_WMAX).sum())
        if cap >= k:        # strictly rising offsets: every tile staged
            assert per_slot == 0
        elif case == "paper_a50":   # ~2e4 saturated entries past the cap
            assert per_slot > 0


def test_csr_kernel_at_the_int32_cap(card):
    # n = m = 50,000 all-overlapping regions: K = 2.5e9 > INT32_MAX, so
    # at the cap INT32_MAX the last emitters' offsets saturate at the
    # pads' INT32_MAX (the Koln windows' repeated-offset case); windows
    # below it never select them
    n = m = 50_000
    rng = np.random.default_rng(13)
    s_lo = rng.uniform(0, 1, n).astype(np.float32)
    u_lo = rng.uniform(1, 2, m).astype(np.float32)
    S = convert.regions_from_numpy(s_lo, s_lo + 3, card)
    U = convert.regions_from_numpy(u_lo, u_lo + 3, card)
    cap = 2 ** 31 - 1
    perm_s, perm_u, starts, counts, offs = sbm._twopass_phase1(
        S.lo[:, 0], S.hi[:, 0], U.lo[:, 0], U.hi[:, 0], cap)[:5]
    tab = emit.pack_emitter_tables(offs, counts, starts, n=n, m=m)
    last = int(tab[0][tab[0] < cap].max())
    for w0, stop in ((last - 1000, last + 3000), (cap - 3000, cap),
                     ((1 << 30) - 7, (1 << 30) + 2100)):
        got = emit.csr_decode_window(tab, perm_s, perm_u, w0, stop - w0)
        torch.cuda.synchronize()
        want = sbm._twopass_window(offs, counts, starts, perm_s, perm_u,
                                   w0, stop)
        assert bool((want >= 0).all())
        assert torch.equal(got, want), w0


@pytest.mark.parametrize("d", [1, 2])
def test_bfm_gbm_and_routes_equal_torch_backend(card, d):
    S, U = paper_workload(9, 20_000, 200.0, d=d, device=card)
    want = build_plan(MatchSpec(backend="torch"), S.n, U.n, d)
    wres, wk = want.pairs(S, U)
    for algo in ("bfm", "gbm"):
        plan = build_plan(MatchSpec(algo=algo), S.n, U.n, d)
        res, k = plan.pairs(S, U)
        assert plan.count(S, U) == k
        bplan = build_plan(MatchSpec(algo="bfm", backend="torch"), S.n,
                           U.n, d)
        bres, bk = bplan.pairs(S, U)
        assert k == bk == wk and torch.equal(res.data, bres.data)
        assert torch.equal(plan.mask(S, U), bplan.mask(S, U))
    for route in ("resident", "streaming", "csr", "xla"):
        if route == "csr" and d > 1:
            continue
        plan = build_plan(MatchSpec(emit_route=route), S.n, U.n, d)
        res, k = plan.pairs(S, U)
        assert k == wk and ops.last_emit_route() == route
        assert torch.equal(res.to_dense(), wres.data), route


def test_new_kernel_wrappers_reject_bad_tensors(card):
    f64 = torch.zeros((8, 1), dtype=torch.float64, device=card)
    f32 = torch.zeros((8, 1), dtype=torch.float32, device=card)
    with pytest.raises(ValueError, match="float32"):
        bfm.bfm_tile_counts(f64, f64, f32, f32, ts=8, tu=8)
    with pytest.raises(ValueError, match="n % ts"):
        bfm.bfm_tile_counts(f32, f32, f32, f32, ts=3, tu=8)
    with pytest.raises(ValueError, match="float32"):
        bfm.bfm_mask(f32, f32, f64, f64)
    with pytest.raises(ValueError, match="share d"):
        bfm.bfm_mask(f32, f32, f32.repeat(1, 2), f32.repeat(1, 2))
    perm = torch.zeros(3, dtype=torch.int32, device=card)
    tab = torch.zeros((4, 128), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="narrower"):
        emit.twopass_emit_streaming(tab, perm, perm, max_pairs=5)
    # a tile of 57,088 slots needs more than 227 KB of shared memory
    wide = torch.zeros((4, emit.stream_window(57_088)), dtype=torch.int32,
                       device=card)
    with pytest.raises(RuntimeError, match="emit_stream"):
        emit.twopass_emit_streaming(wide, perm, perm, max_pairs=5,
                                    block=57_088)
    with pytest.raises(ValueError, match="packed"):
        emit.csr_decode_window(tab[:3], perm, perm, 0, 4)
    with pytest.raises(ValueError, match="int32"):
        emit.csr_decode_window(tab.long(), perm, perm, 0, 4)


# -- K7: block-sparse attention ---------------------------------------------

def _attn_inputs(card, plan, BH, dh, dtype, skv=None, seed=0):
    rng = np.random.default_rng(seed)
    skv = plan.seq_len if skv is None else skv

    def t(S):
        x = rng.normal(size=(BH, S, dh)).astype(np.float32)
        return torch.from_numpy(x).to(card, dtype)

    starts, ends = block_windows(plan, device=card)
    return t(plan.seq_len), t(skv), t(skv), starts, ends


def _assert_k7_close(got, want, want_abs_v):
    """K7 against its plain version ``want``, within the kernel's stated
    accuracy (``sparse_attn.BF16_TOL`` / ``F32_TOL``): elementwise
    ``atol + ptol·plain(|v|) + rtol·|want|``, where ``want_abs_v`` is the
    plain version on |v| (bfloat16 rounds P before P·V), and a relative
    RMS limit."""
    tol = tsa.BF16_TOL if want.dtype == torch.bfloat16 else tsa.F32_TOL
    got, want = got.float(), want.float()
    lim = (tol["atol"] + tol["ptol"] * want_abs_v.float()
           + tol["rtol"] * want.abs())
    diff = (got - want).abs()
    assert bool((diff <= lim).all()), float((diff - lim).max())
    assert float(diff.norm()) <= tol["rms"] * float(want.norm())


def _assert_k7_matches_plain(q, k, v, starts, ends, *, bq, bkv, sink_end):
    before = tsa.sparse_attn_bh.launches
    got = tsa.sparse_attn_bh(q, k, v, starts, ends, bq=bq, bkv=bkv,
                             sink_end=sink_end)
    torch.cuda.synchronize()
    assert tsa.sparse_attn_bh.launches == before + 1
    kw = dict(bq=bq, bkv=bkv, sink_end=sink_end)
    want = ref.sparse_attn_bh(q, k, v, starts, ends, **kw)
    want_abs_v = ref.sparse_attn_bh(q, k, v.abs(), starts, ends, **kw)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert bool(torch.isfinite(got.float()).all())
    _assert_k7_close(got, want, want_abs_v)


# (seq, bq, bkv, window, sink blocks, Skv): a Zamba2-like plan, the
# "mean of v" plan (a sink-free window narrower than a q block, so rows
# meet no allowed key) and Skv past Sq; bfloat16 runs on the tensor
# cores, float32 on the CUDA cores
@pytest.mark.parametrize("plan_case", [(1024, 128, 128, 256, 1, None),
                                       (128, 64, 32, 32, 0, None),
                                       (192, 64, 128, 128, 0, 200)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [8, 16, 32, 40, 64, 80, 128, 256])
def test_sparse_attn_kernel_matches_plain(card, dh, dtype, plan_case):
    seq, bq, bkv, window, sink, skv = plan_case
    plan = BlockPlan(seq, bq, bkv, window, sink)
    args = _attn_inputs(card, plan, 3, dh, dtype, skv=skv, seed=dh)
    _assert_k7_matches_plain(*args, bq=bq, bkv=bkv, sink_end=plan.sink_end)


# (seq, bq, bkv, window, sink blocks, sink_end, Skv): ragged S and
# sink_end, bkv != bq both ways, Skv past Sq, a sink-free window
# narrower than a q block (rows that get the mean of v), dh 256
@pytest.mark.parametrize("case", [
    (224, 32, 64, 96, 0, 100, None),
    (2000, 80, 64, 300, 1, 100, None),
    (512, 64, 32, 128, 2, 64, None),
    (512, 32, 128, 200, 1, 128, None),
    (192, 64, 128, 128, 0, 128, 200),
    (128, 64, 32, 32, 0, 0, None),
    (640, 128, 128, 256, 1, 128, None),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_attn_kernel_ragged_and_odd_blocks(card, case, dtype):
    seq, bq, bkv, window, sink, sink_end, skv = case
    plan = BlockPlan(seq, bq, bkv, window, sink)
    dh = 256 if seq == 640 else 40
    args = _attn_inputs(card, plan, 2, dh, dtype, skv=skv, seed=seq)
    _assert_k7_matches_plain(*args, bq=bq, bkv=bkv, sink_end=sink_end)


def test_sparse_attn_kernel_at_the_auditors_shape(card):
    # the JAX auditor's production entry: BH 8, S 2048, dh 128, sink 256
    plan = BlockPlan(2048, 128, 128, 512, 2)
    args = _attn_inputs(card, plan, 8, 128, torch.float32, seed=1)
    _assert_k7_matches_plain(*args, bq=128, bkv=128, sink_end=256)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_attn_batched_fold_matches_plain(card, dtype):
    plan = BlockPlan(256, 32, 32, 64, 1)
    B, H, dh = 2, 3, 32
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, 256, H, dh)).astype(
        np.float32)).to(card, dtype) for _ in range(3))
    starts, ends = block_windows(plan, device=card)
    before = tsa.sparse_attn_bh.launches
    out = tsa.sparse_attn(q, k, v, starts, ends, bq=32, bkv=32,
                          sink_end=plan.sink_end)
    torch.cuda.synchronize()
    assert tsa.sparse_attn_bh.launches == before + 1
    assert out.shape == (B, 256, H, dh)
    for b in range(B):
        for h in range(H):
            qh, kh, vh = (x[b, :, h][None].contiguous() for x in (q, k, v))
            kw = dict(bq=32, bkv=32, sink_end=plan.sink_end)
            want = ref.sparse_attn_bh(qh, kh, vh, starts, ends, **kw)[0]
            want_abs_v = ref.sparse_attn_bh(qh, kh, vh.abs(), starts, ends,
                                            **kw)[0]
            _assert_k7_close(out[b, :, h], want, want_abs_v)


def test_planner_on_the_card_launches_k1_k2_and_equals_cpu(card):
    plan = BlockPlan(8192, 128, 128, 4096, 1)
    sweep.sbm_sweep.launches = emit.twopass_emit.launches = 0
    starts, ends = block_windows(BlockPlan(8192, 128, 128, 4096, 1),
                                 device=card)
    torch.cuda.synchronize()
    assert sweep.sbm_sweep.launches >= 1 and emit.twopass_emit.launches >= 1
    cs, ce = block_windows(plan, device="cpu")
    assert torch.equal(starts.cpu(), cs) and torch.equal(ends.cpu(), ce)


def test_sparse_attn_refused_launch_raises(card):
    # dh = 264 is past the kernel's limit; forced past the wrapper's
    # check, the launch function refuses it and the wrapper raises
    q = torch.zeros((1, 128, 264), dtype=torch.float32, device=card)
    se = torch.zeros(1, dtype=torch.int32, device=card)
    out = torch.empty_like(q)
    with pytest.raises(RuntimeError, match="sparse_attn kernel launch "
                                           "failed"):
        tsa._launch(q, q, q, se, se + 128, out, bq=128, bkv=128, sink_end=0)
    with pytest.raises(ValueError, match="multiple of 8"):
        tsa.sparse_attn_bh(q, q, q, se, se + 128, bq=128, bkv=128)
    with pytest.raises(ValueError, match="float32 or all"):
        tsa.sparse_attn_bh(q[..., :256].contiguous(),
                           q[..., :256].to(torch.bfloat16), q[..., :256],
                           se, se, bq=128)


# ---------------------------------------------------------------------------
# K8: the interval tree walk
# ---------------------------------------------------------------------------

def _itm_case(card, n, b, seed, integer=True, d=1):
    """A tree over n intervals (integer endpoints: tied lo values) and
    b query boxes of d dimensions on the card."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0, 1000, (n, d)).astype(np.float32)
    hi = lo + rng.uniform(0.5, 40, (n, d)).astype(np.float32)
    q_lo = rng.uniform(-20, 1020, (b, d)).astype(np.float32)
    q_hi = q_lo + rng.uniform(0.1, 60, (b, d)).astype(np.float32)
    if integer:
        lo, hi, q_lo = np.floor(lo), np.ceil(hi), np.floor(q_lo)
    R = convert.regions_from_numpy(lo, hi, card)
    return (R, itm.build_tree(R), torch.from_numpy(q_lo).to(card),
            torch.from_numpy(q_hi).to(card))


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("n,b", [(1, 7), (2, 33), (3, 255), (1000, 1000),
                                 (4097, 4099), (100_000, 50_001)])
def test_itm_kernel_matches_plain(card, n, b, integer):
    _, tree, q_lo, q_hi = _itm_case(card, n, b, n + b, integer)
    ql, qh = q_lo[:, 0], q_hi[:, 0]
    want_ids, want = ref.itm_walk(tree, ql, qh)
    before = k8.itm_walk.launches
    ids, got = k8.itm_walk(tree, ql, qh)
    torch.cuda.synchronize()
    assert ids.shape == want_ids.shape == (b, 0)
    assert k8.itm_walk.launches == before + 1
    assert torch.equal(got, want)
    top = int(want.max())
    for cap in sorted({1, max(top // 2, 1), max(top, 1), top + 3}):
        ids, got = k8.itm_walk(tree, ql, qh, cap)
        want_ids, want = ref.itm_walk(tree, ql, qh, cap)
        assert torch.equal(ids, want_ids) and torch.equal(got, want), cap
    # a caller's order, any permutation of the queries, changes no result
    perm = torch.randperm(b, generator=torch.Generator().manual_seed(b))
    ids, got = k8.itm_walk(tree, ql, qh, cap, perm.to(card, torch.int32))
    assert torch.equal(ids, want_ids) and torch.equal(got, want)
    assert k8.itm_walk.launches == before + 2 + len(
        {1, max(top // 2, 1), max(top, 1), top + 3})


def test_itm_kernel_zero_queries_and_strided_queries(card):
    R, tree, q_lo, q_hi = _itm_case(card, 500, 300, 1, d=2)
    before = k8.itm_walk.launches
    ids, cnt = k8.itm_walk(tree, q_lo[:0, 0], q_hi[:0, 0], 4)
    assert ids.shape == (0, 4) and cnt.shape == (0,)
    assert k8.itm_walk.launches == before
    # the columns of (b, 2) queries: stride 2, read without a copy
    ids, cnt = k8.itm_walk(tree, q_lo[:, 0], q_hi[:, 0], 16)
    want = ref.itm_walk(tree, q_lo[:, 0].contiguous(),
                        q_hi[:, 0].contiguous(), 16)
    assert torch.equal(ids, want[0]) and torch.equal(cnt, want[1])
    # the d = 2 query path: K8, then the gathers of dimension 1
    got = ops.itm_query_pairs_dd_cuda(tree, R.lo, R.hi, q_lo, q_hi, 64)
    want = itm.itm_query_pairs_dd(tree, R.lo, R.hi, q_lo, q_hi, 64)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("regime", [None, "cta"])
def test_itm_kernel_rows_past_2_31_slots(card, regime):
    # b * cap = 262,145 * 8192 > 2^31: the last rows sit past slot 2^31
    # (None: the rule's regime at this b, the thread regime)
    b, cap = 262_145, 8192
    _, tree, q_lo, q_hi = _itm_case(card, 2000, b, 5)
    ql, qh = q_lo[:, 0], q_hi[:, 0]
    ids, cnt = k8.itm_walk(tree, ql, qh, cap, _regime=regime)
    torch.cuda.synchronize()
    assert ids.shape == (b, cap) and b * cap > 2 ** 31
    assert torch.equal(cnt, ref.itm_walk(tree, ql, qh)[1])
    tail_ids, tail_cnt = ref.itm_walk(tree, ql[-16:], qh[-16:], cap)
    assert int(tail_cnt.sum()) > 0
    assert torch.equal(ids[-16:], tail_ids)
    assert torch.equal(ids[:16], ref.itm_walk(tree, ql[:16], qh[:16],
                                              cap)[0])
    del ids


def test_itm_kernel_rejects_bad_tensors(card):
    _, tree, q_lo, q_hi = _itm_case(card, 100, 10, 2)
    ql, qh = q_lo[:, 0], q_hi[:, 0]
    with pytest.raises(ValueError, match="float32"):
        k8.itm_walk(tree, ql.double(), qh.double())
    with pytest.raises(ValueError, match="tree.lo"):
        k8.itm_walk(tree._replace(lo=tree.lo.double()), ql, qh)
    with pytest.raises(ValueError, match="tree.ids"):
        k8.itm_walk(tree._replace(ids=tree.ids.long()), ql, qh)
    with pytest.raises(ValueError, match="tree.hi"):
        k8.itm_walk(tree._replace(hi=tree.hi.cpu()), ql, qh)
    with pytest.raises(ValueError, match="q_hi"):
        k8.itm_walk(tree, ql, qh.cpu())
    cut = itm.ITree(*(x[:6] for x in tree))
    with pytest.raises(ValueError, match="power of two"):
        k8.itm_walk(cut, ql, qh)
    with pytest.raises(ValueError, match="cap must be"):
        k8.itm_walk(tree, ql, qh, -1)
    with pytest.raises(ValueError, match="match in shape"):
        k8.itm_walk(tree, ql, qh[:5])
    order = k8.query_order(ql)
    for bad in (order.long(), order[:5], order.cpu(), order.repeat(2)[::2]):
        with pytest.raises(ValueError, match="order must be"):
            k8.itm_walk(tree, ql, qh, 0, bad)


@pytest.mark.parametrize("per_cta", [0, 1])
def test_itm_refused_launch_raises(card, per_cta):
    # a tree length past the kernel's limit, forced past the wrapper's
    # checks: the launch function refuses it, in either regime, and the
    # wrapper raises; so does a regime that is neither
    _, tree, q_lo, _ = _itm_case(card, 10, 4, 3)
    lib = _build.load("itm_walk")
    cnt = torch.empty(4, dtype=torch.int32, device=card)
    order = k8.query_order(q_lo[:, 0])
    for m, regime in ((6, per_cta), (7, per_cta + 2)):
        rc = _build.launch(card, lib.itm_walk_launch, tree.lo.data_ptr(),
                           tree.hi.data_ptr(), tree.minlower.data_ptr(),
                           tree.maxupper.data_ptr(), tree.ids.data_ptr(), m,
                           q_lo.data_ptr(), q_lo.data_ptr(), 1,
                           order.data_ptr(), 4, 0, None, cnt.data_ptr(),
                           regime)
        with pytest.raises(RuntimeError,
                           match="itm_walk kernel launch failed"):
            _build.check(lib, "itm_walk", rc)


def _both_regimes(tree, ql, qh, caps):
    """K8 in each regime against the plain walk, count instance and each
    cap's pairs instance: one launch a call, the CTA ones counted."""
    want = {cap: ref.itm_walk(tree, ql, qh, cap) for cap in caps}
    for regime in k8.REGIMES:
        before = (k8.itm_walk.launches, k8.itm_walk.cta_launches)
        for cap in caps:
            ids, got = k8.itm_walk(tree, ql, qh, cap, _regime=regime)
            torch.cuda.synchronize()
            assert torch.equal(got, want[cap][1]), (regime, cap)
            assert torch.equal(ids, want[cap][0]), (regime, cap)
        calls = len(caps)
        assert (k8.itm_walk.launches, k8.itm_walk.cta_launches) == (
            before[0] + calls, before[1] + calls * (regime == "cta"))
    return want


@pytest.mark.parametrize("b", [1, 63, 64, 65, "sms", "sms+1", 50_001])
def test_itm_kernel_regimes_match_plain(card, b):
    # both regimes on the same inputs, on either side of the rule's
    # boundary (b = the card's SM count); strided columns of (b, 2) boxes
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    b = {"sms": sms, "sms+1": sms + 1}.get(b, b)
    assert k8.regime(sms, sms) == "cta" and k8.regime(sms + 1, sms) == "thread"
    _, tree, q_lo, q_hi = _itm_case(card, 20_000, b, b, d=2)
    ql, qh = q_lo[:, 0], q_hi[:, 0]
    assert ql.stride(0) == 2
    top = int(ref.itm_walk(tree, ql, qh)[1].max())
    _both_regimes(tree, ql, qh, sorted({0, 1, max(top // 2, 1), max(top, 1),
                                        top + 3}))
    before = k8.itm_walk.cta_launches
    k8.itm_walk(tree, ql, qh)
    assert k8.itm_walk.cta_launches == before + (b <= sms)


def test_itm_kernel_regimes_on_padded_batches_and_one_node(card):
    # serving's batches: the sentinel rows of pad_boxes prune at the root
    from types import SimpleNamespace
    from repro_torch.serve import batching
    _, tree, q_lo, q_hi = _itm_case(card, 5000, 40, 17)
    reqs = [SimpleNamespace(lo=q_lo[i].cpu().numpy(), hi=q_hi[i].cpu().numpy())
            for i in range(40)]
    blo, bhi = batching.pad_boxes(reqs, 1, 64)
    ql = torch.from_numpy(blo[:, 0]).to(card)
    qh = torch.from_numpy(bhi[:, 0]).to(card)
    want = _both_regimes(tree, ql, qh, [0, 3, 512])
    assert int(want[0][1][40:].abs().sum()) == 0
    assert int(want[0][1][:40].sum()) > 0
    # a one-node tree (n = 1, M = 1): the root is the only leaf
    _, tree1, q_lo, q_hi = _itm_case(card, 1, 64, 18)
    assert tree1.lo.numel() == 2
    want = _both_regimes(tree1, q_lo[:, 0], q_hi[:, 0], [0, 1, 2])
    assert 0 < int(want[0][1].sum()) < 64


def test_itm_kernel_regimes_on_a_2_19_node_tree_at_cap_8192(card):
    # 2^19 - 1 intervals (a full 2^19-node tree), boxes up to 40,000 wide:
    # the widest pass the CTA regime's 12,288-entry list (open subtrees
    # walked) and the 8192-id cap (rows cut, counts going on)
    rng = np.random.default_rng(19)
    n = (1 << 19) - 1
    lo = rng.uniform(0, 1e6, n).astype(np.float32)
    hi = lo + rng.uniform(1, 50, n).astype(np.float32)
    tree = itm.build_tree(convert.regions_from_numpy(lo, hi, card))
    assert tree.lo.numel() == 1 << 19
    b = 64
    q_lo = rng.uniform(0, 9.6e5, b).astype(np.float32)
    width = np.geomspace(1, 40_000, b).astype(np.float32)
    ql = torch.from_numpy(q_lo).to(card)
    qh = torch.from_numpy(q_lo + width).to(card)
    want = _both_regimes(tree, ql, qh, [0, 8192])
    counts = want[0][1]
    assert int(counts.max()) > 12_288 and int((counts > 8192).sum()) > 1


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("capacity", ["exact", "fixed", "grow"])
def test_itm_cuda_backend_equals_torch_backend(card, capacity, d):
    S, U = paper_workload(11, 20_000, 50.0, d=d, device=card)
    out = {}
    for backend in ("cuda", "torch"):
        k8.itm_walk.launches = 0
        plan = build_plan(MatchSpec(algo="itm", backend=backend,
                                    capacity=capacity, max_pairs=999),
                          S.n, U.n, d)
        res, kp = plan.pairs(S, U)
        tree = itm.build_tree(S)
        ids, cnt = plan.query(tree, S, U.lo[:300], U.hi[:300])
        out[backend] = (plan.count(S, U), kp, res.data, ids, cnt,
                        k8.itm_walk.launches)
    c, t = out["cuda"], out["torch"]
    assert c[:2] == t[:2]
    for a, b in zip(c[2:5], t[2:5]):
        assert torch.equal(a, b)
    assert c[5] >= 3 and t[5] == 0


def test_ddm_service_on_the_card_equals_the_cpu(card):
    S, U = paper_workload(2, 20_000, 5.0, d=2, device="cpu")
    rng = np.random.default_rng(0)
    svcs = [DDMService(S, U, spec=MatchSpec(algo="itm", capacity="grow",
                                            device=dev))
            for dev in ("cuda", "cpu")]
    k8.itm_walk.launches = 0
    assert svcs[0].connect() == svcs[1].connect()
    for tick in range(4):
        kind = "sub" if tick % 2 == 0 else "upd"
        idx = rng.choice(S.n, 500, replace=False)
        lo = rng.uniform(0, 9e5, (500, 2)).astype(np.float32)
        hi = lo + rng.uniform(1.0, 5e3, (500, 2)).astype(np.float32)
        assert (svcs[0].update_regions(kind, idx, lo, hi)
                == svcs[1].update_regions(kind, idx, lo, hi))
    assert svcs[0].pairs == svcs[1].pairs
    assert k8.itm_walk.launches >= 10


def test_distributed_backend_on_nccl_equals_the_cuda_backend(card, tmp_path):
    """The distributed backend on a NCCL group of world size 1: count,
    pairs (d = 1 and 2) and query equal the cuda backend's, bit for bit,
    through K1, K2 and K8."""
    import datetime
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120))
    try:
        before = (sweep.sbm_sweep.launches, emit.twopass_emit.launches,
                  k8.itm_walk.launches)
        for d in (1, 2):
            S, U = paper_workload(4, 40_000, 20.0 * d, d=d, device=card)
            want = build_plan(MatchSpec(device=card), S.n, U.n, d)
            for capacity, mp in (("exact", None), ("fixed", 1000),
                                 ("grow", 4)):
                plan = build_plan(MatchSpec(backend="distributed",
                                            capacity=capacity, max_pairs=mp,
                                            device=card), S.n, U.n, d)
                res, k = plan.pairs(S, U)
                wres, wk = build_plan(
                    MatchSpec(capacity=capacity, max_pairs=mp, device=card),
                    S.n, U.n, d).pairs(S, U)
                assert k == wk == want.count(S, U) == plan.count(S, U)
                assert torch.equal(res.to_dense(), wres.data), capacity
            tree = itm.build_tree(U)
            q = dict(algo="itm", capacity="grow", max_pairs=8, device=card)
            ids, cnt = build_plan(MatchSpec(backend="distributed", **q),
                                  S.n, U.n, d).query(tree, U, S.lo, S.hi)
            wids, wcnt = build_plan(MatchSpec(**q), S.n, U.n, d).query(
                tree, U, S.lo, S.hi)
            assert torch.equal(ids, wids) and torch.equal(cnt, wcnt)
        torch.cuda.synchronize()
        after = (sweep.sbm_sweep.launches, emit.twopass_emit.launches,
                 k8.itm_walk.launches)
        assert all(a > b for a, b in zip(after, before)), (before, after)
    finally:
        dist.destroy_process_group()


def test_distributed_gloo_p4_spawn_on_this_torch(card, tmp_path):
    """Four spawned gloo ranks on this host's torch (the CPU suite runs the
    same ranks against the JAX package, which this host lacks): every rank
    agrees, P = 4 and 2 give P = 1's K and, where lows are distinct, its
    buffer; cap_dev shrinks with P; overflow raises at the smallest
    overprovision tried and not at the largest."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    ranks = [ctx.Process(target=dist_cases.port_worker,
                         args=(r, 4, str(tmp_path / "store"),
                               str(tmp_path))) for r in range(4)]
    for p in ranks:
        p.start()
    for p in ranks:
        p.join(240)
    alive = [p.is_alive() for p in ranks]
    for p in ranks:
        if p.is_alive():
            p.kill()
    assert not any(alive) and [p.exitcode for p in ranks] == [0] * 4
    out = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(4)]
    K = dist_cases.key
    for P in (2, 4):
        for r in range(P):
            for k in (k for k in out[0] if k.startswith(f"P{P}:")):
                np.testing.assert_array_equal(out[r][k], out[0][k])
        for case, pol in dist_cases.RUNS:
            got = out[0][K(f"P{P}", case, pol, "buf")]
            want = out[0][K("P1", case, pol, "buf")]
            assert (out[0][K(f"P{P}", case, pol, "K")]
                    == out[0][K("P1", case, pol, "K")])
            if case in dist_cases.TIED:
                assert got.shape == want.shape
            else:
                np.testing.assert_array_equal(got, want)
        ops = dist_cases.OVERPROVISIONS
        for path in ("count", "pairs"):
            assert out[0][K(f"P{P}", "ovf", path, min(ops))] == 1
            assert out[0][K(f"P{P}", "ovf", path, max(ops))] == 0
    caps = [int(out[0][K(f"P{P}", "d1", "exact", "cap_dev")])
            for P in (1, 2, 4)]
    assert caps[2] < caps[1] < caps[0], caps
    assert out[0][K("P4", "all_overlap", "K")] == dist_cases.ALL_OVERLAP_N ** 2
    assert out[0][K("P4", "clustered", "K")] == 0


def test_auditor_on_the_card_captures_every_kernel_and_refuses_a_launch(card):
    """``run_all(device="cuda")``: every kernel-matrix entry captured at
    its production shapes, K1-K8's entry points all launched, no error
    finding; the corpus's over-budget wrapper is flagged as
    ``K_SMEM_BUDGET`` and refused before its launch runs."""
    from pathlib import Path

    from repro_torch.analysis import run_all
    from repro_torch.analysis.corpus import run_corpus

    report = run_all(device="cuda")
    assert report.ok(), report.summary()
    assert report.kernel_entries and all(report.kernel_entries.values())
    captured = {e for v in report.kernel_entries.values() for e in v}
    assert {"sbm_sweep_launch", "twopass_emit_launch",
            "bfm_tile_counts_launch", "bfm_mask_launch",
            "emit_stream_launch", "csr_decode_launch", "sparse_attn_launch",
            "itm_walk_launch"} <= captured
    assert not report.not_run
    corpus = Path(__file__).resolve().parent / "torch_analysis_corpus"
    results = run_corpus(corpus, device="cuda")
    assert results and all(r.ran and r.ok for r in results), results
    refused = [r for r in results
               if r.name == "over_budget_wrapper_on_the_card"]
    assert refused and refused[0].got_codes == ("K_SMEM_BUDGET",)
