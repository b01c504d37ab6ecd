"""K6's tile algorithm, transcribed to numpy and held to the plain decode.

``csrc/csr_decode.cu`` decodes a window of the pass-2 buffer one tile
of ``CSR_TILE`` slots per CTA: two warps find the tile's first and last
entries, k0 and k1, by a 32-ary search of the packed offsets; a tile of
at most ``CSR_WMAX`` entries stages them, scatters each entry's first
slot into an owner array by atomicMax and max-scans it (per thread,
then per warp by shuffles, then across warps); a larger tile
binary-searches per slot within [k0, k1].  The card cannot be reached
here, so ``decode_tiles`` below follows the kernel step by step and is
held against ``ref.csr_decode_window`` (the port's plain decode) and the
JAX package's dense pass 2 (``repro.core.sbm._twopass_emit``) on the
packed tables the card tests use: the saturated ``paper_workload`` and
ties tables, an emitter whose count spans several tiles, count-1
emitters, windows that start and end mid-tile, 1-slot windows, windows
reaching into ``[K, max_pairs)`` and past ``max_pairs``, and offsets
saturated at INT32_MAX.  A small tile (256 slots) reaches the per-slot
path at these sizes; the kernel's own tile reaches it on the largest
table.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import sbm as jsbm  # noqa: E402

from torch_emit_tables import zero_run_tables  # noqa: E402

from repro_torch.core import paper_workload  # noqa: E402
from repro_torch.core import sbm as tsbm  # noqa: E402
from repro_torch.kernels import emit, ref  # noqa: E402

INT32_MAX = 2 ** 31 - 1
PER = 8          # owner entries a thread scans (csr_decode.cu: PER)
WARP = 32
KERNEL = (emit.CSR_TILE, emit.CSR_WMAX)
SMALL = (256, 257)


def search_warp(offs, lo, hi, t):
    """The kernel's 32-ary warp search: the last k in [lo, hi] with
    offs[k] <= t, or lo if there is none."""
    lanes = np.arange(WARP)
    while True:
        span = hi - lo + 1
        stride = 1 if span <= WARP else -(-span // WARP)
        p = lo + lanes * stride
        le = (p <= hi) & (offs[np.minimum(p, hi)] <= t)
        # the ballot is a prefix of the lanes: offs never decreases
        assert not (le[1:] & ~le[:-1]).any()
        if not le.any():
            assert lo == 0            # only at the first level
            return lo
        last = lo + int(np.flatnonzero(le)[-1]) * stride
        if stride == 1:
            return last
        lo, hi = last, min(last + stride - 1, hi)


def search_thread(offs, lo, hi, t):
    """The per-slot binary search in [lo, hi], over a vector of slots."""
    lo = np.full(t.shape, lo, np.int64)
    hi = np.full(t.shape, hi, np.int64)
    while (lo < hi).any():
        live = lo < hi
        mid = (lo + hi + 1) >> 1
        le = offs[mid] <= t
        lo = np.where(live & le, mid, lo)
        hi = np.where(live & ~le, mid - 1, hi)
    return lo


def slot_pairs(t, off, cnt, start, e, n, perm_s, perm_u):
    j = t.astype(np.int64) - off
    valid = (j >= 0) & (j < cnt)
    r = np.where(valid, start + j, 0)
    is_a = e < n
    part = np.where(is_a, perm_u[np.minimum(r, perm_u.size - 1)],
                    perm_s[np.minimum(r, perm_s.size - 1)])
    s = np.where(is_a, e, part)
    u = np.where(is_a, part, e - n)
    return np.stack([np.where(valid, s, -1), np.where(valid, u, -1)],
                    1).astype(np.int32)


def max_scan(owner, block):
    """The kernel's inclusive max-scan: PER entries a thread, a shuffle
    scan of the thread totals per warp, then the warps' totals."""
    v = np.maximum.accumulate(owner.reshape(block, PER), axis=1)
    run = v[:, -1].reshape(block // WARP, WARP)
    lane = np.arange(WARP)
    o = 1
    while o < WARP:
        y = np.roll(run, o, axis=1)           # __shfl_up_sync by o
        run = np.where(lane >= o, np.maximum(run, y), run)
        o <<= 1
    before = np.where(lane == 0, 0, np.roll(run, 1, axis=1))
    warp_tot = run[:, -1]
    prev = np.concatenate([[0], np.maximum.accumulate(warp_tot)[:-1]])
    before = np.maximum(before, prev[:, None]).reshape(block)
    return np.maximum(v, before[:, None]).reshape(-1)


def decode_tiles(tab, perm_s, perm_u, w0, nslots, tile, wmax):
    """Slots [w0, w0 + nslots) as the kernel computes them; also the
    number of tiles that took the per-slot path."""
    offs = tab[0]
    e_pad = tab.shape[1]
    n = perm_s.size
    block = tile // PER
    out = np.empty((nslots, 2), np.int32)
    per_slot = 0
    for i0 in range(0, nslots, tile):
        nt = min(tile, nslots - i0)
        t0 = w0 + i0
        k0 = search_warp(offs, 0, e_pad - 1, t0)
        k1 = search_warp(offs, 0, e_pad - 1, t0 + nt - 1)
        t = np.arange(t0, t0 + nt, dtype=np.int64)
        if k1 - k0 + 1 <= wmax:
            win = tab[:, k0:k1 + 1].astype(np.int64)
            owner = np.zeros(tile, np.int64)
            pos = win[0, 1:] - t0
            assert ((pos >= 1) & (pos < nt)).all()
            np.maximum.at(owner, pos, np.arange(1, win.shape[1]))
            x = max_scan(owner, block)[:nt]
            out[i0:i0 + nt] = slot_pairs(t, win[0, x], win[1, x], win[2, x],
                                         win[3, x], n, perm_s, perm_u)
        else:
            per_slot += 1
            k = search_thread(offs, k0, k1, t)
            out[i0:i0 + nt] = slot_pairs(t, offs[k], tab[1, k], tab[2, k],
                                         tab[3, k], n, perm_s, perm_u)
    return out, per_slot


def _ties(n=3000, m=2500, seed=0):
    """The ties table of the card tests (test_torch_cuda.py:_ties)."""
    rng = np.random.default_rng(seed)
    s_lo = rng.integers(0, 500, n).astype(np.float32)
    s_hi = s_lo + rng.integers(0, 20, n).astype(np.float32)
    u_lo = rng.integers(0, 500, m).astype(np.float32)
    u_hi = u_lo + rng.integers(0, 20, m).astype(np.float32)
    return [s_lo, s_hi, u_lo, u_hi]


def _paper(alpha):
    S, U = paper_workload(4, 60_000, alpha, device="cpu")
    return [x[:, 0].numpy() for x in (S.lo, S.hi, U.lo, U.hi)]


def _wide():
    """50 subscriptions over all 6000 updates: counts of 6000 slots."""
    rng = np.random.default_rng(1)
    s_lo = rng.uniform(0, 1, 50).astype(np.float32)
    u_lo = rng.uniform(1, 2, 6000).astype(np.float32)
    return [s_lo, s_lo + 3, u_lo, u_lo + 3]


def _ones():
    """5000 disjoint matched pairs: every emitter has count 1."""
    lo = 2 * np.arange(5000, dtype=np.float32)
    return [lo, lo + 1, lo.copy(), lo + 1]


CASES = {"paper_a50": lambda: _paper(50.0), "paper_a0.5": lambda: _paper(0.5),
         "ties": _ties, "wide": _wide, "ones": _ones}


@functools.lru_cache(maxsize=None)
def _tables(case, max_pairs):
    arrs = CASES[case]()
    n, m = arrs[0].size, arrs[2].size
    perm_s, perm_u, starts, counts, offs = tsbm._twopass_phase1(
        *[torch.from_numpy(a.copy()) for a in arrs], max_pairs)[:5]
    tab = emit.pack_emitter_tables(offs, counts, starts, n=n, m=m)
    dense = np.asarray(jsbm._twopass_emit(
        *[jnp.asarray(a) for a in arrs], max_pairs=max_pairs)[0])
    return tab, perm_s, perm_u, dense


@functools.lru_cache(maxsize=None)
def _k(case):
    arrs = [torch.from_numpy(a.copy()) for a in CASES[case]()]
    counts = tsbm._twopass_phase1(*arrs, 1)[3]
    return int(counts.sum(dtype=torch.int64))


def _windows(cap, tile, rng):
    """Windows (w0, nslots) of the edge cases, all inside int32."""
    t = tile
    wins = {(0, 1), (cap - 1, 1), (t // 2 + 3, 3 * t + 5),
            (max(cap - 2 * t - 7, 0), min(cap, 2 * t + 7)),   # ends at cap
            (max(cap - t // 2, 0), 2 * t + 1),                # straddles cap
            (cap + 5, t + 3)}                                 # past cap
    for _ in range(3):
        w0 = int(rng.integers(0, cap))
        wins.add((w0, int(rng.integers(1, 3 * t))))
    return sorted(wins)


@pytest.mark.parametrize("tiling", [KERNEL, SMALL], ids=["kernel", "small"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_decode_equals_plain_and_reference(case, tiling):
    tile, wmax = tiling
    k = _k(case)
    rng = np.random.default_rng(7)
    saturated_per_slot = 0
    for cap in sorted({1, max(k // 3, 1), k, k + 100}):
        tab, perm_s, perm_u, dense = _tables(case, cap)
        tab_np, ps, pu = tab.numpy(), perm_s.numpy(), perm_u.numpy()
        for w0, nsl in _windows(cap, tile, rng):
            got, per_slot = decode_tiles(tab_np, ps, pu, w0, nsl, tile, wmax)
            want = ref.csr_decode_window(tab, perm_s, perm_u, w0, nsl)
            np.testing.assert_array_equal(got, want.numpy(),
                                          err_msg=f"{cap} {w0} {nsl}")
            stop = min(w0 + nsl, cap)
            if w0 < stop:
                np.testing.assert_array_equal(got[:stop - w0],
                                              dense[w0:stop])
            if cap < k:
                saturated_per_slot += per_slot
            else:
                assert per_slot == 0    # strictly rising offsets: staged
    # a tile that reaches max_pairs from below selects every saturated
    # entry; past 257 of them (thousands in these two tables) the small
    # tile searches per slot
    if tiling == SMALL and case in ("paper_a50", "ties"):
        assert saturated_per_slot > 0


def test_kernel_tile_reaches_the_per_slot_path():
    """On the 60,000-region table at max_pairs = K // 3 (the card tests'
    saturated case), the tile that reaches max_pairs selects about 2e4
    saturated entries, more than CSR_WMAX: the kernel's per-slot path."""
    k = _k("paper_a50")
    cap = k // 3
    tab, perm_s, perm_u, dense = _tables("paper_a50", cap)
    w0 = cap - emit.CSR_TILE // 2
    got, per_slot = decode_tiles(tab.numpy(), perm_s.numpy(), perm_u.numpy(),
                                 w0, 3 * emit.CSR_TILE, *KERNEL)
    assert per_slot >= 1
    np.testing.assert_array_equal(
        got, ref.csr_decode_window(tab, perm_s, perm_u, w0,
                                   3 * emit.CSR_TILE).numpy())
    np.testing.assert_array_equal(got[:cap - w0], dense[w0:cap])


@pytest.mark.parametrize("kind", ["strict", "repeats", "pads", "late_start"])
def test_search_warp_is_searchsorted(kind):
    rng = np.random.default_rng(len(kind))
    steps = rng.integers(1, 40, 5000)
    if kind == "repeats":
        steps[rng.random(5000) < 0.6] = 0
    offs = np.cumsum(steps) - steps[0]
    if kind == "late_start":
        offs = offs + 100
    if kind == "pads":
        offs[3000:] = INT32_MAX
    offs = offs.astype(np.int64)
    for t in [0, 1, 99, 100, 101, *rng.integers(0, offs[2999] + 50, 200),
              INT32_MAX - 1]:
        want = max(int(np.searchsorted(offs, t, side="right")) - 1, 0)
        assert search_warp(offs, 0, offs.size - 1, int(t)) == want
        assert int(search_thread(offs, 0, offs.size - 1,
                                 np.array([t]))[0]) == want


@pytest.mark.parametrize("n_reg,cap", [(40_000, None), (50_000, INT32_MAX)])
def test_tile_decode_above_2_30_and_at_the_int32_cap(n_reg, cap):
    """All-overlapping regions, every emitter's run 40,000-50,000 slots
    long.  At n = m = 40,000 (K = 1.6e9) the last emitters' slots lie
    above 2^30; at 50,000 (K = 2.5e9 > INT32_MAX) the cap INT32_MAX
    saturates the offsets of the last emitters at the pads' INT32_MAX,
    the repeated-offset case of the Koln windows."""
    rng = np.random.default_rng(12)
    s_lo = rng.uniform(0, 1, n_reg).astype(np.float32)
    u_lo = rng.uniform(1, 2, n_reg).astype(np.float32)
    arrs = [torch.from_numpy(a) for a in (s_lo, s_lo + 3, u_lo, u_lo + 3)]
    K = n_reg * n_reg
    cap = K if cap is None else cap
    perm_s, perm_u, starts, counts, offs = tsbm._twopass_phase1(*arrs,
                                                                cap)[:5]
    tab = emit.pack_emitter_tables(offs, counts, starts, n=n_reg, m=n_reg)
    last = int(offs[n_reg - 1]) if cap == K else int(
        tab[0][tab[0] < INT32_MAX].max())
    for w0, stop in ((last - 1000, last + 3000), (cap - 3000, cap),
                     ((1 << 30) - 7, (1 << 30) + 2100)):
        got, per_slot = decode_tiles(tab.numpy(), perm_s.numpy(),
                                     perm_u.numpy(), w0, stop - w0, *KERNEL)
        want = tsbm._twopass_window(offs, counts, starts, perm_s, perm_u,
                                    w0, stop)
        assert per_slot == 0 and bool((want >= 0).all())
        np.testing.assert_array_equal(got, want.numpy(), err_msg=str(w0))
        np.testing.assert_array_equal(
            got, ref.csr_decode_window(tab, perm_s, perm_u, w0,
                                       stop - w0).numpy())


# -- K2 and K5: the tile decode of csrc/emit_tile.cuh -----------------------

EMIT_BLOCK = 256        # emit_tile.cuh: BLOCK
SMS = 132               # an H100's SMs, for K2's tile rule


class Uncompacted:
    """K2's tables: entry k is emitter k, entry E the count-0 sentinel."""

    def __init__(self, offs, counts, starts):
        self.offs = offs.astype(np.int64)
        self.E = counts.size
        self.cnt = np.append(counts, 0).astype(np.int64)
        self.start = np.append(starts, 0).astype(np.int64)
        self.id = np.arange(self.E + 1, dtype=np.int64)


class Packed:
    """K5's packed table: rows offset, count, start, id."""

    def __init__(self, tab):
        self.offs, self.cnt, self.start, self.id = tab.astype(np.int64)


def k2_tile(max_pairs, sms=SMS):
    """emit.cu's pick_tile: the largest of 4096, 2048, ..., 256 slots
    whose grid gives every SM 4 CTAs."""
    T = emit.EMIT_TILE_MAX
    while T > emit.EMIT_TILE_MIN and -(-max_pairs // T) < (
            emit.EMIT_CTAS_PER_SM * sms):
        T //= 2
    return T


def register_scan(cells, nt):
    """The kernel's max-scan of cells[0, nt): PER cells a thread in
    registers, a shuffle scan of the thread totals per warp, then the
    warps' totals and the passes before; BLOCK·PER cells a pass.  Cells
    past nt hold whatever they held; they only raise cells past nt."""
    T = cells.size
    cells = cells.copy()
    lane = np.arange(32)
    carry = 0
    for c0 in range(0, nt, EMIT_BLOCK * PER):
        v = np.zeros(EMIT_BLOCK * PER, np.int64)
        mine = min(T - c0, EMIT_BLOCK * PER)     # threads with lo < T
        v[:mine] = cells[c0:c0 + mine]
        v = np.maximum.accumulate(v.reshape(EMIT_BLOCK, PER), axis=1)
        run = v[:, -1].reshape(EMIT_BLOCK // WARP, WARP)
        o = 1
        while o < WARP:
            y = np.roll(run, o, axis=1)           # __shfl_up_sync by o
            run = np.where(lane >= o, np.maximum(run, y), run)
            o <<= 1
        before = np.where(lane == 0, 0, np.roll(run, 1, axis=1))
        warp_tot = run[:, -1]
        prev = np.concatenate([[0], np.maximum.accumulate(warp_tot)[:-1]])
        before = np.maximum(np.maximum(before, prev[:, None]), carry)
        v = np.maximum(v, before.reshape(-1, 1)).reshape(-1)
        cells[c0:c0 + mine] = v[:mine]
        carry = max(carry, int(warp_tot.max()))
    return cells


def emit_tile(tb, perm_s, perm_u, max_pairs, tile, T, rng):
    """One tile as emit_tiles_kernel writes it, and its path: "staged"
    (at most EMIT_WMAX entries), "streamed" (read through L1) or
    "per_slot" (a span past EMIT_PERSLOT_SPAN tiles)."""
    n = perm_s.size
    t0 = tile * T
    nt = min(T, max_pairs - t0)
    hi = tb.offs.size - 1
    k0 = search_warp(tb.offs, 0, hi, t0)
    k1 = search_warp(tb.offs, 0, hi, t0 + nt - 1)
    W = k1 - k0 + 1
    t = np.arange(t0, t0 + nt, dtype=np.int64)
    if W > emit.EMIT_PERSLOT_SPAN * T:
        k = search_thread(tb.offs, k0, k1, t)
        return slot_pairs(t, tb.offs[k], tb.cnt[k], tb.start[k], tb.id[k],
                          n, perm_s, perm_u), "per_slot"
    # the owner array's cells past nt are stale shared memory
    cells = rng.integers(0, 1 << 31, T)
    cells[:nt] = 0
    x = np.arange(1, W)
    o = tb.offs[k0 + x]
    nxt = tb.offs[np.minimum(k0 + x + 1, k1)]
    last = (x == W - 1) | (nxt != o)         # the last entry of each run
    pos = o[last] - t0
    assert ((pos >= 1) & (pos < nt)).all()
    assert np.unique(pos).size == pos.size   # plain stores: one per cell
    cells[pos] = x[last]
    k = k0 + register_scan(cells, nt)[:nt]
    path = "staged" if W <= emit.EMIT_WMAX else "streamed"
    return slot_pairs(t, tb.offs[k], tb.cnt[k], tb.start[k], tb.id[k], n,
                      perm_s, perm_u), path


def emit_tiles(tb, perm_s, perm_u, max_pairs, T, *, tiles=None):
    """Slots of ``tiles`` (default all), one CTA per tile: {tile: rows}
    and the number of tiles that took each path."""
    rng = np.random.default_rng(max_pairs)
    rows, paths = {}, {"staged": 0, "streamed": 0, "per_slot": 0}
    for tile in range(-(-max_pairs // T)) if tiles is None else tiles:
        rows[tile], path = emit_tile(tb, perm_s, perm_u, max_pairs, tile,
                                     T, rng)
        paths[path] += 1
    return rows, paths


def _join(rows):
    return np.concatenate([rows[t] for t in sorted(rows)])


def _regions(alpha, n_total):
    S, U = paper_workload(42, n_total, alpha, device="cpu")
    return [x[:, 0].numpy() for x in (S.lo, S.hi, U.lo, U.hi)]


# fig. 12's overlap sweep at N = 1e6 (alpha 1: K = 489,667 and tiles of
# several thousand entries; alpha 0.01: K = 10,449, tiles of 1e5 and
# more), fig. 9's alpha at a cut N, and the ties table
EMIT_CASES = {"a100": lambda: _regions(100.0, 6_000),
              "a1": lambda: _regions(1.0, 1_000_000),
              "a0.01": lambda: _regions(0.01, 1_000_000), "ties": _ties}


@functools.lru_cache(maxsize=None)
def _emit_k(case):
    arrs = [torch.from_numpy(a.copy()) for a in EMIT_CASES[case]()]
    return int(tsbm._twopass_phase1(*arrs, 1)[3].sum(dtype=torch.int64))


def _emit_caps(k):
    """max_pairs: 1, K // 3, an odd cap, K and K + 100."""
    return sorted({1, max(k // 3, 1), 2 * (k // 4) + 1, k, k + 100})


@functools.lru_cache(maxsize=None)
def _emit_dense(case):
    """The JAX package's dense pass 2 at max_pairs = K + 100; a buffer of
    max_pairs <= K + 100 slots is its prefix."""
    arrs = EMIT_CASES[case]()
    return np.asarray(jsbm._twopass_emit(
        *[jnp.asarray(a) for a in arrs], max_pairs=_emit_k(case) + 100)[0])


def _emit_tables(case, max_pairs):
    arrs = EMIT_CASES[case]()
    n, m = arrs[0].size, arrs[2].size
    perm_s, perm_u, starts, counts, offs = tsbm._twopass_phase1(
        *[torch.from_numpy(a.copy()) for a in arrs], max_pairs)[:5]
    tab = emit.pack_emitter_tables(offs, counts, starts, n=n, m=m,
                                   min_len=emit.stream_window(2048))
    return (offs, counts, starts, perm_s, perm_u), tab


@pytest.mark.parametrize("case", sorted(EMIT_CASES))
def test_emit_tile_decode_equals_plain_and_reference(case):
    """K2's decode of the uncompacted tables (its own tile rule, and
    tiles of 4096) and K5's of the packed table (tiles of 512 and 4096),
    against the plain pass 2, the plain packed decode and the JAX
    package's dense pass 2."""
    k = _emit_k(case)
    dense = _emit_dense(case)
    paths = {"staged": 0, "streamed": 0, "per_slot": 0}
    for cap in _emit_caps(k):
        (offs, counts, starts, perm_s, perm_u), tab = _emit_tables(case, cap)
        ps, pu = perm_s.numpy(), perm_u.numpy()
        plain = ref.twopass_emit(offs, counts, starts, perm_s, perm_u,
                                 max_pairs=cap).numpy()
        np.testing.assert_array_equal(plain, dense[:cap])
        tb = Uncompacted(offs.numpy(), counts.numpy(), starts.numpy())
        for T in sorted({k2_tile(cap), emit.EMIT_TILE_MAX}):
            rows, took = emit_tiles(tb, ps, pu, cap, T)
            np.testing.assert_array_equal(_join(rows), plain,
                                          err_msg=f"{cap} {T}")
            paths = {p: paths[p] + took[p] for p in paths}
        np.testing.assert_array_equal(
            ref.twopass_emit_streaming(tab, perm_s, perm_u,
                                       max_pairs=cap).numpy(), plain)
        for T in (512, 4096):
            rows, took = emit_tiles(Packed(tab.numpy()), ps, pu, cap, T)
            assert took["per_slot"] == 0   # a K5 tile spans <= T + 1
            np.testing.assert_array_equal(_join(rows), plain,
                                          err_msg=f"{cap} {T}")
    # fig. 9's density stages every K2 tile; at overlap degree 1 they
    # span thousands of entries (read through L1); at 0.01 a tile spans
    # half the table, which the per-slot search takes
    want = {"a100": "staged", "ties": "staged", "a1": "streamed",
            "a0.01": "per_slot"}[case]
    assert paths[want] > 0, paths


@pytest.mark.parametrize("seed", [0, 1])
def test_emit_tile_decode_on_zero_runs(seed):
    counts, starts, perm_s, perm_u, k = zero_run_tables(seed)
    n, m = perm_s.size, perm_u.size
    tc, ts = torch.from_numpy(counts), torch.from_numpy(starts)
    p_s, p_u = torch.from_numpy(perm_s), torch.from_numpy(perm_u)
    for cap in _emit_caps(k):
        incl = torch.cumsum(tc, 0, dtype=torch.int64).clamp_(max=cap)
        offs = torch.cat([torch.zeros(1, dtype=torch.int32),
                          incl.to(torch.int32)])
        plain = ref.twopass_emit(offs, tc, ts, p_s, p_u,
                                 max_pairs=cap).numpy()
        tb = Uncompacted(offs.numpy(), counts, starts)
        # 2048: the tile whose first or last slot starts a run; 128: the
        # run inside a tile spans more than 16 tiles (per slot)
        for T in (k2_tile(cap), 2048, 128):
            got, _ = emit_tiles(tb, perm_s, perm_u, cap, T)
            np.testing.assert_array_equal(_join(got), plain,
                                          err_msg=f"{cap} {T}")
        tab = emit.pack_emitter_tables(offs, tc, ts, n=n, m=m)
        for T in (128, 512):
            got, _ = emit_tiles(Packed(tab.numpy()), perm_s, perm_u, cap, T)
            np.testing.assert_array_equal(_join(got), plain,
                                          err_msg=f"{cap} {T}")
        if cap >= k:                          # slots past K: the sentinel
            assert (plain[k:] == -1).all() and (plain[:k] >= 0).all()


@functools.lru_cache(maxsize=None)
def _all_overlapping(n_reg=50_000):
    """All-overlapping regions, K = n_reg²: at 50,000, K = 2.5e9 passes
    INT32_MAX."""
    rng = np.random.default_rng(12)
    s_lo = rng.uniform(0, 1, n_reg).astype(np.float32)
    u_lo = rng.uniform(1, 2, n_reg).astype(np.float32)
    return s_lo, s_lo + 3, u_lo, u_lo + 3


def test_emit_tile_decode_at_the_int32_cap():
    """max_pairs = INT32_MAX on K = 2.5e9: the last tile's t0 + T passes
    INT32_MAX, its last slot is INT32_MAX - 1, and the offsets of the last
    emitters saturate at max_pairs; tiles around 2^30 and the last two,
    on both tables."""
    arrs = [torch.from_numpy(a) for a in _all_overlapping()]
    n = arrs[0].shape[0]
    cap = INT32_MAX
    perm_s, perm_u, starts, counts, offs = tsbm._twopass_phase1(*arrs,
                                                                cap)[:5]
    tab = emit.pack_emitter_tables(offs, counts, starts, n=n, m=n)
    ps, pu = perm_s.numpy(), perm_u.numpy()
    for table, T in ((Uncompacted(offs.numpy(), counts.numpy(),
                                  starts.numpy()), k2_tile(cap)),
                     (Packed(tab.numpy()), 512), (Packed(tab.numpy()), 4096)):
        ntiles = -(-cap // T)
        assert (ntiles - 1) * T + T > INT32_MAX
        mid = (1 << 30) // T
        rows, _ = emit_tiles(table, ps, pu, cap, T,
                             tiles=[mid - 1, mid, ntiles - 2, ntiles - 1])
        for tile, got in rows.items():
            t0 = tile * T
            stop = min(t0 + T, cap)
            want = tsbm._twopass_window(offs, counts, starts, perm_s, perm_u,
                                        t0, stop).numpy()
            assert (want >= 0).all()
            np.testing.assert_array_equal(got, want, err_msg=str(tile))


def test_twopass_offsets_past_2_30_are_the_clamped_int64_cumsum():
    """ROADMAP Queue 3 item A, pinned: at max_pairs = INT32_MAX on
    K = 2.5e9 the reference's saturating int32 scan (``core/sbm.py``'s
    ``min(a + b, lim)``) wraps where two partial sums add past
    INT32_MAX; the port's offsets are the int64 cumsum clamped at the
    cap, the offsets K2 and K5 read.  The reference's negative entries
    are recorded as found (57,051), not compared with the port's."""
    arrs = _all_overlapping()
    cap = INT32_MAX
    got = tsbm._twopass_phase1(*[torch.from_numpy(a) for a in arrs], cap)
    counts, offs = got[3].numpy(), got[4].numpy()
    want = np.minimum(np.cumsum(counts, dtype=np.int64), cap)
    np.testing.assert_array_equal(offs[1:], want)
    assert offs[0] == 0 and (np.diff(offs.astype(np.int64)) >= 0).all()
    j_offs = np.asarray(jax.jit(jsbm._twopass_phase1, static_argnums=4)(
        *[jnp.asarray(a) for a in arrs], cap)[4])
    assert int((j_offs < 0).sum()) == 57_051
