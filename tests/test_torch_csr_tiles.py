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

import jax.numpy as jnp  # noqa: E402

from repro.core import sbm as jsbm  # noqa: E402

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
