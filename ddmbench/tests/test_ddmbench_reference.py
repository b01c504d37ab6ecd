"""The yardstick: the copied generators, the plain reference against
brute force, the buffer digest against planted faults, the roofline
arithmetic and the reduction of a trace."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ddmbench_cases  # noqa: E402,F401

from ddmbench import reference, roofline, trace  # noqa: E402
from ddmbench.layout import load_plugin  # noqa: E402


def _brute(s_lo, s_hi, u_lo, u_hi):
    ov = (u_lo[None, :] < s_hi[:, None]) & (s_lo[:, None] < u_hi[None, :])
    s, u = np.nonzero(ov)
    return set(zip(s.tolist(), u.tolist()))


def _ties(n, m, seed):
    """Integer endpoints with many exact ties (touching regions too)."""
    rng = np.random.default_rng(seed)
    s_lo = rng.integers(0, 300, n).astype(np.float32)
    u_lo = rng.integers(0, 300, m).astype(np.float32)
    s_hi = s_lo + rng.integers(1, 15, n).astype(np.float32)
    u_hi = u_lo + rng.integers(1, 15, m).astype(np.float32)
    return s_lo, s_hi, u_lo, u_hi


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 5])
def test_generators_equal_the_ports(seed):
    from repro_torch.core.regions import paper_workload
    for n_total, alpha in ((3001, 7.0), (2500, 100)):
        w = load_plugin("generators", "paper_uniform").make(
            {"n_total": n_total, "alpha": alpha, "space": 1e6, "d": 1}, seed)
        S, U = paper_workload(seed, n_total, alpha, device="cpu")
        for a, b in ((w.s_lo, S.lo), (w.s_hi, S.hi), (w.u_lo, U.lo),
                     (w.u_hi, U.hi)):
            np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_equals_brute_force(seed):
    s_lo, s_hi, u_lo, u_hi = _ties(700, 500, seed)
    want = _brute(s_lo, s_hi, u_lo, u_hi)
    t = [torch.from_numpy(x) for x in (s_lo, s_hi, u_lo, u_hi)]
    assert reference.count_overlaps(*t) == len(want)
    rows = torch.tensor(sorted(want), dtype=torch.int32)
    got = reference.pairs_digest(*t, block=997)
    dig = reference.buffer_digest(lambda a, b: rows[a:b], rows.shape[0],
                                  len(want), 700, 500, chunk=333)
    assert got["k"] == len(want) and dig["bad_rows"] == 0
    assert (got["h1"], got["h2"]) == (dig["h1"], dig["h2"])
    # the order of the rows does not matter
    perm = rows[torch.randperm(rows.shape[0])]
    dig2 = reference.buffer_digest(lambda a, b: perm[a:b], rows.shape[0],
                                   len(want), 700, 500)
    assert (dig2["h1"], dig2["h2"]) == (dig["h1"], dig["h2"])


@pytest.mark.parametrize("seed", [0, 1])
def test_the_count_holds_for_empty_regions(seed):
    """Rounded to bfloat16, as the control rounds them, regions can be
    empty: the count follows the predicate still."""
    s_lo, s_hi, u_lo, u_hi = _ties(600, 400, seed + 10)
    rng = np.random.default_rng(seed)
    for lo, hi in ((s_lo, s_hi), (u_lo, u_hi)):
        e = rng.random(lo.shape[0]) < 0.3
        hi[e] = lo[e]
    want = len(_brute(s_lo, s_hi, u_lo, u_hi))
    t = [torch.from_numpy(x) for x in (s_lo, s_hi, u_lo, u_hi)]
    assert reference.count_overlaps(*t) == want
    w = load_plugin("generators", "paper_uniform").make(
        {"n_total": 3000, "alpha": 100, "space": 1e6}, seed)
    b = [torch.from_numpy(x).bfloat16().float()
         for x in (w.s_lo, w.s_hi, w.u_lo, w.u_hi)]
    want = len(_brute(*(x.reshape(-1).numpy() for x in b)))
    assert reference.count_overlaps(*b) == want
    assert reference.count_overlaps(
        *(torch.from_numpy(x) for x in (w.s_lo, w.s_hi, w.u_lo, w.u_hi)),
        precision="bfloat16") == want


def test_buffer_digest_sees_each_planted_fault():
    s_lo, s_hi, u_lo, u_hi = _ties(300, 200, 3)
    want = sorted(_brute(s_lo, s_hi, u_lo, u_hi))
    rows = torch.tensor(want, dtype=torch.int32)
    k = rows.shape[0]
    ref = reference.pairs_digest(*(torch.from_numpy(x)
                                   for x in (s_lo, s_hi, u_lo, u_hi)))
    pairs = load_plugin("operations", "pairs")

    def gaps(buf, kk=k):
        got = reference.buffer_digest(lambda a, b: buf[a:b], buf.shape[0],
                                      kk, 300, 200)
        return pairs.compare(got, ref)

    assert gaps(rows) == {"k_gap": 0, "bad_rows": 0, "set_gap": 0}
    dup = rows.clone()
    dup[5] = dup[6]
    assert gaps(dup)["set_gap"] == 2
    alt = rows.clone()
    alt[0, 1] = (alt[0, 1] + 1) % 200
    assert gaps(alt)["set_gap"] == 2
    pad = rows.clone()
    pad[k - 1] = -1
    assert gaps(pad)["bad_rows"] == 1
    assert gaps(rows[:k - 3])["bad_rows"] == 3      # a buffer short of K
    assert gaps(rows, k + 1)["k_gap"] == 1


def test_bfloat16_control_fails_the_count():
    w = load_plugin("generators", "paper_uniform").make(
        {"n_total": 4000, "alpha": 100, "space": 1e6}, 5)
    t = [torch.from_numpy(x) for x in (w.s_lo, w.s_hi, w.u_lo, w.u_hi)]
    assert reference.count_overlaps(*t) != reference.count_overlaps(
        *t, precision="bfloat16")


def test_roofline_counts_come_from_the_data():
    n, m, k = 5_000_000, 5_000_000, 500_000_000
    assert roofline.sweep_work(n, m) == {"bytes": 12 * 2 * (n + m), "ops": 0}
    assert roofline.emit_work(n, m, k)["bytes"] == 8 * k + 12 * (n + m)
    w = roofline.walk_work(541_222, 541_222, 3_678_811_212)
    assert w["ops"] == 3 * 3_678_811_212
    assert roofline.least_seconds(3.35e12) == pytest.approx(1.0)
    assert roofline.least_seconds(0, 67e12) == pytest.approx(1.0)
    assert roofline.share({"bytes": 3.35e9, "ops": 0}, 2e-3) == \
        pytest.approx(50.0)


def _rec(name, kind, start, dur, thread=1):
    return trace.Record(name, kind, start, dur, thread)


def test_trace_reduction_on_known_records():
    recs = []
    for i in range(4):                                 # 4 ticks of 100 ns
        t0 = 1000 + 100 * i
        recs += [_rec("ddmbench.tick", "user_annotation", t0, 100),
                 _rec("ddmbench.match", "user_annotation", t0 + 10, 90),
                 _rec("aten::sort", "cpu_op", t0 + 10, 20),
                 _rec("void cub::DeviceRadixSortOnesweepKernel<x>", "kernel",
                      t0 + 20, 30),
                 _rec("void (anonymous namespace)::sbm_sweep_kernel<true>",
                      "kernel", t0 + 50, 20),
                 _rec("searchsorted_cuda_kernel", "kernel", t0 + 70, 5),
                 _rec("Memcpy DtoH", "gpu_memcpy", t0 + 75, 5)]
    tr = trace.reduce(recs, skip=1)
    assert tr.ticks == 3 and tr.window_ns == 300
    assert tr.busy_ns == 3 * 60
    assert tr.stage(("radixsort",)) == (3, 90)
    assert tr.stage(("sbm_sweep_kernel",)) == (3, 60)
    assert len(tr.kernels) == 9
    gaps = dict((n, s) for n, s in tr.breakdown["idle_gaps"])
    # [1100, 1120): the first kept tick's sort; [1180, 1220) and
    # [1280, 1320): across tick boundaries, midpoint at a tick's start;
    # [1380, 1400): the last tick's end
    assert gaps == pytest.approx({"ddmbench.match/aten::sort": 20e-9,
                                  "ddmbench.tick/python": 80e-9,
                                  "ddmbench.match/python": 20e-9})
    assert tr.breakdown["device_ops"][0][0].startswith("void cub::")
    assert trace.reduce(recs, skip=4) is None
    sort_ms = load_plugin("metrics", "sort_ms")
    assert trace.matches("void cub::DeviceRadixSortOnesweepKernel<x>",
                         sort_ms.KERNELS)
    assert not trace.matches("searchsorted_cuda_kernel", sort_ms.KERNELS)


def test_every_tick_moves_its_share_to_fresh_extents():
    from ddmbench.session import Store
    w = load_plugin("generators", "paper_uniform").make(
        {"n_total": 4000, "alpha": 100, "space": 1e6}, 9)
    moves = load_plugin("moves", "replace_uniform")
    pool = moves.make_pool(w, {"fraction": 0.01, "pool": 4}, 123,
                           torch.device("cpu"))
    st, seen = Store(w, torch.device("cpu")), []
    for t in range(12):               # three times round the index pool
        before = [x.clone() for x in st.tensors()]
        moves.apply(st, pool, t)
        changed = sum(int(((a != b) | (c != e)).any(dim=1).sum())
                      for a, c, b, e in ((st.s_lo, st.s_hi, *before[:2]),
                                         (st.u_lo, st.u_hi, *before[2:])))
        assert changed == 40          # 20 a side, every one of them moved
        assert bool((st.s_lo < st.s_hi).all() & (st.u_lo < st.u_hi).all())
        seen.append(torch.cat([x.reshape(-1) for x in st.tensors()]))
    # the state never comes back: no two ticks leave the same store
    assert len({tuple(x.tolist()) for x in seen}) == len(seen)
    # a replay from the generated regions writes the same state
    again = Store(w, torch.device("cpu"))
    for t in range(12):
        moves.apply(again, pool, t)
    assert all(torch.equal(a, b) for a, b in zip(st.tensors(),
                                                 again.tensors()))
