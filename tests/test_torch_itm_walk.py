"""K8's design (``csrc/itm_walk.cu``) in Python, against an explicit-stack
DFS and the JAX reference's tree walk.

The CUDA kernel has no CPU mode, so its algorithm is transcribed here and
held to the function it must compute, on small complete trees:

* the stackless walk (``walk``): the node after a finished subtree from
  the node index's bits, for the whole tree and for any subtree, visits
  exactly the stack walk's nodes in its order, also on arrays that are no
  consistent tree;
* the right-first pre-order rank the CTA regime's lists keep
  (rank(2k+1) = rank(k) + 1, rank(2k) = rank(k) + 2^(h-d-1));
* the CTA regime (``walk_per_cta``): the level-by-level expansion, its
  stop at the list capacity, the subtree walks, the scan and the writes
  from each entry's slot until cap, bit-equal to ``ref.itm_walk`` and to
  ``repro.core.itm``; its lists in pre-order at every level;
* the thread regime's pairs staging: whole aligned 32-byte sectors and
  the row's ragged head and tail, each element written once;
* the regime rule and the wrapper's private ``_regime`` on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.core import itm as jitm  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import itm as titm  # noqa: E402
from repro_torch.kernels import itm as k8  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

class Arrays:
    """A tree's five arrays as numpy (float32 compares stay exact)."""

    def __init__(self, lo, hi, minlower, maxupper, ids):
        self.lo, self.hi = lo, hi
        self.minlower, self.maxupper, self.ids = minlower, maxupper, ids
        self.M = lo.shape[0] - 1


def _np_tree(tree) -> Arrays:
    return Arrays(*(x.numpy() for x in tree))


def _built(n, seed, integer=True):
    """The port's tree over n random intervals, and the JAX one."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0, 40, n).astype(np.float32)
    hi = lo + rng.uniform(0.5, 9, n).astype(np.float32)
    if integer:
        lo, hi = np.floor(lo), np.ceil(hi)
    tt = titm.build_tree(convert.regions_from_numpy(lo, hi, "cpu"))
    jt = jitm.build_tree(jcore.make_regions(lo, hi))
    return tt, jt


def _random_arrays(h, seed) -> Arrays:
    """Arrays of a complete tree of height h that are no consistent tree:
    the walks' traversal must still agree, whatever the predicates say."""
    rng = np.random.default_rng(seed)
    size = 1 << h

    def f():
        return np.floor(rng.uniform(-2, 12, size)).astype(np.float32)

    ids = rng.integers(-1, 50, size).astype(np.int32)
    return Arrays(f(), f(), f(), f(), ids)


def _queries(rng, b):
    lo = np.floor(rng.uniform(-4, 44, b)).astype(np.float32)
    hi = (lo + rng.uniform(0.1, 14, b)).astype(np.float32)
    special = np.array([[np.inf, -np.inf], [-np.inf, np.inf], [5, 5],
                        [np.nan, 9], [3, np.nan], [-np.inf, -np.inf]],
                       np.float32)
    return (np.concatenate([lo, special[:, 0]]),
            np.concatenate([hi, special[:, 1]]))


# ---------------------------------------------------------------------------
# transcriptions
# ---------------------------------------------------------------------------

def stack_dfs(t: Arrays, a, e, root=1):
    """The reference's walk with an explicit stack: (visits, hit ids)."""
    stack, visits, hits = [root], [], []
    while stack:
        k = stack.pop()
        visits.append(k)
        if t.maxupper[k] <= a or t.minlower[k] >= e:
            continue
        if t.lo[k] < e and a < t.hi[k] and t.ids[k] >= 0:
            hits.append(int(t.ids[k]))
        if 2 * k <= t.M:
            stack.append(2 * k)
            if e > t.lo[k]:
                stack.append(2 * k + 1)
    return visits, hits


def walk(t: Arrays, r, a, e, limit=None):
    """``walk()`` of ``csrc/itm_walk.cu``: the stackless right-first walk
    of the subtree at r, stopping after ``limit`` hits."""
    dr = r.bit_length() - 1
    k, d = r, dr
    visits, hits = [], []
    while True:
        visits.append(k)
        if not (t.maxupper[k] <= a or t.minlower[k] >= e):
            if t.lo[k] < e and a < t.hi[k] and t.ids[k] >= 0:
                hits.append(int(t.ids[k]))
                if len(hits) == limit:
                    break
            if 2 * k <= t.M:
                k = 2 * k + (1 if e > t.lo[k] else 0)
                d += 1
                continue
        low = k & ((1 << (d - dr)) - 1)
        if low == 0:
            break
        z = (low & -low).bit_length() - 1
        k = (k >> z) - 1
        d -= z
    return visits, hits


def preorder_rank(k: int, h: int) -> int:
    """Node k's rank in the right-first pre-order of a complete tree of
    height h, from the root down k's bits."""
    rank, node = 0, 1
    for bit in bin(k)[3:]:
        d = node.bit_length() - 1
        if bit == "1":
            rank, node = rank + 1, 2 * node + 1
        else:
            rank, node = rank + (1 << (h - d - 1)), 2 * node
    return rank


def cta_walk(t: Arrays, a, e, cap, list_cap):
    """``walk_per_cta`` of ``csrc/itm_walk.cu`` for one query: ``(row,
    count, levels)``.  Entries are (node, closed) as in the kernel, whose
    closed entries hold the node's id; ``levels`` the list after each
    expansion, for the pre-order check."""
    cur, levels = [(1, False)], []
    while True:
        outs = []
        for k, closed in cur:
            if closed:
                outs.append([(k, True)])
                continue
            out = []
            if not (t.maxupper[k] <= a or t.minlower[k] >= e):
                if t.lo[k] < e and a < t.hi[k] and t.ids[k] >= 0:
                    out.append((k, True))
                if 2 * k <= t.M:
                    if e > t.lo[k]:
                        out.append((2 * k + 1, False))
                    out.append((2 * k, False))
            outs.append(out)
        total = sum(map(len, outs))
        more = any(not c for out in outs for _, c in out)
        if total > list_cap:
            break
        cur = [x for out in outs for x in out]
        levels.append(cur)
        if not more:
            break
    counts = [1 if closed else len(walk(t, k, a, e)[1]) for k, closed in cur]
    slots = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(int)
    row = [-1] * cap
    for (k, closed), c, s0 in zip(cur, counts, slots):
        if c == 0 or s0 >= cap:
            continue
        if closed:
            row[s0] = int(t.ids[k])
        else:
            hits = walk(t, k, a, e, min(c, cap - s0))[1]
            row[s0:s0 + len(hits)] = hits
    return row, int(sum(counts)), levels


def staged_stores(head, hits, cap):
    """The stores of ``walk_per_thread``'s pairs instance for a row whose
    first element sits at slot ``head`` of its 32-byte sector: a list of
    (first element, values, whole sector?)."""
    stage, stores = [None] * 8, []

    def flush(j):
        s0 = j - ((head + j) & 7)
        if s0 >= 0 and (head + j) & 7 == 7:
            stores.append((s0, list(stage), True))
        else:
            x0 = max(s0, 0)
            stores.append((x0, [stage[(head + x) & 7]
                                for x in range(x0, j + 1)], False))

    for j, hit in enumerate(hits):
        if j < cap:
            stage[(head + j) & 7] = hit
            if (head + j) & 7 == 7 or j == cap - 1:
                flush(j)
    last = min(len(hits), cap) - 1
    if last >= 0 and (head + last) & 7 != 7 and last != cap - 1:
        flush(last)
    return stores


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,sms,want", [(1, 132, "cta"), (64, 132, "cta"),
                                        (132, 132, "cta"),
                                        (133, 132, "thread"),
                                        (50_001, 132, "thread"),
                                        (1, 1, "cta"), (2, 1, "thread"),
                                        (78, 78, "cta"), (79, 78, "thread")])
def test_regime_rule(b, sms, want):
    assert k8.regime(b, sms) == want


@pytest.mark.parametrize("h", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("built", [True, False])
def test_stackless_walk_visits_as_the_stack(h, built):
    if built:
        t = _np_tree(_built((1 << h) - 1 - h // 2, 10 + h)[0])
        assert t.M == (1 << h) - 1
    else:
        t = _random_arrays(h, 20 + h)
    q_lo, q_hi = _queries(np.random.default_rng(h), 40)
    for a, e in zip(q_lo, q_hi):
        assert walk(t, 1, a, e) == stack_dfs(t, a, e)
        for r in range(2, t.M + 1):       # every subtree, as the CTA walks
            assert walk(t, r, a, e) == stack_dfs(t, a, e, root=r), r


@pytest.mark.parametrize("h", [1, 2, 3, 5, 8])
def test_preorder_ranks(h):
    M = (1 << h) - 1
    order, stack = [], [1]
    while stack:                  # the right-first pre-order of every node
        k = stack.pop()
        order.append(k)
        if 2 * k <= M:
            stack += [2 * k, 2 * k + 1]
    assert [preorder_rank(k, h) for k in order] == list(range(M))


def _reference_rows(tt, jt, q_lo, q_hi, cap):
    want_ids, want_cnt = ref.itm_walk(tt, torch.from_numpy(q_lo),
                                      torch.from_numpy(q_hi), cap)
    j_ids, j_cnt = jitm.itm_query_pairs(jt, jnp.asarray(q_lo),
                                        jnp.asarray(q_hi), cap)
    np.testing.assert_array_equal(want_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(want_cnt.numpy(), np.asarray(j_cnt))
    return want_ids.numpy(), want_cnt.numpy()


@pytest.mark.parametrize("list_cap", [1, 2, 3, 7, 40, 12288])
@pytest.mark.parametrize("n,integer", [(1, True), (2, False), (5, True),
                                       (60, True), (200, False)])
def test_cta_regime_transcription_matches_reference(n, integer, list_cap):
    tt, jt = _built(n, 3 * n + integer, integer)
    t = _np_tree(tt)
    h = t.M.bit_length()
    q_lo, q_hi = _queries(np.random.default_rng(n + list_cap), 30)
    _, counts = _reference_rows(tt, jt, q_lo, q_hi, 1)
    top = max(int(counts.max()), 1)
    for cap in sorted({1, max(top // 2, 1), top, top + 3}):
        want_ids, want_cnt = _reference_rows(tt, jt, q_lo, q_hi, cap)
        for i, (a, e) in enumerate(zip(q_lo, q_hi)):
            row, count, levels = cta_walk(t, a, e, cap, list_cap)
            assert count == want_cnt[i], (i, cap)
            assert row == want_ids[i].tolist(), (i, cap)
            for lst in levels:             # every list in pre-order
                keys = [preorder_rank(k, h) for k, _ in lst]
                assert keys == sorted(set(keys)), lst
                assert len(lst) <= list_cap


def test_cta_regime_stops_at_the_list_cap_and_walks_subtrees():
    # one wide query on a 2^10-node tree: a small list capacity leaves
    # open subtrees for the walks, a large one expands to the leaves
    tt, jt = _built(1000, 4)
    t = _np_tree(tt)
    a, e = np.float32(-1), np.float32(50)
    want_ids, want_cnt = _reference_rows(tt, jt, np.array([a]),
                                         np.array([e]), 700)
    for list_cap, open_left in ((64, True), (4096, False)):
        row, count, levels = cta_walk(t, a, e, 700, list_cap)
        assert count == want_cnt[0] > 700 and row == want_ids[0].tolist()
        assert any(not c for _, c in levels[-1]) == open_left


@pytest.mark.parametrize("head", range(8))
def test_thread_regime_stages_whole_sectors(head):
    for cap in (1, 2, 7, 8, 9, 15, 16, 17, 33):
        for n in range(cap + 4):
            hits = list(range(100, 100 + n))
            row = [-1] * cap
            written = [0] * cap
            for x0, vals, whole in staged_stores(head, hits, cap):
                if whole:             # a whole 32-byte sector, aligned
                    assert (head + x0) % 8 == 0 and len(vals) == 8
                else:                 # the row's head or tail sector
                    end = x0 + len(vals) - 1
                    assert x0 == 0 or end == min(n, cap) - 1
                    assert (head + x0) // 8 == (head + end) // 8
                for x, v in enumerate(vals, x0):
                    row[x] = v
                    written[x] += 1
            k = min(n, cap)
            assert row == hits[:k] + [-1] * (cap - k), (cap, n)
            assert written == [1] * k + [0] * (cap - k), (cap, n)


@pytest.mark.parametrize("regime", ["thread", "cta", None])
def test_wrapper_takes_the_plain_version_on_the_cpu(regime):
    tt, _ = _built(300, 8)
    q_lo, q_hi = _queries(np.random.default_rng(8), 50)
    ql, qh = torch.from_numpy(q_lo), torch.from_numpy(q_hi)
    before = (k8.itm_walk.launches, k8.itm_walk.cta_launches)
    for cap in (0, 5):
        got = k8.itm_walk(tt, ql, qh, cap, _regime=regime)
        want = ref.itm_walk(tt, ql, qh, cap)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (k8.itm_walk.launches, k8.itm_walk.cta_launches) == before
    with pytest.raises(ValueError, match="_regime must be one of"):
        k8.itm_walk(tt, ql, qh, _regime="warp")


def test_sentinel_rows_walk_only_the_root():
    # serving pads its batches with (lo=+inf, hi=-inf): the root prunes,
    # so the expansion's first level closes the list and no subtree is
    # walked
    tt, _ = _built(500, 9)
    t = _np_tree(tt)
    a, e = np.float32(np.inf), np.float32(-np.inf)
    assert walk(t, 1, a, e) == ([1], [])
    row, count, levels = cta_walk(t, a, e, 4, 12288)
    assert (row, count, levels) == ([-1] * 4, 0, [[]])
