"""Port parity: ``repro_torch``'s distributed backend against ``repro``'s.

The same seeded NumPy inputs (``torch_dist_cases``) go through the
port's ``MatchSpec(backend="distributed")`` on gloo process groups and
through the reference's on JAX device meshes of the same size P:

* P = 1 in this process: a gloo group of world size 1 against the
  reference on its default 1-device mesh;
* P = 2 and 4: four spawned gloo ranks (``mp.get_context("spawn")``, a
  ``file://`` store under ``tmp_path``, one thread each) run every case
  on the default group (P = 4), on ``new_group([0, 1])`` (P = 2) and on
  ``new_group([0])`` (P = 1), and one JAX subprocess per P, with
  ``--xla_force_host_platform_device_count=P`` set before JAX is
  imported, runs the reference; all of them start with the module's first
  test and run beside the in-process tests.  Every rank is checked.

K is exact and the per-rank ``cap_dev`` and ``dev_counts`` are the
reference's.  The buffers are bit-equal to the reference's at the same P
where the lows are distinct (and then to the single-device sbm buffer
too); where lows tie (``torch_dist_cases.TIED``) the rank order of the
sample sort decides the order of tied pairs, so they are held as sets.
Overflow raises on every rank exactly where the reference raises.

The reference's distributed ``query()`` fails on JAX 0.9 (its
``shard_map`` rejects the tree walk's ``while_loop`` carry), so the
port's distributed query is held to the reference's single-device query,
whose rows the reference's sharded query returns.
"""
import datetime
import multiprocessing
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import repro.core as jcore  # noqa: E402
from repro.core import distributed as jdist  # noqa: E402
from repro.core import pairs as jpairs  # noqa: E402
from repro.core.engine import MatchPlan as JPlan  # noqa: E402

import torch_dist_cases as cases  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import MatchSpec, ShardedPairs, brute, itm  # noqa: E402
from repro_torch.core import distributed as tdist  # noqa: E402
from repro_torch.core import sbm as tsbm  # noqa: E402
from repro_torch.core.engine import MatchPlan  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

K = cases.key
WORLD = 4
JOIN_S = 240            # a hung rank or subprocess fails its test
INT32_MAX = 2 ** 31 - 1
TESTS = Path(__file__).resolve().parent


def _regions(arrs):
    return (convert.regions_from_numpy(arrs[0], arrs[1], "cpu"),
            convert.regions_from_numpy(arrs[2], arrs[3], "cpu"))


def _pair_set(buf):
    buf = np.asarray(buf)
    return {(int(s), int(u)) for s, u in buf if s >= 0}


class _Gloo:
    """A gloo process group of world size 1 in this process, destroyed on
    exit."""

    def __init__(self, path):
        self.store = f"file://{path}/gloo_store"

    def __enter__(self):
        dist.init_process_group("gloo", init_method=self.store,
                                world_size=1, rank=0,
                                timeout=datetime.timedelta(seconds=60))

    def __exit__(self, *exc):
        dist.destroy_process_group()


@pytest.fixture
def gloo1(tmp_path):
    with _Gloo(tmp_path):
        yield


# ---------------------------------------------------------------------------
# the P = 2 / P = 4 runs: started with the module's first test
# ---------------------------------------------------------------------------

class _Background:
    """The spawned port ranks and the JAX subprocesses, running."""

    def __init__(self, out: Path):
        self.out = out
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(TESTS.parent / "src"), str(TESTS)]
            + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        self.jax = {}
        for P in (2, 4):
            env_p = dict(env, XLA_FLAGS="--xla_force_host_platform_device_"
                                        f"count={P}", JAX_PLATFORMS="cpu")
            self.jax[P] = subprocess.Popen(
                [sys.executable, "-c", "import torch_dist_cases as c; "
                 f"c.jax_main({str(out / f'jax{P}.npz')!r}, {P})"],
                env=env_p, stdout=subprocess.DEVNULL,
                stderr=subprocess.PIPE, text=True)
        ctx = multiprocessing.get_context("spawn")
        self.ranks = [ctx.Process(target=cases.port_worker,
                                  args=(r, WORLD, str(out / "store"),
                                        str(out)))
                      for r in range(WORLD)]
        for p in self.ranks:
            p.start()
        self._results = None

    def results(self):
        """``(jax {P: npz}, port [rank npz])``; fails on a hang or error."""
        if self._results is None:
            for p in self.ranks:
                p.join(JOIN_S)
            alive = [p.pid for p in self.ranks if p.is_alive()]
            codes = [p.exitcode for p in self.ranks]
            errs = {}
            for P, proc in self.jax.items():
                try:
                    errs[P] = proc.communicate(timeout=JOIN_S)[1]
                except subprocess.TimeoutExpired:
                    proc.kill()
                    errs[P] = proc.communicate()[1] + "\n(timed out)"
            assert not alive and codes == [0] * WORLD, (alive, codes)
            for P, proc in self.jax.items():
                assert proc.returncode == 0, errs[P][-3000:]
            self._results = (
                {P: dict(np.load(self.out / f"jax{P}.npz")) for P in self.jax},
                [dict(np.load(self.out / f"rank{r}.npz"))
                 for r in range(WORLD)])
        return self._results

    def stop(self):
        for p in self.ranks:
            if p.is_alive():
                p.kill()
            p.join(10)
        for proc in self.jax.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def background(tmp_path_factory):
    bg = _Background(tmp_path_factory.mktemp("dist"))
    yield bg
    bg.stop()


@pytest.fixture
def multi(background):
    return background.results()


# ---------------------------------------------------------------------------
# the P = 1 runs in this process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def p1(tmp_path_factory):
    """``(port, reference)`` result dicts at P = 1."""
    with _Gloo(tmp_path_factory.mktemp("p1")):
        port = cases.port_results(None)
        port.update(cases.port_queries(None))
    return port, cases.jax_results(None)


@pytest.fixture(scope="module")
def ref_queries():
    """The reference's single-device query of the query cases."""
    out = {}
    for case in ("d1", "d2"):
        a = cases.arrays(case)
        S, U = (jcore.make_regions(a[0], a[1]),
                jcore.make_regions(a[2], a[3]))
        plan = JPlan(jcore.MatchSpec(algo="itm", capacity="grow",
                                     max_pairs=8), S.n, U.n, S.d)
        ids, cnt = plan.query(jcore.itm.build_tree(U), U, S.lo, S.hi)
        out[K("query", case, "ids")] = np.asarray(ids)
        out[K("query", case, "cnt")] = np.asarray(cnt)
    return out


def _single_device_sbm(case, capacity, max_pairs):
    """The port's single-device sbm buffer of a case (torch backend)."""
    S, U = _regions(cases.arrays(case))
    plan = MatchPlan(MatchSpec(algo="sbm", backend="torch", device="cpu",
                               capacity=capacity, max_pairs=max_pairs),
                     S.n, U.n, S.d)
    return np.asarray(plan.pairs(S, U)[0])


def _check_pairs(got: dict, want: dict, case: str, pol: str, what: str):
    assert got[K(case, pol, "K")] == want[K(case, pol, "K")], what
    gbuf, wbuf = got[K(case, pol, "buf")], want[K(case, pol, "buf")]
    assert gbuf.shape == wbuf.shape and gbuf.dtype == np.int32, what
    if case in cases.TIED:
        assert _pair_set(gbuf) == _pair_set(wbuf), what
    else:
        np.testing.assert_array_equal(gbuf, wbuf, err_msg=what)
    for field in ("cap_dev", "dev_counts"):
        np.testing.assert_array_equal(got[K(case, pol, field)],
                                      want[K(case, pol, field)],
                                      err_msg=f"{what} {field}")


# ---------------------------------------------------------------------------
# helpers, bit for bit
# ---------------------------------------------------------------------------

def _stream(kind: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    if kind == "clustered":   # the reference's test stream (:190)
        tot = 200_000
        return np.concatenate([np.linspace(0.0, 1.0, tot // 2),
                               np.linspace(1000.0, 1001.0, tot // 2)]
                              ).astype(np.float32)
    if kind == "uniform":
        return rng.uniform(0, 1e6, 150_001).astype(np.float32)
    if kind == "ties":
        return np.floor(rng.uniform(0, 20, 5000)).astype(np.float32)
    if kind == "with_inf":
        v = rng.uniform(-5, 5, 3000).astype(np.float32)
        v[::7] = np.inf
        return v
    return np.array([3.0, 1.0], np.float32)            # shorter than P


@pytest.mark.parametrize("nshards", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["clustered", "uniform", "ties",
                                  "with_inf", "short"])
def test_sample_splitters_bit_equal(kind, nshards):
    v = _stream(kind)
    tot = v.shape[0]
    want = np.asarray(jdist.sample_splitters(v, tot, nshards))
    for arg in (v, torch.from_numpy(v)):
        got = tdist.sample_splitters(arg, tot, nshards)
        assert got.dtype == torch.float32 and got.shape == (nshards - 1,)
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.view(np.int32))
    if kind == "clustered" and nshards == 8:
        assert want.max() >= 1000.0 and want.min() <= 1.0


@pytest.mark.parametrize("nshards", [1, 2, 3, 4, 8])
def test_bucket_cap_and_interleave_equal(nshards):
    for tot in (0, 1, 17, 1000, 188_000, 2_000_000):
        for op in (0.5, 1.0, 2.5, 4.0):
            assert (tdist.bucket_cap(tot, nshards, op)
                    == jdist.bucket_cap(tot, nshards, op))
    x = np.arange(nshards * 13, dtype=np.int32)
    np.testing.assert_array_equal(
        tdist._interleave(torch.from_numpy(x), nshards).numpy(),
        np.asarray(jdist._interleave(jnp.asarray(x), nshards)))
    # a rank's chunk is the strided slice of the padded stream
    v = torch.arange(10, dtype=torch.float32)
    for me in range(nshards):
        pad = torch.cat([v, torch.full(((-10) % nshards,), -1.0)])
        assert torch.equal(tdist._local(v, -1.0, nshards, me),
                           pad[me::nshards])


# ---------------------------------------------------------------------------
# the process group
# ---------------------------------------------------------------------------

def test_plan_without_process_group_raises_runtime_error():
    assert not dist.is_initialized()
    S, U = _regions(cases.arrays("d1"))
    plan = MatchPlan(MatchSpec(backend="distributed", device="cpu"),
                     S.n, U.n, 1)
    for call in (plan.count, plan.pairs):
        with pytest.raises(RuntimeError, match="init_process_group"):
            call(S, U)
    qplan = MatchPlan(MatchSpec(algo="itm", backend="distributed",
                                device="cpu"), S.n, U.n, 1)
    with pytest.raises(RuntimeError, match="init_process_group"):
        qplan.query(itm.build_tree(U), U, S.lo, S.hi)


def test_backend_device_mismatch_raises_value_error(gloo1):
    assert tdist.resolve_group(None, torch.device("cpu")) is None
    with pytest.raises(ValueError, match="'nccl'"):
        tdist.resolve_group(None, torch.device("cuda"))
    with pytest.raises(ValueError, match="'gloo'"):
        tdist.resolve_group(None, torch.device("meta"))


# ---------------------------------------------------------------------------
# P = 1 in process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,pol", cases.RUNS)
def test_p1_pairs_match_reference(p1, case, pol):
    port, want = p1
    _check_pairs(port, want, case, pol, f"P=1 {case} {pol}")
    single = _single_device_sbm(case, pol, cases.POLICIES[pol])
    if case not in cases.TIED:
        np.testing.assert_array_equal(port[K(case, pol, "buf")], single)
    else:
        assert _pair_set(port[K(case, pol, "buf")]) == _pair_set(single)


@pytest.mark.parametrize("case", list(cases.CASES))
def test_p1_count_matches_reference(p1, case):
    port, want = p1
    got = port[K(case, "count")]
    if K(case, "count") in want:
        assert got == want[K(case, "count")]
    pols = [pol for c, pol in cases.RUNS if c == case]
    exact = [want[K(case, pol, "K")] for pol in pols]
    assert all(got == k for k in exact), (got, exact)


@pytest.mark.parametrize("d", [1, 2])
def test_p1_query_matches_reference(p1, ref_queries, d):
    port, _ = p1
    case = f"d{d}"
    for field in ("ids", "cnt"):
        np.testing.assert_array_equal(port[K("query", case, field)],
                                      ref_queries[K("query", case, field)])


@pytest.mark.parametrize("capacity", ["exact", "fixed", "grow"])
def test_p1_empty_sets(gloo1, capacity):
    lo = np.array([[1.0]], np.float32)
    one = (lo, lo + 3)
    none = (lo[:0], lo[:0])
    for a, b, want in ((none, one, 0), (one, none, 0), (none, none, 0),
                       (one, one, 1)):
        S, U = _regions(a + b)
        plan = MatchPlan(MatchSpec(backend="distributed", device="cpu",
                                   capacity=capacity, max_pairs=2),
                         S.n, U.n, 1)
        jS, jU = jcore.make_regions(*a), jcore.make_regions(*b)
        jplan = JPlan(jcore.MatchSpec(backend="distributed",
                                      capacity=capacity, max_pairs=2),
                      S.n, U.n, 1)
        assert plan.count(S, U) == jplan.count(jS, jU) == want
        res, k = plan.pairs(S, U)
        jres, jk = jplan.pairs(jS, jU)
        assert k == jk == want
        np.testing.assert_array_equal(np.asarray(res), np.asarray(jres))


def test_p1_query_empty_batch_and_empty_opp(gloo1):
    a = cases.arrays("d2")
    S, U = _regions(a)
    plan = MatchPlan(MatchSpec(algo="itm", backend="distributed",
                               capacity="grow", device="cpu"), S.n, U.n, 2)
    tree = itm.build_tree(U)
    ids, cnt = plan.query(tree, U, S.lo[:0], S.hi[:0])
    assert ids.shape[0] == 0 and cnt.shape[0] == 0
    empty = convert.regions_from_numpy(np.zeros((0, 2)), np.zeros((0, 2)),
                                       "cpu")
    tree0 = itm.build_tree(convert.regions_from_numpy(
        np.zeros((1, 2)), np.ones((1, 2)), "cpu"))
    ids, cnt = plan.query(tree0, empty, S.lo[:4], S.hi[:4])
    assert int(cnt.sum()) == 0 and (ids == -1).all()


def test_integer_query_dtypes_raise_type_error(gloo1):
    S, U = _regions(cases.arrays("d2"))
    plan = MatchPlan(MatchSpec(algo="itm", backend="distributed",
                               capacity="grow", device="cpu"), S.n, U.n, 2)
    q_lo = S.lo[:5].to(torch.int32)
    q_hi = S.hi[:5].to(torch.int32) + 1
    with pytest.raises(TypeError, match="floating"):
        plan.query(itm.build_tree(U), U, q_lo, q_hi)
    # the reference raises the same for integer boxes
    jplan = JPlan(jcore.MatchSpec(algo="itm", backend="distributed",
                                  capacity="grow"), S.n, U.n, 2)
    jS, jU = (jcore.make_regions(np.asarray(S.lo), np.asarray(S.hi)),
              jcore.make_regions(np.asarray(U.lo), np.asarray(U.hi)))
    with pytest.raises(TypeError, match="floating"):
        jplan.query(jcore.itm.build_tree(jU), jU, q_lo.numpy(),
                    q_hi.numpy())


@pytest.mark.parametrize("algo", ["bfm", "gbm", "hsbm", "itm"])
def test_mask_and_non_sbm_raise_as_the_reference(gloo1, algo):
    a = cases.arrays("d1")
    S, U = _regions(a)
    jS, jU = jcore.make_regions(a[0], a[1]), jcore.make_regions(a[2], a[3])
    plan = MatchPlan(MatchSpec(algo=algo, backend="distributed",
                               device="cpu"), S.n, U.n, 1)
    jplan = JPlan(jcore.MatchSpec(algo=algo, backend="distributed"),
                  S.n, U.n, 1)
    for name in ("count", "pairs"):
        with pytest.raises(ValueError, match="implements parallel SBM"):
            getattr(jplan, name)(jS, jU)
        with pytest.raises(ValueError, match="implements parallel SBM"):
            getattr(plan, name)(S, U)
    with pytest.raises(NotImplementedError, match="not sharded"):
        jplan.mask(jS, jU)
    with pytest.raises(NotImplementedError, match="not sharded"):
        plan.mask(S, U)


def test_ddmservice_on_the_distributed_backend_matches_truth(gloo1):
    """The reference's :269 test, on the port: every tick's query runs
    through the sharded path, and the ledger is the brute-force truth."""
    S, U = _regions(cases.arrays("d2"))
    from repro_torch.core import DDMService
    svc = DDMService(S, U, spec=MatchSpec(algo="itm", backend="distributed",
                                          capacity="grow", max_pairs=8,
                                          device="cpu"))
    assert svc.plan.spec.backend == "distributed"
    svc.connect()
    rng = np.random.default_rng(3)
    for kind in ("sub", "upd", "sub"):
        idx = rng.choice(40, size=9, replace=False)
        lo = rng.uniform(0, 1000, (9, 2)).astype(np.float32)
        hi = lo + rng.uniform(1.0, 150.0, (9, 2)).astype(np.float32)
        svc.update_regions(kind, idx, lo, hi)
    mask = brute.bfm_mask(*_regions((svc.s_lo, svc.s_hi, svc.u_lo,
                                     svc.u_hi))).numpy()
    assert svc.pairs == {(int(a), int(b)) for a, b in zip(*np.nonzero(mask))}
    assert len(svc.pairs) > 0
    assert [b for b, _ in svc.plan.new_capacities] == ["query"]


def test_k_past_2_31_on_the_all_overlap_table_p1(gloo1):
    got = cases.port_regressions(None)
    assert got[K("all_overlap", "K")] == cases.ALL_OVERLAP_N ** 2
    assert got[K("clustered", "K")] == 0


def test_sharded_pairs_assemble_as_the_reference():
    rng = np.random.default_rng(0)
    data = rng.integers(0, 50, (4 * 6, 2)).astype(np.int32)
    for dev_counts, cap in (([6, 0, 3, 5], 14), ([6, 0, 3, 5], 9),
                            ([1, 1, 1, 1], 7)):
        want = jpairs.ShardedPairs(data, dev_counts, cap, sum(dev_counts))
        got = ShardedPairs(torch.from_numpy(data), dev_counts, cap,
                           sum(dev_counts))
        assert (got.cap_dev, got.nshards, got.nbytes) == (
            want.cap_dev, want.nshards, want.nbytes)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        np.testing.assert_array_equal(got.decode(2, 5).numpy(),
                                      want.decode(2, 5))
        np.testing.assert_array_equal(convert.pairs_to_numpy(got),
                                      np.asarray(want))
        assert [w0 for w0, _ in got.windows(4)] == list(range(0, cap, 4))


@pytest.mark.parametrize("cut", [(0, 1 << 12), (2500, 6000), (2001, 2002),
                                 (3000, 8000)])
def test_seeded_sweep_of_a_cut_segment_is_the_full_sweep(cut):
    """K1's function on a middle segment (its active counts go negative)
    plus the carries is the full stream's sweep over that segment."""
    args = [torch.from_numpy(x[:, 0]) for x in cases.ovf_arrays()]
    is_lo, is_upd = tsbm._endpoint_stream(*args)        # 8000 endpoints
    full = ref.sbm_sweep(is_lo, is_upd).to(torch.int64)
    lo, hi = cut
    seg_lo, seg_upd = is_lo[lo:hi].contiguous(), is_upd[lo:hi].contiguous()
    sign = 2 * is_lo[:lo].long() - 1
    carry_upd = int((sign * is_upd[:lo]).sum())
    carry_sub = int(sign.sum()) - carry_upd
    got = tdist.seeded_sweep(seg_lo, seg_upd, carry_upd, carry_sub)
    assert int(got) == int(full[lo:hi].sum())
    if lo > 0 and hi - lo > 100:
        local = ref.sbm_sweep(seg_lo, seg_upd)
        assert int(local.min()) < 0     # hi endpoints before their lo


def test_chunk_offsets_at_int32_max_are_the_clamped_int64_cumsum():
    """ROADMAP Queue 3 item I: the reference's per-device scan
    (``_pairs_emit_body``' ``min(a + b, cap_dev)`` in int32) wraps once
    two partial sums add past INT32_MAX, as under ``capacity="fixed"`` at
    d = 1 with ``max_pairs`` = INT32_MAX.  On the n = m = 50,000
    all-overlapping table (K = 2.5e9) at ``cap_dev`` = INT32_MAX, the
    port's chunk offsets are the int64 cumsum clamped at the cap; the
    reference's negative entries under the same expression are recorded
    (57,051, from entry 42,949 on), not compared.  A second chunk, the
    upper three quarters at a cap of 2^30, is clamped the same way."""
    n = 50_000
    rng = np.random.default_rng(12)
    s_lo = rng.uniform(0, 1, n).astype(np.float32)
    u_lo = rng.uniform(1, 2, n).astype(np.float32)
    S, U = _regions((s_lo[:, None], s_lo[:, None] + 3, u_lo[:, None],
                     u_lo[:, None] + 3))
    perm_s = torch.argsort(S.lo[:, 0], stable=True).to(torch.int32)
    perm_u = torch.argsort(U.lo[:, 0], stable=True).to(torch.int32)
    for c0, c1, cap in ((n // 2, 2 * n, 1 << 30), (0, 2 * n, INT32_MAX)):
        p1 = tdist._chunk_ranges(S, U, perm_s, perm_u, c0, c1)
        offs, counts, starts = tdist.chunk_tables(p1, 2 * n, cap)
        cnt = p1.cnt.numpy().astype(np.int64)
        assert cnt.sum() > cap
        want = np.minimum(np.cumsum(cnt), cap)
        np.testing.assert_array_equal(offs.numpy()[c0 + 1:c1 + 1], want)
        assert (offs.numpy()[:c0 + 1] == 0).all()
        np.testing.assert_array_equal(counts.numpy()[c0:c1], cnt)
        assert (counts.numpy()[:c0] == 0).all()
        np.testing.assert_array_equal(starts.numpy()[c0:c1], p1.start)
    lim = jnp.int32(INT32_MAX)
    incl = np.asarray(jax.jit(lambda c: jax.lax.associative_scan(
        lambda a, b: jnp.minimum(a + b, lim), jnp.minimum(c, lim)))(
            jnp.asarray(cnt.astype(np.int32))))
    assert int((incl < 0).sum()) == 57_051
    assert int(np.argmax(incl < 0)) == 42_949


# ---------------------------------------------------------------------------
# P = 2 and P = 4 over gloo, every rank, against JAX at the same P
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,pol", cases.RUNS)
@pytest.mark.parametrize("P", [2, 4])
def test_multi_pairs_match_reference(multi, P, case, pol):
    jax_out, ranks = multi
    for r in range(P):
        got = {k[len(f"P{P}:"):]: v for k, v in ranks[r].items()
               if k.startswith(f"P{P}:")}
        want = {k[len(f"P{P}:"):]: v for k, v in jax_out[P].items()}
        _check_pairs(got, want, case, pol, f"P={P} rank {r} {case} {pol}")


@pytest.mark.parametrize("case", list(cases.CASES))
@pytest.mark.parametrize("P", [2, 4])
def test_multi_count_matches_reference(multi, P, case):
    jax_out, ranks = multi
    want = jax_out[P]
    pols = [pol for c, pol in cases.RUNS if c == case]
    exact = {int(want[K(f"P{P}", case, pol, "K")]) for pol in pols}
    if K(f"P{P}", case, "count") in want:
        exact.add(int(want[K(f"P{P}", case, "count")]))
    assert len(exact) == 1
    for r in range(P):
        assert int(ranks[r][K(f"P{P}", case, "count")]) in exact, r


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("P", [2, 4])
def test_multi_query_matches_reference(multi, ref_queries, P, d):
    _, ranks = multi
    for r in range(P):
        for field in ("ids", "cnt"):
            np.testing.assert_array_equal(
                ranks[r][K(f"P{P}", "query", f"d{d}", field)],
                ref_queries[K("query", f"d{d}", field)], err_msg=str(r))


@pytest.mark.parametrize("op", cases.OVERPROVISIONS)
@pytest.mark.parametrize("path", ["count", "pairs"])
@pytest.mark.parametrize("P", [2, 4])
def test_multi_overflow_exactly_where_the_reference_raises(multi, P, path,
                                                           op):
    jax_out, ranks = multi
    k = K(f"P{P}", "ovf", path, op)
    want = int(jax_out[P][k])
    assert [int(ranks[r][k]) for r in range(P)] == [want] * P
    if op == min(cases.OVERPROVISIONS):
        assert want == 1              # the tried values do reach overflow
    if op == max(cases.OVERPROVISIONS):
        assert want == 0


def test_multi_cap_dev_shrinks_as_p_grows(multi, p1):
    jax_out, ranks = multi
    _, want1 = p1
    caps = {1: int(ranks[0][K("P1", "d1", "exact", "cap_dev")])}
    assert caps[1] == int(want1[K("d1", "exact", "cap_dev")])
    for P in (2, 4):
        caps[P] = int(ranks[0][K(f"P{P}", "d1", "exact", "cap_dev")])
        assert caps[P] == int(jax_out[P][K(f"P{P}", "d1", "exact",
                                           "cap_dev")])
    assert caps[4] < caps[2] < caps[1], caps


def test_multi_p1_subgroup_equals_the_in_process_run(multi, p1):
    _, ranks = multi
    port1, _ = p1
    for k, v in port1.items():
        np.testing.assert_array_equal(ranks[0][K("P1", k)], v, err_msg=k)


@pytest.mark.parametrize("name,want", [
    ("clustered", 0), ("all_overlap", cases.ALL_OVERLAP_N ** 2)])
def test_multi_regressions_at_p4(multi, name, want):
    _, ranks = multi
    for r in range(WORLD):
        assert int(ranks[r][K(f"P{WORLD}", name, "K")]) == want, r


def test_multi_every_rank_returns_the_same(multi):
    _, ranks = multi
    for P in (2, 4):
        keys = [k for k in ranks[0] if k.startswith(f"P{P}:")]
        for r in range(1, P):
            for k in keys:
                np.testing.assert_array_equal(ranks[r][k], ranks[0][k],
                                              err_msg=f"{k} rank {r}")
