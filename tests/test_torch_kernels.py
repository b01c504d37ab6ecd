"""Port kernels K1 (SBM sweep) and K2 (two-pass emit) against the reference.

On the CPU each wrapper runs its kernel's plain version, and those plain
versions are held bit for bit against the JAX package's Pallas kernels
in interpret mode and against its pure-jnp oracle.  The CUDA kernels
themselves run only on a card: ``tests/test_torch_cuda.py`` holds them
against the plain versions there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.core import sbm as jsbm  # noqa: E402
from repro.kernels import emit as jemit  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import sbm_sweep as jsweep  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import sbm as tsbm  # noqa: E402
from repro_torch.kernels import _build, emit, ops, ref  # noqa: E402
from repro_torch.kernels import sbm_sweep as sweep  # noqa: E402


def _workload(seed, n_total, alpha):
    S, U = jcore.paper_workload(seed, n_total, alpha)
    return [np.asarray(a) for a in (S.lo[:, 0], S.hi[:, 0], U.lo[:, 0],
                                    U.hi[:, 0])]


WORKLOADS = [(1, 700, 8.0), (2, 1201, 0.5)]
_j_phase1 = jax.jit(jsbm._twopass_phase1, static_argnums=4)


@pytest.mark.parametrize("seed,n_total,alpha", WORKLOADS)
def test_plain_sweep_matches_pallas_interpret_and_oracle(seed, n_total,
                                                         alpha):
    arrs = _workload(seed, n_total, alpha)
    is_lo, is_upd = jsbm._endpoint_stream(*[jnp.asarray(a) for a in arrs])
    tot = is_lo.shape[0]
    block = 512
    pad = (-tot) % block      # sub-lo sentinels, as ops._sweep pads
    want = jsweep.sbm_sweep(jnp.pad(is_lo, (0, pad), constant_values=1),
                            jnp.pad(is_upd, (0, pad)), block=block,
                            interpret=True)[:tot]
    t_lo = torch.from_numpy(np.asarray(is_lo).copy())
    t_upd = torch.from_numpy(np.asarray(is_upd).copy())
    before = sweep.sbm_sweep.launches
    got = sweep.sbm_sweep(t_lo, t_upd)
    assert sweep.sbm_sweep.launches == before    # CPU: plain version
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(ref.sbm_sweep(t_lo, t_upd).numpy(),
                                  np.asarray(jref.sbm_sweep(is_lo, is_upd)))


def _tables(arrs, max_pairs):
    j = _j_phase1(*[jnp.asarray(a) for a in arrs], max_pairs)
    return [np.asarray(x) for x in j[:5]]


@pytest.mark.parametrize("seed,n_total,alpha", WORKLOADS)
def test_plain_emit_matches_pallas_interpret(seed, n_total, alpha):
    arrs = _workload(seed, n_total, alpha)
    n, m = arrs[0].shape[0], arrs[2].shape[0]
    k = jsbm.sbm_count_binary(jcore.make_regions(arrs[0], arrs[1]),
                              jcore.make_regions(arrs[2], arrs[3]))
    for max_pairs in sorted({max(k // 3, 1), k + 100}):
        perm_s, perm_u, starts, counts, offs = _tables(arrs, max_pairs)
        want = jemit.twopass_emit(
            jnp.asarray(offs), jnp.asarray(counts), jnp.asarray(starts),
            jnp.asarray(perm_s), jnp.asarray(perm_u), n=n, m=m,
            max_pairs=max_pairs, interpret=True)
        # the port saturates every offset (see test_torch_sbm)
        offs = np.minimum(offs, np.int32(max_pairs))
        t = [torch.from_numpy(x.copy()) for x in (offs, counts, starts,
                                                  perm_s, perm_u)]
        before = emit.twopass_emit.launches
        got = emit.twopass_emit(*t, max_pairs=max_pairs)
        assert emit.twopass_emit.launches == before
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            ref.twopass_emit(*t, max_pairs=max_pairs).numpy(),
            np.asarray(want))


def test_emit_max_pairs_zero_returns_empty_without_launch():
    arrs = _workload(3, 300, 5.0)
    perm_s, perm_u, starts, counts, offs = tsbm._twopass_phase1(
        *[torch.from_numpy(a.copy()) for a in arrs], 0)[:5]
    t = (offs, counts, starts, perm_s, perm_u)
    before = emit.twopass_emit.launches
    out = emit.twopass_emit(*t, max_pairs=0)
    assert tuple(out.shape) == (0, 2) and out.dtype == torch.int32
    assert emit.twopass_emit.launches == before
    want = jemit.twopass_emit(*[jnp.asarray(x.numpy()) for x in t],
                              n=150, m=150, max_pairs=0, interpret=True)
    assert np.asarray(want).shape == (0, 2)


@pytest.mark.parametrize("seed,n_total,alpha", WORKLOADS)
def test_ops_match_reference_ops(seed, n_total, alpha):
    arrs = _workload(seed, n_total, alpha)
    jS = jcore.make_regions(arrs[0], arrs[1])
    jU = jcore.make_regions(arrs[2], arrs[3])
    tS = convert.regions_from_numpy(arrs[0], arrs[1], "cpu")
    tU = convert.regions_from_numpy(arrs[2], arrs[3], "cpu")
    k = jops.sbm_count_pallas(jS, jU, block=512, interpret=True)
    assert ops.sbm_count_cuda(tS, tU) == k
    want, wk = jops.twopass_pairs_pallas(jS, jU, k, route="resident",
                                         interpret=True)
    for route in ("auto", "resident", "xla"):
        got, gk = ops.twopass_pairs_cuda(tS, tU, k, route=route)
        assert ops.last_emit_route() == ("xla" if route == "xla"
                                         else "resident")
        assert gk == wk == k
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ops_empty_and_unported_routes():
    lo = np.arange(4, dtype=np.float32)
    tS = convert.regions_from_numpy(lo, lo + 1, "cpu")
    tE = convert.regions_from_numpy(lo[:0], lo[:0], "cpu")
    launches = (sweep.sbm_sweep.launches, emit.twopass_emit.launches)
    assert ops.sbm_count_cuda(tE, tS) == 0
    out, k = ops.twopass_pairs_cuda(tS, tE, 5)
    assert k == 0 and out.shape == (5, 2) and bool((out == -1).all())
    assert ops.last_emit_route() is None
    assert launches == (sweep.sbm_sweep.launches,
                        emit.twopass_emit.launches)
    for route in ("streaming", "csr"):
        out, k = ops.twopass_pairs_cuda(tE, tS, 3, route=route)
        assert k == 0 and bool((out == -1).all())
        assert ops.last_emit_route() is None
    with pytest.raises(ValueError, match="route must be one of"):
        ops.twopass_pairs_cuda(tS, tS, 4, route="bogus")


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the no-card error cannot occur")
    with pytest.raises(RuntimeError, match="CUDA device"):
        _build.load("sbm_sweep")
    with pytest.raises(RuntimeError, match="CUDA device"):
        _build.build_all()
