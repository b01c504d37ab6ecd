"""The port's CUDA kernels on the card, against their plain versions.

K1 (``csrc/sbm_sweep.cu``) and K2 (``csrc/emit.cu``) have no CPU mode,
so these tests carry the ``cuda`` marker and skip on a host without a
card.  The file imports neither JAX nor the JAX package, so it also runs
on the card host, which has no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because the repository's conftest clears JAX caches.)
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.core import MatchSpec, build_plan, paper_workload  # noqa: E402
from repro_torch.core import sbm  # noqa: E402
from repro_torch.kernels import emit, ref  # noqa: E402
from repro_torch.kernels import sbm_sweep as sweep  # noqa: E402

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


@pytest.mark.parametrize("T", [1, 2, 255, 2048, 2049, 6000, 1 << 17])
def test_sweep_kernel_matches_plain(card, T):
    rng = np.random.default_rng(T)
    is_lo = torch.from_numpy(rng.integers(0, 2, T).astype(np.int32)).to(card)
    is_upd = torch.from_numpy(rng.integers(0, 2, T).astype(np.int32)).to(card)
    before = sweep.sbm_sweep.launches
    got = sweep.sbm_sweep(is_lo, is_upd)
    torch.cuda.synchronize()
    assert sweep.sbm_sweep.launches == before + 1
    assert torch.equal(got, ref.sbm_sweep(is_lo, is_upd))


@pytest.mark.parametrize("case", ["paper_a50", "paper_a0.5", "ties"])
def test_emit_kernel_matches_plain(card, case):
    if case == "ties":
        S, U = _ties(card)
    else:
        S, U = paper_workload(4, 60_000, float(case[7:]), device=card)
    k = sbm.sbm_count_binary(S, U)
    for max_pairs in sorted({1, max(k // 3, 1), k, k + 100}):
        perm_s, perm_u, starts, counts, offs = sbm._twopass_phase1(
            S.lo[:, 0], S.hi[:, 0], U.lo[:, 0], U.hi[:, 0], max_pairs)[:5]
        t = (offs, counts, starts, perm_s, perm_u)
        before = emit.twopass_emit.launches
        got = emit.twopass_emit(*t, max_pairs=max_pairs)
        torch.cuda.synchronize()
        assert emit.twopass_emit.launches == before + 1
        assert torch.equal(got, ref.twopass_emit(*t, max_pairs=max_pairs))
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
