"""The port's LM layers against the JAX package's, function by function.

``rmsnorm``, ``rope_angles``/``apply_rope``, ``chunked_sdpa`` (causal,
window + sink, gathered rows with ``kv_pos``/``kv_allowed``, fully
masked rows), ``_causal_conv`` with and without a carried state and
``_ssd_chunked`` with and without ``h0`` and a ragged last chunk, each on
the same NumPy-seeded inputs, in float32 and bfloat16.  The reference
runs op by op (not jitted), so it rounds every bf16 intermediate where
its code says, as the port does.  Tolerances, absolute and relative:
float32 1e-5 (measured at most 4.8e-6, on the SSD's outputs of size
~25), bfloat16 2^-8, one unit of bf16 rounding (measured 0: the port
rounds in the same places).  Also: every config of the port equal to
the reference's field by field, with equal ``n_params``; the cache write
refusing to run past the cache; ``init_params`` drawing from its
generator, for Zamba2 and for the MoE, MLA and audio configs.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import ssm as RS  # noqa: E402
from repro.models import transformer as RT  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.models import attention as PA  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import ssm as PS  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2 ** -8)}


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _pair(a, dtype):
    """The same values as a reference array and a port tensor."""
    jd, td, _ = DTYPES[dtype]
    a = np.asarray(a, np.float32)
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _close(got, want, dtype):
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm(dtype):
    rng = np.random.default_rng(0)
    x = 3 * rng.standard_normal((2, 24, 64))
    scale = rng.standard_normal(64).astype(np.float32)
    p = PL.rmsnorm_init(64, "cpu")
    p.scale.copy_(torch.from_numpy(scale))
    jx, tx = _pair(x, dtype)
    _close(PL.rmsnorm(p, tx, 1e-5),
           RL.rmsnorm({"scale": jnp.asarray(scale)}, jx, 1e-5), dtype)


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rope(dtype, theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 24, 4, 16))
    pos = np.arange(24) + 40
    rc, rs = RL.rope_angles(jnp.asarray(pos), 16, theta)
    pc, ps = PL.rope_angles(torch.from_numpy(pos), 16, theta)
    # cos and sin of the same float32 angles, within one float32 ulp
    np.testing.assert_allclose(pc.numpy(), np.asarray(rc), atol=1.2e-7)
    np.testing.assert_allclose(ps.numpy(), np.asarray(rs), atol=1.2e-7)
    jx, tx = _pair(x, dtype)
    # the rotation on the same tables: halves rotated, in float32
    _close(PL.apply_rope(tx, torch.from_numpy(np.array(rc)),
                         torch.from_numpy(np.array(rs))),
           RL.apply_rope(jx, rc, rs), dtype)


SDPA_CASES = {
    "causal": dict(),
    "window_sink": dict(window=8, sink=4),
    "not_causal": dict(causal=False),
    # no key is valid: every row is fully masked and comes out 0
    "masked_rows": dict(valid=0),
}


@pytest.mark.parametrize("case", SDPA_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_chunked_sdpa(dtype, case):
    rng = np.random.default_rng(2)
    B, Sq, H, G, dh = 2, 40, 2, 2, 16
    q, k, v = (rng.standard_normal(s) for s in
               ((B, Sq, H, G, dh), (B, Sq, H, dh), (B, Sq, H, dh)))
    kw = dict(SDPA_CASES[case])
    valid = kw.pop("valid", Sq)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    want = RA.chunked_sdpa(jq, jk, jv, jnp.arange(Sq), valid, q_chunk=16,
                           **kw)
    got = PA.chunked_sdpa(tq, tk, tv, torch.arange(Sq), valid, q_chunk=16,
                          **kw)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (B, Sq, H, G, dh)
    _close(got, want, dtype)
    if case == "masked_rows":
        assert not got.float().abs().sum()


@pytest.mark.parametrize("dtype", DTYPES)
def test_chunked_sdpa_gathered_rows(dtype):
    # the gather decode's rows: sink [0, 4) then the window of the query
    # at position 13, whose first rows repeat sink rows
    rng = np.random.default_rng(3)
    B, H, G, dh, Smax, pos = 2, 2, 2, 16, 24, 13
    k_all, v_all = (rng.standard_normal((B, Smax, H, dh)) for _ in "kv")
    q = rng.standard_normal((B, 1, H, G, dh))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k_all,
                                                             v_all))
    k_cat, v_cat, kv_pos, allowed = PA.window_gather(tk, tv, pos, 12, 4)
    assert kv_pos.tolist() == [0, 1, 2, 3] + list(range(2, 14))
    assert allowed.tolist() == [True] * 4 + [False] * 2 + [True] * 10
    want = RA.chunked_sdpa(
        jq, jnp.concatenate([jk[:, :4], jk[:, 2:14]], 1),
        jnp.concatenate([jv[:, :4], jv[:, 2:14]], 1), jnp.asarray([pos]),
        pos + 1, kv_pos=jnp.asarray(kv_pos.numpy()),
        kv_allowed=jnp.asarray(allowed.numpy()))
    got = PA.chunked_sdpa(tq, k_cat, v_cat, torch.tensor([pos]), pos + 1,
                          kv_pos=kv_pos, kv_allowed=allowed)
    _close(got, want, dtype)
    # and it equals the masked read of the whole cache
    masked = PA.chunked_sdpa(tq, tk, tv, torch.tensor([pos]), pos + 1,
                             window=12, sink=4)
    _close(got, masked.float().numpy(), dtype)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_conv(dtype, with_state):
    rng = np.random.default_rng(4)
    xbc = rng.standard_normal((2, 24, 48))
    w = (0.5 * rng.standard_normal((4, 48))).astype(np.float32)
    b = (0.1 * rng.standard_normal(48)).astype(np.float32)
    jx, tx = _pair(xbc, dtype)
    js, ts = (_pair(rng.standard_normal((2, 3, 48)), dtype) if with_state
              else (None, None))
    want, want_state = RS._causal_conv(jx, jnp.asarray(w), jnp.asarray(b),
                                       js)
    got, got_state = PS._causal_conv(tx, torch.from_numpy(w),
                                     torch.from_numpy(b), ts)
    _close(got, want, dtype)
    _close(got_state, want_state, dtype)


@pytest.mark.parametrize("s,with_h0", [(48, False), (37, False), (37, True),
                                       (5, True)],
                         ids=["whole_chunks", "ragged", "ragged_h0",
                              "one_short_chunk"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_chunked(dtype, s, with_h0):
    rng = np.random.default_rng(5)
    b, h, p, n = 2, 3, 8, 5
    xdt = rng.standard_normal((b, s, h, p)).astype(np.float32)
    a = (-0.3 * np.abs(rng.standard_normal((b, s, h)))).astype(np.float32)
    (jB, tB), (jC, tC) = (_pair(rng.standard_normal((b, s, n)), dtype)
                          for _ in "BC")
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    want, want_last = RS._ssd_chunked(
        jnp.asarray(xdt), jnp.asarray(a), jB, jC, 16,
        jnp.asarray(h0) if with_h0 else None)
    got, got_last = PS._ssd_chunked(
        torch.from_numpy(xdt), torch.from_numpy(a), tB, tC, 16,
        torch.from_numpy(h0) if with_h0 else None)
    # float32 outputs whatever the inputs' dtype
    _close(got, want, "float32")
    _close(got_last, want_last, "float32")


@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_configs_equal_reference(arch):
    for getter in ("get_config", "get_smoke_config"):
        got = getattr(configs, getter)(arch)
        want = getattr(ref_configs, getter)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.n_params() == want.n_params()
        assert (got.d_inner, got.n_ssm_heads, got.group_size) == \
            (want.d_inner, want.n_ssm_heads, want.group_size)
    for shape in ref_configs.SHAPES:
        assert configs.shape_applicable(arch, shape) == \
            ref_configs.shape_applicable(arch, shape)
    assert configs.ALIASES == ref_configs.ALIASES
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in ref_configs.SHAPES.items()}


def test_cache_write_past_max_len_raises():
    # the reference's dynamic_update_slice clamps the start, so a write
    # past the end lands on the last rows; the port refuses it
    buf = np.zeros((1, 8, 1, 2), np.float32)
    new = np.ones((1, 3, 1, 2), np.float32)
    ref = RA._cache_write({"k": jnp.asarray(buf)}, {"k": jnp.asarray(new)},
                          7)["k"]
    assert np.asarray(ref)[0, :, 0, 0].tolist() == [0] * 5 + [1] * 3
    cache = {"k": torch.from_numpy(buf)}
    with pytest.raises(ValueError, match="outside the cache's 8 positions"):
        PA._cache_write(cache, {"k": torch.from_numpy(new)}, 7)
    PA._cache_write(cache, {"k": torch.from_numpy(new)}, 5)
    assert cache["k"][0, :, 0, 0].tolist() == [0] * 5 + [1] * 3


def test_init_params_draws_from_the_generator():
    cfg = configs.get_smoke_config("zamba2_2_7b")
    a, b, c = (PT.init_params(cfg, torch.Generator().manual_seed(s), "cpu")
               for s in (0, 0, 1))
    shapes = jax.eval_shape(lambda: RT.init_params(
        ref_configs.get_smoke_config("zamba2_2_7b"), jax.random.PRNGKey(0)))
    assert sum(p.numel() for p in a.parameters()) == \
        sum(x.size for x in jax.tree.leaves(shapes))
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert pa.dtype == torch.float32 and torch.equal(pa, pb), name
    w = a.shared_block.attn.wq.w
    assert not torch.equal(w, c.shared_block.attn.wq.w)
    # ±3σ truncated normal at d_in^-0.5
    assert w.abs().max() <= 3 * cfg.d_model ** -0.5
    assert abs(w.std().item() * cfg.d_model ** 0.5 - 0.986) < 0.05


@pytest.mark.parametrize("arch", ["deepseek_v2_236b", "phi3_5_moe_42b",
                                  "whisper_medium"])
def test_init_params_of_moe_mla_and_audio(arch):
    # every reference leaf has its port parameter, each drawn (or set)
    # as the reference's init sets it: the experts at d^-0.5, w_down at
    # f^-0.5 / sqrt(2L), enc_pos at 0.02, norms at 1
    cfg = configs.get_smoke_config(arch)
    model = PT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shapes = jax.eval_shape(lambda: RT.init_params(
        ref_configs.get_smoke_config(arch), jax.random.PRNGKey(0)))
    assert sum(p.numel() for p in model.parameters()) == \
        sum(x.size for x in jax.tree.leaves(shapes))
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and bool(torch.isfinite(p).all())
        if name.endswith(("scale",)):
            assert bool((p == 1).all()), name
        elif not name.endswith(".b"):
            assert float(p.std()) > 0, name
    if cfg.family == "moe":
        moe = model.moe_layers[0].moe
        d, f = cfg.d_model, cfg.moe_d_ff
        assert moe.w_gate.abs().max() <= 3 * d ** -0.5
        assert moe.w_down.abs().max() <= \
            3 * f ** -0.5 / (2 * cfg.n_layers) ** 0.5
        assert (moe.shared is None) == (cfg.n_shared_experts == 0)
        assert len(model.dense_layers) == cfg.first_dense_layers
    else:
        assert model.enc_pos.shape == (cfg.enc_frames, cfg.d_model)
        assert model.enc_pos.abs().max() <= 3 * 0.02
