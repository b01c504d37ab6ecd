"""The port's optimizer substrate (``repro_torch.optim``) against the JAX
package's ``repro.optim``.

AdamW over five steps on a small tree of mixed shapes (float32 leaves
and one bf16 gradient), from the same NumPy-seeded parameters and
gradients: the moments and ``grad_norm``/``lr`` within 1e-5 relative
(float32 sums in another order), the parameters within 1e-5 plus lr/100
absolute.  The update divides m̂ by sqrt(v̂) + eps, so an element whose
|g| is near eps turns a 1e-7 difference in its gradient into an
lr-sized one in the parameter (the reference's own
``tests/test_optim.py::test_grad_accumulation_matches_monolithic`` meets
it too); these gradients stay far from eps.  The cosine schedule and
global-norm clipping against the reference's; the int8 quantizer bit for
bit on shared NumPy uniforms (``jax.random.uniform`` replaced for the
reference's call, since JAX's draws cannot be reproduced), and
``compress_int8`` itself to the reference's statistical test.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as R  # noqa: E402
from repro.optim import compress as RC  # noqa: E402

from repro_torch import optim as P  # noqa: E402
from repro_torch.optim import compress as PC  # noqa: E402

SHAPES = {"a": (13, 5), "b": (7,), "c": (4, 3, 2), "d": ()}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _pt(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _close(got, want, rtol=1e-5, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("clip", [1.0, 1e9], ids=["clipped", "unclipped"])
def test_adamw_five_steps_match_reference(clip):
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=clip)
    rc, pc = R.AdamWConfig(**cfg_kw), P.AdamWConfig(**cfg_kw)
    params = _tree(0)
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    pp = _pt(params)
    rs, ps = R.adamw_init(rp), P.adamw_init(pp)
    for i in range(5):
        grads = _tree(10 + i, scale=0.5)
        rg = {k: jnp.asarray(v) for k, v in grads.items()}
        # one bf16 gradient: the clip rounds it back to bf16
        rg["b"] = rg["b"].astype(jnp.bfloat16)
        pg = _pt(grads)
        pg["b"] = pg["b"].to(torch.bfloat16)
        rp, rs, rm = R.adamw_update(rp, rg, rs, rc)
        pp, ps, pm = P.adamw_update(pp, pg, ps, pc)
        assert int(ps["step"]) == int(rs["step"]) == i + 1
        assert ps["step"].dtype == torch.int32
        _close(pm["grad_norm"], rm["grad_norm"])
        _close(pm["lr"], rm["lr"])
        for k in SHAPES:
            _close(ps["m"][k], rs["m"][k], atol=1e-7)
            _close(ps["v"][k], rs["v"][k], atol=1e-9)
            _close(pp[k], rp[k], atol=1e-5 + cfg_kw["lr"] / 100)


def test_adamw_updates_in_place():
    params = _pt(_tree(0))
    before = {k: v.clone() for k, v in params.items()}
    state = P.adamw_init(params)
    m = state["m"]["a"]
    out, state2, _ = P.adamw_update(params, _pt(_tree(1)), state,
                                    P.AdamWConfig(warmup_steps=0))
    assert out["a"] is params["a"] and state2["m"]["a"] is m
    assert not torch.equal(params["a"], before["a"])
    assert state2["m"]["a"].dtype == torch.float32


def test_adamw_decreases_quadratic():
    cfg = P.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=100,
                        weight_decay=0.0, clip_norm=1e9)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = P.adamw_init(params)
    for _ in range(200):
        params, state, _ = P.adamw_update(params, {"w": 2 * params["w"]},
                                          state, cfg)
    assert float(params["w"].abs().max()) < 0.1


def test_weight_decay_decoupled():
    cfg = P.AdamWConfig(lr=0.1, warmup_steps=0, weight_decay=0.5,
                        clip_norm=1e9)
    params = {"w": torch.tensor([1.0])}
    p2, _, _ = P.adamw_update(params, {"w": torch.tensor([0.0])},
                              P.adamw_init(params), cfg)
    np.testing.assert_allclose(float(p2["w"][0]), 1.0 - 0.1 * 0.5,
                               rtol=1e-5)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 55, 100, 150])
def test_cosine_schedule_matches_reference(step):
    cfg = dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    want = float(R.cosine_schedule(R.AdamWConfig(**cfg), jnp.int32(step)))
    for s in (step, torch.tensor(step, dtype=torch.int32)):
        got = P.cosine_schedule(P.AdamWConfig(**cfg), s)
        assert got.dtype == torch.float32 and got.shape == ()
        _close(got, want, rtol=2e-7, atol=1e-7)


def test_schedule_warmup_and_floor():
    cfg = P.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                        min_lr_ratio=0.1)
    assert float(P.cosine_schedule(cfg, 0)) == 0.0
    assert abs(float(P.cosine_schedule(cfg, 10)) - 1.0) < 1e-6
    np.testing.assert_allclose(float(P.cosine_schedule(cfg, 100)), 0.1,
                               rtol=1e-5)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    tree = _tree(3)
    rt, rn = R.clip_by_global_norm({k: jnp.asarray(v)
                                    for k, v in tree.items()}, max_norm)
    pt, pn = P.clip_by_global_norm(_pt(tree), max_norm)
    _close(pn, rn)
    _close(P.global_norm(pt), R.global_norm(rt))
    for k in SHAPES:
        _close(pt[k], rt[k], atol=1e-7)
    tree = {"a": torch.ones(4) * 3.0}
    clipped, norm = P.clip_by_global_norm(tree, 1.0)
    assert float(norm) == pytest.approx(6.0, rel=1e-6)
    assert float(P.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)


@pytest.mark.parametrize("scale", [0.37, 1e-3, 0.0], ids=["wide", "narrow",
                                                          "zeros"])
def test_int8_quantizer_bit_equal_on_shared_uniforms(monkeypatch, scale):
    rng = np.random.default_rng(4)
    x = (scale * rng.standard_normal((64, 33))).astype(np.float32)
    rnd = rng.random(x.shape, dtype=np.float32)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape: jnp.asarray(rnd))
    rq, rs = RC.compress_int8(jnp.asarray(x), jax.random.PRNGKey(0))
    pq, ps = PC.quantize_int8(torch.from_numpy(x), torch.from_numpy(rnd))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pq.numpy(), np.asarray(rq))
    assert np.float32(ps) == np.float32(rs)
    np.testing.assert_array_equal(PC.decompress_int8(pq, ps).numpy(),
                                  np.asarray(RC.decompress_int8(rq, rs)))


def test_int8_compression_unbiased_and_bounded():
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(4096, generator=gen) * 0.37
    acc = torch.zeros_like(x)
    n = 64
    g = torch.Generator().manual_seed(0)
    for _ in range(n):
        q, s = P.compress_int8(x, g)
        assert int(q.abs().max()) <= 127
        acc = acc + P.decompress_int8(q, s)
    err = float((acc / n - x).abs().max())
    amax = float(x.abs().max())
    assert err < 0.3 * amax / 127 * math.sqrt(n) / n + 0.01
    q, s = P.compress_int8(x, g)
    assert float((P.decompress_int8(q, s) - x).abs().max()) <= float(s) + 1e-6


def test_compress_tree_roundtrip_shapes():
    tree = {"a": torch.ones((3, 5)), "c": torch.zeros((7,))}
    qs, scales = PC.compress_tree(tree, torch.Generator().manual_seed(0))
    assert list(qs) == list(tree) and list(scales) == list(tree)
    assert all(q.dtype == torch.int8 and q.shape == tree[k].shape
               for k, q in qs.items())
    out = PC.decompress_tree(qs, scales)
    assert {k: v.shape for k, v in out.items()} == \
        {k: v.shape for k, v in tree.items()}
    np.testing.assert_allclose(out["a"].numpy(), np.ones((3, 5)), atol=1e-2)
    np.testing.assert_array_equal(out["c"].numpy(), np.zeros(7))
