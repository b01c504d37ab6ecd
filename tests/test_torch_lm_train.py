"""The port's training half of the LM stack against the JAX package's.

``loss_fn`` (value, ``ce``, ``aux``) and every parameter's gradient
against ``jax.value_and_grad(repro.models.transformer.loss_fn)`` for all
ten smoke configs in float32, on the reference's parameters
(``lm_params_from_numpy``) and the same NumPy-seeded tokens (and frames
for the audio family).  ``ce_chunk`` is 7 against S = 24, so the chunks
do not divide S and the padded labels run; ``q_chunk`` is 8, so
attention runs three query chunks, each under its checkpoint (32 audio
frames: four).  Tolerance: 1e-4 absolute
and relative; the measured worst is about 2.3e-6 relative (the sums in
another order).  The reference is compiled with
``xla_allow_excess_precision`` off, as ``tests/test_torch_lm_models.py``
does, and with ``remat`` off (the same values, a shorter compile); each
reference run is computed once per module.

Also: gradients with remat on and off bit for bit (the port recomputes
the same ops); ``forward(return_features=True)`` against the logits;
``lm_params_to_numpy`` as the exact inverse of ``lm_params_from_numpy``
and of the reference's tree; the AdamW state's two directions;
``make_train_step`` at ``grad_accum`` 1 and 2 against the reference's;
``SyntheticTokens`` byte-equal to the reference's; the prefill and
decode step factories against the reference's; ``launch.steps``'
meta-device stand-ins against the reference's ``ShapeDtypeStruct``s.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.data.pipeline import DataConfig as RDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticTokens as RTokens  # noqa: E402
from repro.launch import steps as RS  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro.optim import AdamWConfig as RAdamW  # noqa: E402
from repro.optim import adamw_init as r_adamw_init  # noqa: E402

from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import (lm_params_from_numpy,  # noqa: E402
                                 lm_params_to_numpy, named_to_tree,
                                 opt_state_from_numpy, opt_state_to_numpy)
from repro_torch.data.pipeline import DataConfig, SyntheticTokens  # noqa: E402
from repro_torch.launch import steps as PS  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402

ARCHS = ("qwen2_0_5b", "llama3_2_3b", "yi_9b", "qwen3_14b", "zamba2_2_7b",
         "chameleon_34b", "mamba2_780m", "deepseek_v2_236b",
         "phi3_5_moe_42b", "whisper_medium")
TOL = 1e-4
XLA_OPTS = {"xla_allow_excess_precision": False,
            "xla_backend_optimization_level": 0}
B, S1, CE_CHUNK, Q_CHUNK = 2, 25, 7, 8  # tokens (B, S + 1): S = 24


def _configs(arch, **over):
    kw = dict(dtype="float32", ce_chunk=CE_CHUNK, q_chunk=Q_CHUNK, **over)
    return (dataclasses.replace(ref_smoke(arch), remat=False, **kw),
            dataclasses.replace(get_smoke_config(arch), **kw))


@functools.lru_cache(maxsize=None)
def _params(arch):
    rc, _ = _configs(arch)
    return jax.tree.map(np.asarray, T.init_params(rc, jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _batch(arch):
    rc, _ = _configs(arch)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, rc.vocab, (B, S1)).astype(np.int32)}
    if rc.family == "audio":
        batch["frames"] = (0.1 * rng.standard_normal(
            (B, rc.enc_frames, rc.d_model))).astype(np.float32)
    return batch


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(arch):
    rc, _ = _configs(arch)
    params, batch = _params(arch), jax.tree.map(jnp.asarray, _batch(arch))
    fn = jax.jit(lambda p, b: jax.value_and_grad(
        lambda q: T.loss_fn(q, b, rc), has_aux=True)(p))
    (loss, metrics), grads = fn.lower(params, batch).compile(XLA_OPTS)(
        params, batch)
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, grads))


def _port_grads(cfg, model, batch):
    loss, metrics, grads = PS.loss_and_grads(model, _tb(batch), cfg)
    return loss, metrics, grads


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    want_loss, want_m, want_g = _ref_value_and_grad(arch)
    _, pc = _configs(arch)
    model = lm_params_from_numpy(pc, _params(arch), "cpu")
    loss, metrics, grads = _port_grads(pc, model, _batch(arch))
    np.testing.assert_allclose(float(loss), want_loss, rtol=TOL, atol=TOL)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(metrics[k]), want_m[k], rtol=TOL,
                                   atol=TOL)
    got = named_to_tree({n: g.numpy() for n, g in grads.items()})
    flat_w, tree_w = jax.tree_util.tree_flatten_with_path(want_g)
    flat_g, tree_g = jax.tree_util.tree_flatten_with_path(got)
    assert tree_w == tree_g
    for (path, w), (_, g) in zip(flat_w, flat_g):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_are_bit_equal(arch):
    _, pc = _configs(arch)
    model = lm_params_from_numpy(pc, _params(arch), "cpu")
    outs = [_port_grads(dataclasses.replace(pc, remat=r), model,
                        _batch(arch)) for r in (False, True)]
    (l0, m0, g0), (l1, m1, g1) = outs
    assert torch.equal(l0, l1)
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(g0[n], g1[n]) for n in g0)


@pytest.mark.parametrize("arch", ["zamba2_2_7b", "deepseek_v2_236b",
                                  "whisper_medium"])
def test_features_project_to_the_logits(arch):
    _, pc = _configs(arch)
    model = lm_params_from_numpy(pc, _params(arch), "cpu")
    b = _tb(_batch(arch))
    tok = b["tokens"][:, :-1]
    with torch.no_grad():
        logits, _, aux = PT.forward(model, tok, pc, frames=b.get("frames"))
        feats, _, aux2 = PT.forward(model, tok, pc, frames=b.get("frames"),
                                    return_features=True)
    assert feats.shape == tok.shape + (pc.d_model,)
    assert torch.equal(PT._project_logits(model, feats, pc), logits)
    assert torch.equal(aux, aux2)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_to_numpy_inverts_from_numpy(arch):
    _, pc = _configs(arch)
    tree = _params(arch)
    back = lm_params_to_numpy(pc, lm_params_from_numpy(pc, tree, "cpu"))
    flat_w, tw = jax.tree_util.tree_flatten(tree)
    flat_g, tg = jax.tree_util.tree_flatten(back)
    assert tw == tg
    for w, g in zip(flat_w, flat_g):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_opt_state_round_trips_in_the_reference_layout():
    arch = "zamba2_2_7b"
    rc, pc = _configs(arch)
    model = lm_params_from_numpy(pc, _params(arch), "cpu")
    named = dict(model.named_parameters())
    state = adamw_init(named)
    gen = torch.Generator().manual_seed(0)
    for k in ("m", "v"):
        for t in state[k].values():
            t.copy_(torch.rand(t.shape, generator=gen))
    state["step"] += 7
    tree = opt_state_to_numpy(state)
    want = jax.tree.map(np.asarray, r_adamw_init(_params(arch)))
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    assert all(a.shape == b.shape and a.dtype == b.dtype for a, b in
               zip(jax.tree.leaves(tree), jax.tree.leaves(want)))
    back = opt_state_from_numpy(tree, named)
    assert back["step"].dtype == torch.int32 and int(back["step"]) == 7
    for k in ("m", "v"):
        assert all(torch.equal(back[k][n], state[k][n]) for n in named)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(accum):
    arch = "llama3_2_3b"
    rc, pc = _configs(arch, grad_accum=accum)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, rc.vocab, (4, 33)).astype(np.int32)
    kw = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    params = _params(arch)
    r_step = jax.jit(RS.make_train_step(rc, RAdamW(**kw)))
    rp, ro, rm = r_step.lower(params, r_adamw_init(params),
                              {"tokens": tokens}).compile(XLA_OPTS)(
        params, r_adamw_init(params), {"tokens": tokens})
    model = lm_params_from_numpy(pc, params, "cpu")
    opt = adamw_init(dict(model.named_parameters()))
    model, opt, pm = PS.make_train_step(pc, AdamWConfig(**kw))(
        model, opt, {"tokens": torch.from_numpy(tokens)})
    for k in ("loss", "ce", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(pm[k]), float(rm[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)
    assert int(opt["step"]) == int(ro["step"]) == 1
    got_m = opt_state_to_numpy(opt)["m"]
    for w, g in zip(jax.tree.leaves(ro["m"]), jax.tree.leaves(got_m)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=TOL, atol=1e-7)
    # step 1: delta = g/(|g| + eps); a gradient near eps amplifies a 1e-7
    # difference to lr, so the parameters are held to lr/10 absolute
    got_p = lm_params_to_numpy(pc, model)
    for w, g in zip(jax.tree.leaves(rp), jax.tree.leaves(got_p)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0,
                                   atol=kw["lr"] / 10)


def test_grad_accumulation_is_the_mean_gradient():
    arch = "qwen2_0_5b"
    _, p1 = _configs(arch)
    p2 = dataclasses.replace(p1, grad_accum=2)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, p1.vocab, (4, 17)).astype(np.int32))
    grads = {}
    for cfg in (p1, p2):
        model = lm_params_from_numpy(cfg, _params(arch), "cpu")
        seen = {}

        def spy(params, g, state, ocfg, seen=seen):
            seen.update(g)
            return params, state, {"grad_norm": torch.zeros(()),
                                   "lr": torch.zeros(())}
        step = PS.make_train_step(cfg, AdamWConfig())
        orig, PS.adamw_update = PS.adamw_update, spy
        try:
            step(model, adamw_init(dict(model.named_parameters())),
                 {"tokens": tokens})
        finally:
            PS.adamw_update = orig
        grads[cfg.grad_accum] = seen
    for n, g in grads[1].items():
        torch.testing.assert_close(grads[2][n], g, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("seed,n_hosts", [(0, 1), (5, 4), (123, 2)])
def test_synthetic_tokens_byte_equal(seed, n_hosts):
    kw = dict(vocab=101, seq_len=16, global_batch=8, seed=seed,
              n_hosts=n_hosts)
    ref, port = RTokens(RDataConfig(**kw)), SyntheticTokens(DataConfig(**kw))
    for step in (0, 1, 3, 7, 1000):
        for host in range(n_hosts):
            a, b = ref.batch(step, host), port.batch(step, host)
            assert a.dtype == b.dtype == np.int32
            assert a.tobytes() == b.tobytes()
        assert port.global_batch(step).tobytes() == \
            ref.global_batch(step).tobytes()
    with pytest.raises(ValueError):
        SyntheticTokens(DataConfig(vocab=11, seq_len=4, global_batch=6,
                                   n_hosts=4))


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_structs_match_reference(arch):
    rc, pc = ref_config(arch), get_config(arch)

    def spec(s):
        return (tuple(s.shape), str(s.dtype).replace("torch.", ""))
    for name, shape in SHAPES.items():
        want = RS.input_structs(rc, REF_SHAPES[name])
        got = PS.input_structs(pc, shape)
        assert all(t.device.type == "meta" for t in got.values())
        assert {k: spec(v) for k, v in got.items()} == \
            {k: spec(v) for k, v in want.items()}
    want = RS.abstract_params(rc)
    model = PS.abstract_params(pc)
    got = named_to_tree(dict(model.named_parameters()))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert [spec(t) for t in jax.tree.leaves(got)] == \
        [spec(t) for t in jax.tree.leaves(want)]
    opt = PS.abstract_opt(pc)
    assert opt["step"].dtype == torch.int32
    assert sum(t.numel() for t in opt["m"].values()) == \
        sum(t.numel() for t in model.parameters())
    cache = PS.abstract_cache(pc, SHAPES["decode_32k"])
    assert all(t.device.type == "meta" for t in jax.tree.leaves(cache))


def test_prefill_and_decode_steps_match_reference():
    arch = "zamba2_2_7b"
    rc, pc = _configs(arch)
    params = _params(arch)
    tok = _batch(arch)["tokens"]
    P = 12
    r_pre = jax.jit(RS.make_prefill_step(rc))
    r_dec = jax.jit(RS.make_decode_step(rc))
    rl, rcache = r_pre(params, T.init_cache(rc, B, S1),
                       {"tokens": jnp.asarray(tok[:, :P])})
    rl2, _ = r_dec(params, rcache, {"tokens": jnp.asarray(tok[:, P:P + 1]),
                                    "cur_len": jnp.int32(P)})
    model = lm_params_from_numpy(pc, params, "cpu")
    pl, pcache = PS.make_prefill_step(pc)(
        model, PT.init_cache(pc, B, S1, "cpu"),
        {"tokens": torch.from_numpy(tok[:, :P])})
    pl2, _ = PS.make_decode_step(pc)(
        model, pcache, {"tokens": torch.from_numpy(tok[:, P:P + 1]),
                        "cur_len": torch.tensor(P, dtype=torch.int32)})
    np.testing.assert_allclose(pl.numpy(), np.asarray(rl), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(pl2.numpy(), np.asarray(rl2), rtol=TOL,
                               atol=TOL)
