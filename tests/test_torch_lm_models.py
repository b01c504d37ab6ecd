"""The port's LM stack (``repro_torch.models``) against the JAX package's.

The ten smoke configs (dense, vlm, moe with GQA and with MLA, ssm,
hybrid and audio families) run with the reference's parameters, carried across by
``repro_torch.convert.lm_params_from_numpy``, on the same token ids (a
NumPy seed): teacher-forced ``forward`` logits, ``prefill`` followed by
``decode_step`` logits, the filled caches (``lm_cache_to_numpy``) and
greedy tokens (in float32: bf16 logits may break a near tie the other
way within their tolerance).  The audio config's encoder reads the same
NumPy-seeded frame embeddings in both.  The port's own cache path is
also held to its forward; for MLA at ``mla_absorb=False``, since the
absorbed decode is another association of the same products (the
reference's ``tests/test_models.py`` does the same).  Zamba2's smoke config also runs past its
window plus sink (64 + 16 tokens), where the window mask bites, through
the masked and the ``window_gather_decode`` read.

Tolerances: in float32 (``dataclasses.replace(cfg, dtype="float32")``)
1e-4 absolute and relative; the measured worst over these configs is
about 4e-6 (products and exponentials summed in another order).  In
bfloat16 the reference's own ``rtol = atol = 5e-2``
(``tests/test_models.py``).  The reference is compiled with
``xla_allow_excess_precision`` off, so that XLA rounds every bf16
intermediate where the jaxpr says, as the port does: with the CPU
default, a fusion keeps some in float32, and the bf16 logits then differ
by up to 0.067 (zamba2) and 0.055 (one element of qwen3's 12,288); with
it off, by at most 0.018 (qwen2, whose RoPE at theta 1e6 takes cos and
sin one float32 ulp apart) and 0.0 on zamba2.  Each reference run is
computed once per module (``_run``).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import transformer as T  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import (lm_cache_to_numpy,  # noqa: E402
                                 lm_params_from_numpy)
from repro_torch.models import transformer as PT  # noqa: E402

PORTED = ("qwen2_0_5b", "llama3_2_3b", "yi_9b", "qwen3_14b", "zamba2_2_7b",
          "chameleon_34b", "mamba2_780m", "deepseek_v2_236b",
          "phi3_5_moe_42b", "whisper_medium")
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# XLA rounds each bf16 intermediate as the jaxpr says (see above); at
# backend optimization level 0 the reference compiles in about 3/4 of
# the time, with the same differences to the port
XLA_OPTS = {"xla_allow_excess_precision": False,
            "xla_backend_optimization_level": 0}
B, S, N_PRE, GREEDY = 2, 24, 12, 8


def _configs(arch, dtype, **over):
    return (dataclasses.replace(ref_smoke(arch), dtype=dtype, **over),
            dataclasses.replace(get_smoke_config(arch), dtype=dtype, **over))


def _f32(x):
    return np.asarray(x, dtype=np.float32)


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(XLA_OPTS)


def _frames(cfg, batch):
    """Frame embeddings (B, enc_frames, d) float32 for the audio family's
    encoder, else None."""
    if cfg.family != "audio":
        return None
    rng = np.random.default_rng(7)
    return (0.1 * rng.standard_normal((batch, cfg.enc_frames, cfg.d_model))
            ).astype(np.float32)


def _ref_forward(cfg, params, tokens):
    tok = jnp.asarray(tokens, jnp.int32)
    fr = _frames(cfg, tokens.shape[0])
    return _f32(_compiled(lambda p, t, f: T.forward(p, t, cfg, frames=f)[0],
                          params, tok, fr)(params, tok, fr))


def _ref_decode(cfg, params, tokens, n_pre):
    """prefill+decode logits, the final cache and greedy tokens from the
    prefix, by the JAX package (jitted as its tests do)."""
    tok = jnp.asarray(tokens, jnp.int32)
    Bt, St = tokens.shape
    fr = _frames(cfg, Bt)
    cache = T.init_cache(cfg, Bt, St + 8)
    pre = _compiled(lambda p, t, c, f: T.prefill(p, t, cfg, c, frames=f),
                    params, tok[:, :n_pre], cache, fr)
    step = _compiled(lambda p, t, c, i: T.decode_step(p, t, cfg, c, i),
                     params, tok[:, :1], cache, jnp.int32(0))
    lg, c2 = pre(params, tok[:, :n_pre], cache, fr)
    _, cache = pre(params, tok[:, :n_pre], T.init_cache(cfg, Bt, St + 8), fr)
    dec = []
    for i in range(n_pre, St):
        out, cache = step(params, tok[:, i:i + 1], cache, jnp.int32(i))
        dec.append(_f32(out))
    greedy = []
    for i in range(GREEDY):
        t = jnp.argmax(lg, axis=-1).astype(jnp.int32)[:, None]
        greedy.append(np.asarray(t))
        lg, c2 = step(params, t, c2, jnp.int32(n_pre + i))
    return {"decode": np.stack(dec, 1), "cache": jax.tree.map(_f32, cache),
            "greedy": np.concatenate(greedy, 1)}


def _port_frames(cfg, batch):
    fr = _frames(cfg, batch)
    return None if fr is None else torch.from_numpy(fr)


def _port_forward(cfg, model, tokens):
    with torch.no_grad():
        return PT.forward(model, torch.from_numpy(tokens), cfg,
                          frames=_port_frames(cfg, tokens.shape[0]))[0].numpy()


def _port_decode(cfg, model, tokens, n_pre):
    tok = torch.from_numpy(tokens)
    Bt, St = tokens.shape
    fr = _port_frames(cfg, Bt)
    lg, c2 = PT.prefill(model, tok[:, :n_pre], cfg,
                        PT.init_cache(cfg, Bt, St + 8, "cpu"), fr)
    _, cache = PT.prefill(model, tok[:, :n_pre], cfg,
                          PT.init_cache(cfg, Bt, St + 8, "cpu"), fr)
    dec = []
    for i in range(n_pre, St):
        out, cache = PT.decode_step(model, tok[:, i:i + 1], cfg, cache, i)
        dec.append(out.numpy())
    greedy = []
    for i in range(GREEDY):
        t = torch.argmax(lg, dim=-1)[:, None]
        greedy.append(t.numpy())
        lg, c2 = PT.decode_step(model, t, cfg, c2, n_pre + i)
    return {"decode": np.stack(dec, 1),
            "cache": lm_cache_to_numpy(cfg, cache),
            "greedy": np.concatenate(greedy, 1)}


@functools.cache
def _ref_params(arch):
    # parameters are float32 masters whatever cfg.dtype; jitted, they
    # equal the eager init and take half its time
    return jax.jit(T.init_params, static_argnums=0)(ref_smoke(arch),
                                                     jax.random.PRNGKey(0))


def _both(arch, ref_cfg, cfg, tokens, n_pre, forward=True):
    """(reference, port) results on the reference's parameters."""
    params = _ref_params(arch)
    model = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                 "cpu")
    want = _ref_decode(ref_cfg, params, tokens, n_pre)
    got = _port_decode(cfg, model, tokens, n_pre)
    if forward:
        want["forward"] = _ref_forward(ref_cfg, params, tokens)
        got["forward"] = _port_forward(cfg, model, tokens)
    return want, got


def _tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape)


@functools.cache
def _run(arch, dtype):
    ref_cfg, cfg = _configs(arch, dtype)
    tokens = _tokens(cfg.vocab, (B, S))
    want, got = _both(arch, ref_cfg, cfg, tokens, N_PRE)
    # the port's own cache path against its forward; MLA's absorbed
    # decode drifts from the expanded read by up to ~5e-2 in bf16 (the
    # reference's tests/test_models.py), so MLA checks its expanded read
    own = cfg if not cfg.mla else dataclasses.replace(cfg, mla_absorb=False)
    model = (None if own is cfg else lm_params_from_numpy(
        own, jax.tree.map(np.asarray, _ref_params(arch)), "cpu"))
    got["own"] = ((got["decode"], got["forward"]) if model is None else
                  (_port_decode(own, model, tokens, N_PRE)["decode"],
                   _port_forward(own, model, tokens)))
    return dtype, want, got


@pytest.fixture(params=[(a, d) for a in PORTED
                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def run(request):
    return _run(*request.param)


def _close(got, want, dtype):
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


def test_forward_logits_match_reference(run):
    dtype, want, got = run
    assert got["forward"].shape == (B, S, want["forward"].shape[-1])
    _close(got["forward"], want["forward"], dtype)


def test_prefill_then_decode_logits_match_reference(run):
    dtype, want, got = run
    _close(got["decode"], want["decode"], dtype)
    # and the port's own cache path reproduces its teacher-forced logits
    decode, forward = got["own"]
    _close(decode, forward[:, N_PRE:], dtype)


def test_filled_caches_match_reference(run):
    dtype, want, got = run
    assert jax.tree.structure(got["cache"]) == \
        jax.tree.structure(want["cache"])
    for a, b in zip(jax.tree.leaves(got["cache"]),
                    jax.tree.leaves(want["cache"])):
        assert a.shape == b.shape
        _close(a, b, dtype)


@pytest.mark.parametrize("arch", PORTED)
def test_greedy_tokens_equal_in_float32(arch):
    _, want, got = _run(arch, "float32")
    assert want["greedy"].shape == (B, GREEDY)
    np.testing.assert_array_equal(got["greedy"], want["greedy"])


@functools.cache
def _past_window(gather, dtype):
    # the teacher-forced forward reads no cache: the masked run has it
    ref_cfg, cfg = _configs("zamba2_2_7b", dtype,
                            window_gather_decode=gather)
    assert cfg.window + cfg.n_sink_blocks * cfg.block_kv == 80
    return _both("zamba2_2_7b", ref_cfg, cfg,
                 _tokens(cfg.vocab, (B, 96), seed=5), 84, forward=not gather)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gather", [False, True], ids=["masked", "gather"])
def test_zamba2_past_window_and_sink_matches_reference(gather, dtype):
    want, got = _past_window(gather, dtype)
    masked = _past_window(False, dtype)
    _close(masked[1]["forward"], masked[0]["forward"], dtype)
    _close(got["decode"], want["decode"], dtype)
    # the decode past the window reproduces the masked teacher-forced
    # forward, in the port as in the reference
    _close(got["decode"], masked[1]["forward"][:, 84:], dtype)
    for a, b in zip(jax.tree.leaves(got["cache"]),
                    jax.tree.leaves(want["cache"])):
        _close(a, b, dtype)
    if dtype == "float32":
        np.testing.assert_array_equal(got["greedy"], want["greedy"])
