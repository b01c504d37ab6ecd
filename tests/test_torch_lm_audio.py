"""The port's audio encoder-decoder (Whisper's family) against the JAX
package's ``repro.models.transformer``.

Whisper-medium's smoke config (2 encoder and 2 decoder layers, 32
frames, d 64) on the reference's parameters, carried by
``repro_torch.convert.lm_params_from_numpy``, and the same NumPy-seeded
frame embeddings and token ids, in float32 and bfloat16: the cross
attention (``_cross_attn``: K/V from the encoder output, not causal, no
RoPE) on its own; the encoder's output (the port's ``_encode`` and the
``enc_out`` a prefill with frames leaves in the cache) at the full 32
frames and at 20, which reads only the first 20 rows of ``enc_pos``;
``forward`` with frames; and decode steps that read ``enc_out`` from the
cache (no frames), which must change when ``enc_out`` does.  The
reference is compiled with ``xla_allow_excess_precision`` off, as in
``tests/test_torch_lm_models.py``.  Tolerances: float32 1e-4, bfloat16
the reference's 5e-2.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.models import transformer as RT  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import attention as PA  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402

ARCH = "whisper_medium"
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}
XLA_OPTS = {"xla_allow_excess_precision": False,
            "xla_backend_optimization_level": 0}
B, S, N_PRE = 2, 12, 8


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _configs(dtype):
    return (dataclasses.replace(ref_smoke(ARCH), dtype=dtype),
            dataclasses.replace(get_smoke_config(ARCH), dtype=dtype))


@functools.cache
def _params():
    return jax.jit(RT.init_params, static_argnums=0)(ref_smoke(ARCH),
                                                     jax.random.PRNGKey(2))


def _model(cfg):
    return lm_params_from_numpy(cfg, jax.tree.map(np.asarray, _params()),
                                "cpu")


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(XLA_OPTS)(*args)


def _data(cfg, n_frames):
    rng = np.random.default_rng(17)
    frames = (0.1 * rng.standard_normal((B, n_frames, cfg.d_model))
              ).astype(np.float32)
    return frames, rng.integers(0, cfg.vocab, (B, S))


def _close(got, want, dtype):
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attn_matches_reference(dtype):
    ref_cfg, cfg = _configs(dtype)
    jd, td, _ = DTYPES[dtype]
    tree = jax.tree.map(np.asarray, RA.attn_init(jax.random.PRNGKey(5),
                                                 ref_cfg))
    p = PA.attn_init(cfg, generator=None, device="cpu")
    assert isinstance(p, PA.GQA)
    for name, param in p.named_parameters():
        a, b = name.split(".")
        param.copy_(torch.from_numpy(np.array(tree[a][b], np.float32)))
    rng = np.random.default_rng(9)
    xq = rng.standard_normal((B, 5, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, 32, cfg.d_model)).astype(np.float32)
    want, _ = RT._cross_attn(tree, jnp.asarray(xq).astype(jd),
                             jnp.asarray(enc).astype(jd), ref_cfg)
    got = PT._cross_attn(p, torch.from_numpy(xq).to(td),
                         torch.from_numpy(enc).to(td), cfg)
    assert got.dtype == td and got.shape == xq.shape
    _close(got.float(), want, dtype)


@pytest.mark.parametrize("n_frames", [32, 20])
@pytest.mark.parametrize("dtype", DTYPES)
def test_encoder_and_forward_with_frames_match_reference(dtype, n_frames):
    ref_cfg, cfg = _configs(dtype)
    td = DTYPES[dtype][1]
    params, model = _params(), _model(cfg)
    frames, tokens = _data(cfg, n_frames)
    tok = jnp.asarray(tokens, jnp.int32)
    want_logits = _compiled(
        lambda p, t, f: RT.forward(p, t, ref_cfg, frames=f)[0], params, tok,
        frames)
    want_enc = _compiled(
        lambda p, t, f: RT.prefill(p, t, ref_cfg,
                                   RT.init_cache(ref_cfg, B, S + 1),
                                   frames=f)[1]["enc_out"], params, tok,
        frames)
    fr = torch.from_numpy(frames)
    enc = PT._encode(model, fr, cfg, td)
    assert enc.dtype == td and enc.shape == (B, n_frames, cfg.d_model)
    _close(enc.float(), want_enc, dtype)
    cache = PT.init_cache(cfg, B, S + 1, "cpu")
    PT.prefill(model, torch.from_numpy(tokens), cfg, cache, fr)
    assert torch.equal(cache["enc_out"], enc)
    logits, _, aux = PT.forward(model, torch.from_numpy(tokens), cfg,
                                frames=fr)
    assert float(aux) == 0.0
    _close(logits, want_logits, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_reads_the_encoder_output_from_the_cache(dtype):
    ref_cfg, cfg = _configs(dtype)
    params, model = _params(), _model(cfg)
    frames, tokens = _data(cfg, cfg.enc_frames)
    tok = jnp.asarray(tokens, jnp.int32)
    cache = RT.init_cache(ref_cfg, B, S + 1)
    _, cache = _compiled(lambda p, t, c, f: RT.prefill(p, t, ref_cfg, c,
                                                       frames=f),
                         params, tok[:, :N_PRE], cache, frames)
    want = []
    for i in range(N_PRE, S):
        out, cache = _compiled(
            lambda p, t, c, j: RT.decode_step(p, t, ref_cfg, c, j), params,
            tok[:, i:i + 1], cache, jnp.int32(i))
        want.append(np.asarray(out, np.float32))
    t = torch.from_numpy(tokens)
    pc = PT.init_cache(cfg, B, S + 1, "cpu")
    PT.prefill(model, t[:, :N_PRE], cfg, pc, torch.from_numpy(frames))
    other = {k: ([dict((n, c.clone()) for n, c in d.items()) for d in v]
                 if isinstance(v, list) else v) for k, v in pc.items()}
    other["enc_out"] = torch.zeros_like(pc["enc_out"])
    for j, i in enumerate(range(N_PRE, S)):
        got, pc = PT.decode_step(model, t[:, i:i + 1], cfg, pc, i)
        _close(got, want[j], dtype)
        moved, other = PT.decode_step(model, t[:, i:i + 1], cfg, other, i)
        assert not torch.equal(moved, got)


def test_audio_decode_without_frames_or_encoder_output_raises():
    _, cfg = _configs("float32")
    model = _model(cfg)
    with pytest.raises(ValueError, match="enc_out"):
        PT.forward(model, torch.zeros((1, 2), dtype=torch.long), cfg)
