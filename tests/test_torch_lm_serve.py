"""The port's LM serving launcher (``repro_torch.launch.lm_serve``).

``generate`` on the reference's parameters (carried by
``lm_params_from_numpy``) against the JAX package's launcher loop
(``repro.launch.lm_serve``: its prompts, for the audio family its bf16
frames, which must be bit-equal, jitted prefill and greedy decode steps,
a cache of ``P + gen + 1`` positions), in float32, where the greedy
tokens must be equal, for Zamba2, DeepSeek-V2 (MoE, MLA) and Whisper
(audio); the CLI with ``--smoke --device cpu`` in a fresh interpreter; no fallback to the CPU when the card is
missing; ``generate``'s step hook; and ``transformer.to_compute``, whose
bf16 serving copy must give the logits of the float32 masters bit for
bit.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import transformer as T  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.launch import lm_serve  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def _reference_launcher(cfg, params, B, P, gen, seed):
    """``repro.launch.lm_serve.main``'s loop, returning the prompts, the
    frames (audio; else None) and the tokens."""
    rng = np.random.default_rng(seed)
    prompts = jnp.asarray(rng.integers(0, cfg.vocab, (B, P)), jnp.int32)
    frames = None
    if cfg.family == "audio":
        frames = jnp.asarray(
            0.1 * rng.normal(size=(B, cfg.enc_frames, cfg.d_model)),
            jnp.bfloat16)
    cache = T.init_cache(cfg, B, P + gen + 1)
    prefill = jax.jit(lambda p, t, c, f: T.prefill(p, t, cfg, c, frames=f))
    step = jax.jit(lambda p, t, c, i: T.decode_step(p, t, cfg, c, i))
    logits, cache = prefill(params, prompts, cache, frames)
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
    out = [tok]
    for i in range(gen - 1):
        logits, cache = step(params, tok, cache, jnp.int32(P + i))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
        out.append(tok)
    return (np.asarray(prompts),
            None if frames is None else np.asarray(frames, np.float32),
            np.asarray(jnp.concatenate(out, axis=1)))


def _generate_against_reference_launcher(arch):
    B, P, gen, seed = 2, 20, 6, 3
    ref_cfg = dataclasses.replace(ref_smoke(arch), dtype="float32")
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    params = jax.jit(T.init_params, static_argnums=0)(
        ref_cfg, jax.random.PRNGKey(seed))
    want_prompts, want_frames, want = _reference_launcher(
        ref_cfg, params, B, P, gen, seed)
    model = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                 "cpu")
    prompts = lm_serve.make_prompts(cfg, B, P, seed, "cpu")
    np.testing.assert_array_equal(prompts.numpy(), want_prompts)
    frames = lm_serve.make_frames(cfg, B, P, seed, "cpu")
    if want_frames is None:
        assert frames is None
    else:
        # bf16 whatever cfg.dtype, bit for bit the reference's
        assert frames.dtype == torch.bfloat16
        np.testing.assert_array_equal(frames.float().numpy(), want_frames)
    tokens, logits, t_pre, t_dec = lm_serve.generate(model, cfg, prompts,
                                                     gen, frames=frames)
    np.testing.assert_array_equal(tokens.numpy(), want)
    assert logits.shape == (B, cfg.vocab) and logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all()) and t_pre > 0 and t_dec > 0


def test_generate_equals_the_reference_launcher_in_float32():
    _generate_against_reference_launcher("zamba2_2_7b")


@pytest.mark.parametrize("arch", ["deepseek_v2_236b", "whisper_medium"])
def test_generate_equals_the_reference_launcher_moe_mla_audio(arch):
    _generate_against_reference_launcher(arch)


def _cli_smoke(arch):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.lm_serve", "--arch",
         arch, "--smoke", "--device", "cpu"], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.splitlines()


@pytest.mark.parametrize("arch,name", [
    ("deepseek-v2-236b", "deepseek-v2-smoke"),
    ("whisper-medium", "whisper-medium-smoke")])
def test_cli_smoke_on_the_cpu_moe_mla_audio(arch, name):
    lines = _cli_smoke(arch)
    assert lines[0] == f"arch={name} pattern=full"
    assert lines[1].startswith("prefill: 4x48 tokens in ")
    assert re.fullmatch(r"sample token ids: \[[\d, ]+\]", lines[3])
    assert lines[4] == "device=cpu last logits finite=True"


def test_cli_smoke_on_the_cpu():
    lines = _cli_smoke("zamba2-2.7b")
    assert lines[0] == "arch=zamba2-2.7b-smoke pattern=ddm_window"
    assert re.fullmatch(r"prefill: 4x48 tokens in \d+\.\d\ds \(\d+ tok/s\)",
                        lines[1]), lines[1]
    assert re.fullmatch(r"decode:  4x32 tokens in \d+\.\d\ds "
                        r"\(\d+\.\d tok/s\)", lines[2]), lines[2]
    ids = re.fullmatch(r"sample token ids: \[(.*)\]", lines[3]).group(1)
    assert len([int(t) for t in ids.split(",")]) == 16
    assert lines[4] == "device=cpu last logits finite=True"


def test_cli_without_a_card_raises(monkeypatch):
    # the default device is the card; there is no CPU fallback
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        lm_serve.main(["--arch", "zamba2-2.7b", "--smoke"])


def test_generate_calls_on_step_before_the_prefill_and_after_each_step():
    cfg = get_smoke_config("zamba2_2_7b")
    model = PT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    marks = []
    tokens, *_ = lm_serve.generate(model, cfg, lm_serve.make_prompts(
        cfg, 2, 8, 0, "cpu"), 5, on_step=lambda: marks.append(1))
    assert tokens.shape == (2, 5) and len(marks) == 1 + 5


@pytest.mark.parametrize("arch", ["zamba2_2_7b", "qwen2_0_5b",
                                  "llama3_2_3b", "mamba2_780m",
                                  "deepseek_v2_236b", "phi3_5_moe_42b",
                                  "whisper_medium"])
def test_to_compute_gives_the_masters_logits_bit_for_bit(arch):
    # hybrid; tied with a QKV bias; untied; tied ssm; MoE with MLA (whose
    # absorbed decode reads w_ukv in float32) and a dense first layer;
    # MoE with GQA; audio (enc_pos, the cross attention).  Every master
    # is jittered first, so no value (a norm's 1.0, D's 1.0) is a bf16
    # value by chance and a float32 read cast to bf16 would show
    import copy
    cfg = get_smoke_config(arch)
    assert cfg.dtype == "bfloat16"
    g = torch.Generator().manual_seed(1)
    master = PT.init_params(cfg, g, "cpu")
    with torch.no_grad():
        for t in master.parameters():
            t.add_(1e-3 * torch.randn(t.shape, generator=g))
    served = PT.to_compute(copy.deepcopy(master), cfg)
    dtypes = {n: t.dtype for n, t in served.named_parameters()}
    assert any(d == torch.bfloat16 for d in dtypes.values())
    head = "embed.table" if cfg.tie_embeddings else "lm_head.w"
    assert dtypes[head] == torch.float32
    float32 = {n for n, d in dtypes.items() if d == torch.float32}
    if cfg.mla:
        assert "moe_layers.0.attn.w_ukv.w" in float32
    if cfg.family == "moe":
        assert "moe_layers.0.moe.w_gate" not in float32
    if cfg.family == "audio":
        assert "enc_pos" not in float32
    tokens = lm_serve.make_prompts(cfg, 2, 12, 0, "cpu")
    frames = lm_serve.make_frames(cfg, 2, 12, 0, "cpu")
    with torch.no_grad():
        want, got = (PT.forward(m, tokens, cfg, frames=frames)[0]
                     for m in (master, served))
    assert torch.equal(got, want)
    caches = [PT.init_cache(cfg, 2, 14, "cpu") for _ in range(2)]
    for m, c in zip((master, served), caches):
        with torch.no_grad():
            PT.prefill(m, tokens, cfg, c, frames)
    with torch.no_grad():
        want, got = (PT.decode_step(m, tokens[:, :1], cfg, c, 12)[0]
                     for m, c in zip((master, served), caches))
    assert torch.equal(got, want)
