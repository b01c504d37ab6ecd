"""LM serving launcher: prefill a batch of prompts, decode with KV caches.

The port of the JAX package's ``launch/lm_serve.py``, with the same
flags plus ``--device`` (default ``cuda``; there is no CPU fallback,
``--device cpu`` asks for the CPU).  It prints the reference's four
lines and a fifth that the reference does not, ``device=... last logits
finite=...``, so a caller in another process can check the logits.
Parameters come from ``torch.Generator(device).manual_seed(seed)``,
stored in the compute dtype once (``transformer.to_compute``); the
prompts are the reference's (``np.random.default_rng(seed)``), so both
launchers decode the same token ids, and for the audio family the
reference's frame embeddings, drawn after the prompts from the same
generator and rounded to bf16.  For ``attn_pattern=ddm_window`` archs
the shared attention reads the DDM window and sink through the token
mask.  All ten configs are served.  At the published widths on one
80 GB card, DeepSeek-V2-236B (about 472 GB in bf16) and Phi-3.5-MoE (84
GB) do not fit, as on one chip for the reference launcher, which has no
depth flag either: run them with ``--smoke``.

Example:
    PYTHONPATH=src python -m repro_torch.launch.lm_serve --arch \\
        zamba2-2.7b --smoke --batch 4 --prompt-len 48 --gen 32
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.regions import resolve_device
from repro_torch.models import transformer as T


def make_prompts(cfg, batch: int, prompt_len: int, seed: int,
                 device) -> torch.Tensor:
    """The reference launcher's prompts: (batch, prompt_len) token ids."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (batch, prompt_len))
                            ).to(device)


def make_frames(cfg, batch: int, prompt_len: int, seed: int, device):
    """The reference launcher's audio frames, (batch, enc_frames, d_model)
    bf16, drawn after the prompts from the same generator; None for the
    other families."""
    if cfg.family != "audio":
        return None
    rng = np.random.default_rng(seed)
    rng.integers(0, cfg.vocab, (batch, prompt_len))        # the prompts
    frames = 0.1 * rng.normal(size=(batch, cfg.enc_frames, cfg.d_model))
    # float64 → bf16 through float32, as the reference's conversion
    return torch.from_numpy(frames.astype(np.float32)).to(
        torch.bfloat16).to(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def generate(params, cfg, prompts: torch.Tensor, gen: int, on_step=None,
             frames=None):
    """Greedy decoding: prefill, then ``gen − 1`` decode steps.

    ``frames``: the audio family's frame embeddings, read by the prefill
    (the decode steps read the encoder output in the cache).

    Returns (tokens (B, gen), last logits (B, vocab) float32, prefill
    seconds, decode seconds); the cache holds ``P + gen + 1`` positions,
    as the reference's.  ``on_step``, if given, is called with no
    argument before the prefill and after each step's argmax (the
    prefill's and every decode step's), where a caller may record a CUDA
    event to time the steps on the card.
    """
    mark = on_step or (lambda: None)
    dev = prompts.device
    B, P = prompts.shape
    cache = T.init_cache(cfg, B, P + gen + 1, dev)
    mark()
    t0 = time.perf_counter()
    logits, cache = T.prefill(params, prompts, cfg, cache, frames)
    tok = torch.argmax(logits, dim=-1)[:, None]
    mark()
    _sync(dev)
    t_pre = time.perf_counter() - t0

    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = T.decode_step(params, tok, cfg, cache, P + i)
        tok = torch.argmax(logits, dim=-1)[:, None]
        mark()
        out.append(tok)
    _sync(dev)
    t_dec = time.perf_counter() - t0
    return torch.cat(out, dim=1), logits, t_pre, t_dec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else \
        get_config(args.arch)
    dev = resolve_device(args.device)
    params = T.to_compute(T.init_params(
        cfg, torch.Generator(dev).manual_seed(args.seed), dev), cfg)
    B = args.batch
    prompts = make_prompts(cfg, B, args.prompt_len, args.seed, dev)
    frames = make_frames(cfg, B, args.prompt_len, args.seed, dev)
    gen, logits, t_pre, t_dec = generate(params, cfg, prompts, args.gen,
                                         frames=frames)

    gen = gen.cpu().numpy()
    print(f"arch={cfg.name} pattern={cfg.attn_pattern}")
    print(f"prefill: {B}x{args.prompt_len} tokens in {t_pre:.2f}s "
          f"({B * args.prompt_len / max(t_pre, 1e-9):.0f} tok/s)")
    print(f"decode:  {B}x{args.gen} tokens in {t_dec:.2f}s "
          f"({B * args.gen / max(t_dec, 1e-9):.1f} tok/s)")
    print("sample token ids:", gen[0, :16].tolist())
    print(f"device={dev} last logits finite="
          f"{bool(torch.isfinite(logits).all())}")


if __name__ == "__main__":
    main()
