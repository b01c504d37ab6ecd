"""Model stacks: the port of the JAX package's ``models/transformer.py``.

The reference stacks each homogeneous group of layers along a leading L
axis and runs it with ``lax.scan``; here the layers are an
``nn.ModuleList`` run by a Python loop.  Families:

  dense / vlm   : [L × (attn + mlp)]
  ssm           : [L × mamba2]
  hybrid        : [(L/k groups) × (k × mamba2)] + one *shared* attn+mlp
                  block applied after every group (Zamba2-style weight
                  sharing), each application with its own KV cache

``moe`` and ``audio`` (and MLA attention) raise ``NotImplementedError``:
they are not ported yet (ROADMAP Queue 1 item 13), nor is ``loss_fn``,
which waits for the training slice.

Entry points (used by ``launch/lm_serve`` and the tests):
  init_params(cfg, generator, device)   — the model, fp32 masters
  to_compute(params, cfg)               — its serving copy, in place
  forward(params, tokens, cfg, ...)     — logits (f32) + caches
  init_cache(cfg, batch, max_len, device)
  prefill(params, tokens, cfg, cache)   — last logits + filled cache
  decode_step(params, tokens, cfg, cache, cur_len) — one token

Caches are dicts of per-layer dicts whose tensors ``forward`` updates in
place (KV rows) or replaces (the Mamba states); ``prefill`` and
``decode_step`` return the same dict.  ``cur_len`` is a host int.
"""
from __future__ import annotations

import torch
from torch import nn

from .attention import NOT_PORTED, attn_apply, attn_cache_init, attn_init
from .config import ModelConfig
from .layers import embed, embed_init, linear, linear_init, rmsnorm, \
    rmsnorm_init
from .mlp import mlp_apply, mlp_init
from .ssm import mamba2_apply, mamba2_cache_init, mamba2_init

PORTED_FAMILIES = ("dense", "vlm", "ssm", "hybrid")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        if cfg.family in ("moe", "audio"):
            raise NotImplementedError(
                f"the {cfg.family} family ({cfg.name}) {NOT_PORTED}")
        raise ValueError(cfg.family)


def _sparse_kw(cfg: ModelConfig) -> dict:
    if cfg.attn_pattern == "ddm_window" and cfg.window > 0:
        return {"window": cfg.window,
                "sink": cfg.n_sink_blocks * cfg.block_kv}
    return {}


# ---------------------------------------------------------------------------
# homogeneous layer bodies
# ---------------------------------------------------------------------------

class DenseLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.ln1 = rmsnorm_init(cfg.d_model, device)
        self.attn = attn_init(cfg, **kw)
        self.ln2 = rmsnorm_init(cfg.d_model, device)
        self.mlp = mlp_init(cfg, **kw)


def _dense_layer_apply(p: DenseLayer, x, cfg, *, positions, cache=None,
                       cur_len=0, causal=True, **sparse):
    a, cache = attn_apply(p.attn, rmsnorm(p.ln1, x, cfg.norm_eps), cfg,
                          positions=positions, cache=cache, cur_len=cur_len,
                          causal=causal, **sparse)
    x = x + a
    x = x + mlp_apply(p.mlp, rmsnorm(p.ln2, x, cfg.norm_eps))
    return x, cache


class MambaLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        self.ln = rmsnorm_init(cfg.d_model, device)
        self.mixer = mamba2_init(cfg, generator=generator, device=device)


def _mamba_layer_apply(p: MambaLayer, x, cfg, *, cache=None):
    y, cache = mamba2_apply(p.mixer, rmsnorm(p.ln, x, cfg.norm_eps), cfg,
                            cache=cache)
    return x + y, cache


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

class LM(nn.Module):
    """The parameters of one model; attribute names follow the
    reference's parameter tree, with the stacked L axis (and the hybrid's
    (groups, per) axes) as ``ModuleList`` indices."""

    def __init__(self, cfg: ModelConfig, generator=None, device="cuda"):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        kw = dict(generator=generator, device=device)
        self.embed = embed_init(cfg.vocab, cfg.d_model, **kw)
        self.final_norm = rmsnorm_init(cfg.d_model, device)
        self.lm_head = (None if cfg.tie_embeddings
                        else linear_init(cfg.d_model, cfg.vocab, **kw))
        # the logits' projection reads its weights in float32
        (self.embed if cfg.tie_embeddings else self.lm_head).compute = ()
        if cfg.family in ("dense", "vlm"):
            self.layers = nn.ModuleList(
                DenseLayer(cfg, **kw) for _ in range(cfg.n_layers))
        elif cfg.family == "ssm":
            self.layers = nn.ModuleList(
                MambaLayer(cfg, **kw) for _ in range(cfg.n_layers))
        else:                                      # hybrid
            per = cfg.attn_every
            self.mamba_groups = nn.ModuleList(
                nn.ModuleList(MambaLayer(cfg, **kw) for _ in range(per))
                for _ in range(cfg.n_layers // per))
            self.shared_block = DenseLayer(cfg, **kw)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> LM:
    """The model with parameters drawn from ``generator`` (a generator on
    ``device``).  The draws are the port's own: JAX's PRNG is not
    reproduced, so parameters carry across by
    ``repro_torch.convert.lm_params_from_numpy``."""
    return LM(cfg, generator, device)


@torch.no_grad()
def to_compute(params: LM, cfg: ModelConfig) -> LM:
    """Store, in place, every weight that the forward reads only in
    ``cfg``'s compute dtype in that dtype (``Params.compute``), for
    serving; the logits are bit for bit those of the float32 masters."""
    dtype = _dtype(cfg)
    for m in params.modules():
        for name in getattr(m, "compute", ()):
            t = getattr(m, name)
            if t is not None:
                t.data = t.data.to(dtype)
    return params


# ---------------------------------------------------------------------------
# forward (prefill / decode share one path per family)
# ---------------------------------------------------------------------------

def forward(params: LM, tokens, cfg: ModelConfig, *, caches=None,
            cur_len: int = 0):
    """Logits for a token slab.  tokens: (B, S) integer.

    ``caches``: None (no cache) or the cache of ``init_cache`` (written
    at [cur_len, cur_len+S)).  Returns (logits float32 (B,S,vocab),
    caches, aux loss 0.0: no ported family has one).
    """
    _check_family(cfg)
    dt = _dtype(cfg)
    S = tokens.shape[1]
    x = embed(params.embed, tokens, dt)
    positions = cur_len + torch.arange(S, device=x.device)
    sparse = _sparse_kw(cfg)

    if cfg.family in ("dense", "vlm"):
        cs = None if caches is None else caches["layers"]
        for i, lp in enumerate(params.layers):
            x, _ = _dense_layer_apply(lp, x, cfg, positions=positions,
                                      cache=None if cs is None else cs[i],
                                      cur_len=cur_len, **sparse)
    elif cfg.family == "ssm":
        cs = None if caches is None else caches["layers"]
        for i, lp in enumerate(params.layers):
            x, c = _mamba_layer_apply(lp, x, cfg,
                                      cache=None if cs is None else cs[i])
            if cs is not None:
                cs[i] = c
    else:                                          # hybrid
        for g, group in enumerate(params.mamba_groups):
            gc = None if caches is None else caches["mamba_groups"][g]
            for i, lp in enumerate(group):
                x, c = _mamba_layer_apply(lp, x, cfg,
                                          cache=None if gc is None else gc[i])
                if gc is not None:
                    gc[i] = c
            x, _ = _dense_layer_apply(
                params.shared_block, x, cfg, positions=positions,
                cache=None if caches is None else caches["attn"][g],
                cur_len=cur_len, **sparse)

    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    return _project_logits(params, x, cfg), caches, 0.0


def _project_logits(params: LM, x, cfg: ModelConfig):
    """Logits in float32, tied or not."""
    if cfg.tie_embeddings:
        return x.float() @ params.embed.table.T
    return linear(params.lm_head, x, torch.float32)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> dict:
    _check_family(cfg)
    dt = _dtype(cfg)
    if cfg.family in ("dense", "vlm"):
        return {"layers": [attn_cache_init(cfg, batch, max_len, dt, device)
                           for _ in range(cfg.n_layers)]}
    if cfg.family == "ssm":
        return {"layers": [mamba2_cache_init(cfg, batch, dt, device)
                           for _ in range(cfg.n_layers)]}
    groups = cfg.n_layers // cfg.attn_every
    return {"mamba_groups": [[mamba2_cache_init(cfg, batch, dt, device)
                              for _ in range(cfg.attn_every)]
                             for _ in range(groups)],
            "attn": [attn_cache_init(cfg, batch, max_len, dt, device)
                     for _ in range(groups)]}


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefill(params: LM, tokens, cfg: ModelConfig, cache):
    logits, cache, _ = forward(params, tokens, cfg, caches=cache, cur_len=0)
    return logits[:, -1], cache


@torch.no_grad()
def decode_step(params: LM, tokens, cfg: ModelConfig, cache, cur_len: int):
    """tokens: (B, 1); cur_len: host int — the current cache fill."""
    logits, cache, _ = forward(params, tokens, cfg, caches=cache,
                               cur_len=cur_len)
    return logits[:, -1], cache
