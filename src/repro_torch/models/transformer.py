"""Model stacks: the port of the JAX package's ``models/transformer.py``.

The reference stacks each homogeneous group of layers along a leading L
axis and runs it with ``lax.scan``; here the layers are an
``nn.ModuleList`` run by a Python loop.  Families:

  dense / vlm   : [L × (attn + mlp)]
  moe           : [first_dense × (attn + mlp)] + [rest × (attn + moe)]
  ssm           : [L × mamba2]
  hybrid        : [(L/k groups) × (k × mamba2)] + one *shared* attn+mlp
                  block applied after every group (Zamba2-style weight
                  sharing), each application with its own KV cache
  audio         : encoder [Lenc × (attn + mlp, non-causal)] +
                  decoder [L × (self-attn + cross-attn + mlp)], the conv
                  frontend stubbed (precomputed frame embeddings)

Entry points (used by ``launch/``, ``runtime/`` and the tests):
  init_params(cfg, generator, device)   — the model, fp32 masters
  to_compute(params, cfg)               — its serving copy, in place
                                          (never applied to a model in
                                          training: AdamW updates the
                                          float32 masters)
  forward(params, tokens, cfg, ...)     — logits (f32) or features +
                                          caches + aux
  loss_fn(params, batch, cfg)           — next-token CE (+ MoE aux)
  init_cache(cfg, batch, max_len, device)
  prefill(params, tokens, cfg, cache, frames) — last logits + cache
  decode_step(params, tokens, cfg, cache, cur_len) — one token

Caches are dicts of per-layer dicts whose tensors ``forward`` updates in
place (KV rows) or replaces (the Mamba states, the audio encoder's
output ``enc_out``); ``prefill`` and ``decode_step`` return the same
dict.  ``cur_len`` is a host int.

Remat: with ``cfg.remat``, a forward without caches that autograd
records runs each layer body (every family's, the hybrid's Mamba layers
and each application of its shared block, the audio encoder's and
decoder's) under ``layers.remat_call`` (``torch.utils.checkpoint``; the
reference's ``jax.checkpoint`` of each scanned layer), so a layer's
activations live only while its backward runs; the recompute is the same
ops on the same inputs, so the gradients are bit for bit those without
remat.  Inside a layer, as in the reference and whatever ``cfg.remat``
says, each query chunk of ``chunked_sdpa`` and each top-k slot of the
MoE's dense form is checkpointed again, so a layer's backward holds one
chunk's (or slot's) intermediates at a time.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .attention import attn_apply, attn_cache_init, attn_init, chunked_sdpa
from .config import ModelConfig
from .layers import embed, embed_init, linear, linear_init, master, \
    remat_call, rmsnorm, rmsnorm_init, truncated_normal
from .mlp import mlp_apply, mlp_init
from .moe import moe_apply, moe_init
from .sharding import constrain
from .ssm import mamba2_apply, mamba2_cache_init, mamba2_init

FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


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
    x = constrain(x, "dp", "tpseq", None)
    a, cache = attn_apply(p.attn, rmsnorm(p.ln1, x, cfg.norm_eps), cfg,
                          positions=positions, cache=cache, cur_len=cur_len,
                          causal=causal, **sparse)
    x = x + a
    x = x + mlp_apply(p.mlp, rmsnorm(p.ln2, x, cfg.norm_eps))
    return x, cache


class MoELayer(nn.Module):
    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.ln1 = rmsnorm_init(cfg.d_model, device)
        self.attn = attn_init(cfg, **kw)
        self.ln2 = rmsnorm_init(cfg.d_model, device)
        self.moe = moe_init(cfg, **kw)


def _moe_layer_apply(p: MoELayer, x, cfg, *, positions, cache=None,
                     cur_len=0, causal=True, **sparse):
    x = constrain(x, "dp", "tpseq", None)
    a, cache = attn_apply(p.attn, rmsnorm(p.ln1, x, cfg.norm_eps), cfg,
                          positions=positions, cache=cache, cur_len=cur_len,
                          causal=causal, **sparse)
    x = x + a
    y, aux = moe_apply(p.moe, rmsnorm(p.ln2, x, cfg.norm_eps), cfg)
    return x + y, cache, aux


class MambaLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        self.ln = rmsnorm_init(cfg.d_model, device)
        self.mixer = mamba2_init(cfg, generator=generator, device=device)


def _mamba_layer_apply(p: MambaLayer, x, cfg, *, cache=None):
    x = constrain(x, "dp", "tpseq", None)
    y, cache = mamba2_apply(p.mixer, rmsnorm(p.ln, x, cfg.norm_eps), cfg,
                            cache=cache)
    return x + y, cache


class DecoderLayer(nn.Module):
    """The audio decoder's layer: self-attention, cross-attention to the
    encoder's output (``xattn``, built by ``attn_init`` as in the
    reference), MLP."""

    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.ln1 = rmsnorm_init(cfg.d_model, device)
        self.attn = attn_init(cfg, **kw)
        self.lnx = rmsnorm_init(cfg.d_model, device)
        self.xattn = attn_init(cfg, **kw)
        self.ln2 = rmsnorm_init(cfg.d_model, device)
        self.mlp = mlp_init(cfg, **kw)


def _decoder_layer_apply(p: DecoderLayer, x, enc, cfg, *, positions,
                         cache=None, cur_len=0, **sparse):
    a, cache = attn_apply(p.attn, rmsnorm(p.ln1, x, cfg.norm_eps), cfg,
                          positions=positions, cache=cache, cur_len=cur_len,
                          **sparse)
    x = x + a
    x = x + _cross_attn(p.xattn, rmsnorm(p.lnx, x, cfg.norm_eps), enc, cfg)
    x = x + mlp_apply(p.mlp, rmsnorm(p.ln2, x, cfg.norm_eps))
    return x, cache


def _cross_attn(p, xq, enc, cfg: ModelConfig):
    """Cross attention: queries from the decoder, K/V from the encoder
    output (recomputed every step: there is no cross KV cache), not
    causal, no RoPE."""
    B, S, _ = xq.shape
    F = enc.shape[1]
    dh = cfg.d_head
    dt = xq.dtype
    q = linear(p.wq, xq, dt).reshape(B, S, cfg.n_heads, dh)
    k = linear(p.wk, enc, dt).reshape(B, F, cfg.n_kv_heads, dh)
    v = linear(p.wv, enc, dt).reshape(B, F, cfg.n_kv_heads, dh)
    g = cfg.n_heads // cfg.n_kv_heads
    out = chunked_sdpa(q.reshape(B, S, cfg.n_kv_heads, g, dh), k, v,
                       torch.arange(S, device=xq.device), F, causal=False,
                       q_chunk=cfg.q_chunk)
    return linear(p.wo, out.reshape(B, S, -1), dt)


def _encode(params: LM, frames, cfg: ModelConfig, dt, run=None):
    """The audio encoder over frame embeddings (B, F, d): non-causal dense
    layers (each through ``run``, ``forward``'s remat wrapper; called
    directly when None), then ``enc_norm``."""
    run = run or _call
    n_frames = frames.shape[1]
    x = frames.to(dt) + params.enc_pos[:n_frames].to(dt)
    positions = torch.arange(n_frames, device=x.device)
    for lp in params.enc_layers:
        x = run(lambda x, lp=lp: _dense_layer_apply(
            lp, x, cfg, positions=positions, causal=False)[0], x)
    return rmsnorm(params.enc_norm, x, cfg.norm_eps)


def _call(fn, *args):
    return fn(*args)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

class LM(nn.Module):
    """The parameters of one model; attribute names follow the
    reference's parameter tree, with the stacked L axis (and the hybrid's
    (groups, per) axes) as ``ModuleList`` indices."""

    def __init__(self, cfg: ModelConfig, generator=None, device="cuda"):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(cfg.family)
        self.cfg = cfg
        self.compute: tuple[str, ...] = ()
        kw = dict(generator=generator, device=device)
        self.embed = embed_init(cfg.vocab, cfg.d_model, **kw)
        self.final_norm = rmsnorm_init(cfg.d_model, device)
        self.lm_head = (None if cfg.tie_embeddings
                        else linear_init(cfg.d_model, cfg.vocab, **kw))
        # the logits' projection reads its weights in float32
        (self.embed if cfg.tie_embeddings else self.lm_head).compute = ()

        def stack(layer, n):
            return nn.ModuleList(layer(cfg, **kw) for _ in range(n))
        if cfg.family in ("dense", "vlm"):
            self.layers = stack(DenseLayer, cfg.n_layers)
        elif cfg.family == "moe":
            nd = cfg.first_dense_layers
            self.dense_layers = stack(DenseLayer, nd)
            self.moe_layers = stack(MoELayer, cfg.n_layers - nd)
        elif cfg.family == "ssm":
            self.layers = stack(MambaLayer, cfg.n_layers)
        elif cfg.family == "hybrid":
            per = cfg.attn_every
            self.mamba_groups = nn.ModuleList(
                stack(MambaLayer, per) for _ in range(cfg.n_layers // per))
            self.shared_block = DenseLayer(cfg, **kw)
        else:                                      # audio
            self.enc_pos = master((cfg.enc_frames, cfg.d_model), device)
            truncated_normal(self.enc_pos, 0.02, generator)
            self.compute = ("enc_pos",)            # read in the dtype only
            self.enc_layers = stack(DenseLayer, cfg.enc_layers)
            self.dec_layers = stack(DecoderLayer, cfg.n_layers)
            self.enc_norm = rmsnorm_init(cfg.d_model, device)


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
            cur_len: int = 0, frames=None, return_features: bool = False):
    """Logits for a token slab.  tokens: (B, S) integer.

    ``caches``: None (no cache) or the cache of ``init_cache`` (written
    at [cur_len, cur_len+S)).  ``frames``: (B, F, d) frame embeddings of
    the audio family's stubbed frontend: given, the encoder runs over
    them (and its output goes into ``caches["enc_out"]``); absent, the
    decoder reads ``caches["enc_out"]``.  ``return_features``: skip the
    LM head (``loss_fn`` projects in chunks).  Returns (logits float32
    (B,S,vocab) or the final-normed features (B,S,d), caches, aux loss:
    the float32 sum of the MoE layers' load-balance losses, 0 for the
    other families).
    """
    dt = _dtype(cfg)
    S = tokens.shape[1]
    x = constrain(embed(params.embed, tokens, dt), "dp", None, None)
    positions = cur_len + torch.arange(S, device=x.device)
    sparse = _sparse_kw(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    run = remat_call if cfg.remat and caches is None else _call

    def layer_caches(name, n):
        return [None] * n if caches is None or not n else caches[name]

    def dense(lp, x, c):
        return run(lambda x: _dense_layer_apply(
            lp, x, cfg, positions=positions, cache=c, cur_len=cur_len,
            **sparse)[0], x)

    def mamba(lp, x, c):
        return run(lambda x: _mamba_layer_apply(lp, x, cfg, cache=c), x)

    if cfg.family in ("dense", "vlm"):
        for lp, c in zip(params.layers, layer_caches("layers", cfg.n_layers)):
            x = dense(lp, x, c)
    elif cfg.family == "moe":
        for lp, c in zip(params.dense_layers, layer_caches(
                "dense_layers", len(params.dense_layers))):
            x = dense(lp, x, c)
        for lp, c in zip(params.moe_layers, layer_caches(
                "moe_layers", len(params.moe_layers))):
            x, a = run(lambda x, lp=lp, c=c: _moe_layer_apply(
                lp, x, cfg, positions=positions, cache=c, cur_len=cur_len,
                **sparse)[::2], x)
            aux = aux + a
    elif cfg.family == "ssm":
        cs = None if caches is None else caches["layers"]
        for i, lp in enumerate(params.layers):
            x, c = mamba(lp, x, None if cs is None else cs[i])
            if cs is not None:
                cs[i] = c
    elif cfg.family == "hybrid":
        for g, group in enumerate(params.mamba_groups):
            gc = None if caches is None else caches["mamba_groups"][g]
            for i, lp in enumerate(group):
                x, c = mamba(lp, x, None if gc is None else gc[i])
                if gc is not None:
                    gc[i] = c
            x = dense(params.shared_block, x,
                      None if caches is None else caches["attn"][g])
    else:                                          # audio
        if frames is not None:
            enc = _encode(params, frames, cfg, dt, run)
            if caches is not None:
                caches["enc_out"] = enc
        elif caches is None or "enc_out" not in caches:
            raise ValueError("audio decode needs frames or a cache whose "
                             "enc_out a prefill with frames filled")
        else:
            enc = caches["enc_out"].to(dt)
        for lp, c in zip(params.dec_layers,
                         layer_caches("dec_layers", cfg.n_layers)):
            x = run(lambda x, lp=lp, c=c: _decoder_layer_apply(
                lp, x, enc, cfg, positions=positions, cache=c,
                cur_len=cur_len, **sparse)[0], x)

    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    if return_features:
        return x, caches, aux
    return _project_logits(params, x, cfg), caches, aux


def _project_logits(params: LM, x, cfg: ModelConfig):
    """Logits in float32, tied or not."""
    if cfg.tie_embeddings:
        logits = x.float() @ params.embed.table.T
    else:
        logits = linear(params.lm_head, x, torch.float32)
    return constrain(logits, "dp", None, "tp")


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> dict:
    dt = _dtype(cfg)

    def attn_stack(n):
        return [attn_cache_init(cfg, batch, max_len, dt, device)
                for _ in range(n)]

    if cfg.family in ("dense", "vlm"):
        return {"layers": attn_stack(cfg.n_layers)}
    if cfg.family == "moe":
        nd = cfg.first_dense_layers
        c = {"moe_layers": attn_stack(cfg.n_layers - nd)}
        if nd:
            c["dense_layers"] = attn_stack(nd)
        return c
    if cfg.family == "ssm":
        return {"layers": [mamba2_cache_init(cfg, batch, dt, device)
                           for _ in range(cfg.n_layers)]}
    if cfg.family == "hybrid":
        groups = cfg.n_layers // cfg.attn_every
        return {"mamba_groups": [[mamba2_cache_init(cfg, batch, dt, device)
                                  for _ in range(cfg.attn_every)]
                                 for _ in range(groups)],
                "attn": attn_stack(groups)}
    if cfg.family == "audio":
        return {"dec_layers": attn_stack(cfg.n_layers),
                "enc_out": torch.zeros((batch, cfg.enc_frames, cfg.d_model),
                                       dtype=dt, device=device)}
    raise ValueError(cfg.family)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _chunk_loss(params: LM, xc, yc, cfg: ModelConfig):
    """(sum of logsumexp − gold over the chunk's valid labels, their
    count), both float32.  The gold logit is selected by a mask, not a
    gather, whose backward on the card adds with atomics."""
    logits = _project_logits(params, xc, cfg)
    logz = torch.logsumexp(logits, dim=-1)
    hit = torch.arange(logits.shape[-1], device=logits.device) \
        == yc.clamp(min=0)[..., None]
    gold = torch.where(hit, logits, 0.0).sum(dim=-1)
    valid = (yc >= 0).to(torch.float32)
    return torch.sum((logz - gold) * valid), torch.sum(valid)


def loss_fn(params: LM, batch: dict, cfg: ModelConfig):
    """batch: {"tokens": (B, S+1)} (+ "frames" for audio).

    Cross entropy runs in sequence chunks of ``cfg.ce_chunk`` positions,
    each under ``layers.remat_call`` (a checkpoint while autograd
    records), so the (B, S, vocab) float32 logits are never alive at
    once; labels past S (when the chunk does not divide S) are −1 and
    count for nothing.
    Returns (ce + 0.01·aux, {"ce", "aux"}), float32 0-dim tensors.
    """
    tokens = batch["tokens"]
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    feats, _, aux = forward(params, inputs, cfg, frames=batch.get("frames"),
                            return_features=True)
    S = feats.shape[1]
    C = min(cfg.ce_chunk, S)
    pad = (-S) % C
    if pad:
        feats = F.pad(feats, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    tot = torch.zeros((), dtype=torch.float32, device=feats.device)
    cnt = torch.zeros((), dtype=torch.float32, device=feats.device)
    for c0 in range(0, S + pad, C):
        t, n = remat_call(lambda xc, yc: _chunk_loss(params, xc, yc, cfg),
                          feats[:, c0:c0 + C], labels[:, c0:c0 + C])
        tot, cnt = tot + t, cnt + n
    loss = tot / torch.clamp(cnt, min=1.0)
    return loss + 0.01 * aux, {"ce": loss, "aux": aux}


@torch.no_grad()
def prefill(params: LM, tokens, cfg: ModelConfig, cache, frames=None):
    logits, cache, _ = forward(params, tokens, cfg, caches=cache, cur_len=0,
                               frames=frames)
    return logits[:, -1], cache


@torch.no_grad()
def decode_step(params: LM, tokens, cfg: ModelConfig, cache, cur_len: int,
                frames=None):
    """tokens: (B, 1); cur_len: host int — the current cache fill."""
    logits, cache, _ = forward(params, tokens, cfg, caches=cache,
                               cur_len=cur_len, frames=frames)
    return logits[:, -1], cache
