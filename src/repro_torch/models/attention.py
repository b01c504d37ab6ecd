"""Attention blocks: GQA (with qk-norm / QKV-bias variants) and MLA.

The port of the JAX package's ``models/attention.py``: ``chunked_sdpa``,
the cache write, GQA init, cache and apply, with both decode reads of a
``ddm_window`` config (the masked full-context read and the
``window_gather_decode`` gather of the window and the sink), and MLA
(DeepSeek-V2: a latent KV cache, a decoupled RoPE key, and the absorbed
single-token decode).

Scores are float32 products of the compute-dtype inputs (the
reference's ``preferred_element_type=float32``): the inputs are upcast
before the product, so a bf16 product never rounds them.  Keep TF32 off
on the card (``torch.backends.cuda.matmul.allow_tf32 = False``, the
default) or float32 scores lose 13 bits.  The query axis is processed in
chunks of ``q_chunk`` rows, each under ``remat_call`` while autograd
records (the reference's ``jax.checkpoint`` of a chunk): a chunk keeps
only its inputs (its q rows, and the one float32 copy of K and V that
all chunks share), and its (B, H, G, q_chunk, Skv) float32 blocks are
recomputed in the backward.  So one chunk's blocks are live at a time
in the forward and in the backward alike.

KV caches are dicts of preallocated tensors that the cache write fills
in place: (B, max_len, n_kv, dh) ``k``/``v`` for GQA, (B, max_len,
kv_lora) ``ckv`` and (B, max_len, rope_head_dim) ``krope`` for MLA.
"""
from __future__ import annotations

import functools

import torch
from torch import nn

from .config import ModelConfig
from .layers import Params, apply_rope, linear, linear_init, \
    remat_call, rms_headnorm, rmsnorm, rmsnorm_init, rope_angles
from .sharding import constrain


# ---------------------------------------------------------------------------
# chunked scaled-dot-product core
# ---------------------------------------------------------------------------

def _sdpa_chunk(qc, pc, kf, vf, kv_pos, ok_kv, *, causal: bool,
                window: int, sink: int, scale: float, dtype):
    """One query chunk of ``chunked_sdpa``: qc (B,cq,H,G,dh) at positions
    pc (cq,) against all of kf, vf (K and V in float32) → (B,cq,H,G,dv)
    in ``dtype``, V's own."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", qc.float(), kf) * scale
    s = constrain(s, "dp", "tp", None, None, None)
    ok = ok_kv[None, :]
    if causal:
        ok = ok & (kv_pos[None, :] <= pc[:, None])
    if window > 0:
        ok = ok & ((kv_pos[None, :] > pc[:, None] - window)
                   | (kv_pos[None, :] < sink))
    s = s.masked_fill(~ok, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)     # fully-masked rows
    # P rounds to V's dtype before the float32 P·V product
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(dtype).float(), vf)
    return o.to(dtype)


def chunked_sdpa(q, k, v, q_pos, kv_valid_upto, *, causal: bool = True,
                 window: int = 0, sink: int = 0, q_chunk: int = 256,
                 scale: float | None = None, kv_pos=None, kv_allowed=None):
    """q: (B,Sq,H,G,dh), k: (B,Skv,H,dh), v: (B,Skv,H,dv) → (B,Sq,H,G,dv).

    ``q_pos``: (Sq,) absolute query positions.  ``kv_valid_upto``: number
    of valid cache positions.  ``window``/``sink``: the DDM-planned read
    [0, sink) ∪ (q_pos − window, q_pos].  ``kv_pos``: explicit absolute
    positions of the kv rows (for gathered windows); then
    ``kv_valid_upto`` applies to positions and ``kv_allowed`` (bool
    (Skv,)) masks duplicate rows.
    """
    Sq, dh = q.shape[1], q.shape[-1]
    Skv = k.shape[1]
    scale = scale if scale is not None else dh ** -0.5
    if kv_pos is None:
        kv_pos = torch.arange(Skv, device=q.device)
    ok_kv = kv_pos < kv_valid_upto
    if kv_allowed is not None:
        ok_kv = ok_kv & kv_allowed
    # K and V upcast once for all chunks: their gradients sum over the
    # chunks in float32 and round to the model dtype once
    kf, vf = k.float(), v.float()
    chunk = functools.partial(_sdpa_chunk, causal=causal, window=window,
                              sink=sink, scale=scale, dtype=v.dtype)
    # the reference pads the last chunk with position -1 rows and drops
    # them; rows are independent, so here the last chunk is just shorter
    cq = min(q_chunk, Sq)
    return torch.cat([remat_call(chunk, q[:, c0:c0 + cq], q_pos[c0:c0 + cq],
                                 kf, vf, kv_pos, ok_kv)
                      for c0 in range(0, Sq, cq)], dim=1)


def _cache_write(cache: dict, new: dict, start: int) -> dict:
    """Write ``new``'s rows at ``[start, start + S)`` of the cache, in place.

    The reference's ``dynamic_update_slice`` clamps a start past
    ``max_len − S`` down to it, so an overlong write lands on the wrong
    positions; the port raises ``ValueError`` there instead.
    """
    for key, val in new.items():
        buf = cache[key]
        S = val.shape[1]
        if start < 0 or start + S > buf.shape[1]:
            raise ValueError(f"cache write of {S} rows at {start} is outside "
                             f"the cache's {buf.shape[1]} positions")
        buf[:, start:start + S] = val.to(buf.dtype)
    return cache


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

class GQA(nn.Module):
    def __init__(self, wq, wk, wv, wo):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo


def gqa_init(cfg: ModelConfig, *, generator=None, device="cuda") -> GQA:
    d, dh = cfg.d_model, cfg.d_head
    kw = dict(generator=generator, device=device)
    return GQA(
        linear_init(d, cfg.n_heads * dh, bias=cfg.qkv_bias, **kw),
        linear_init(d, cfg.n_kv_heads * dh, bias=cfg.qkv_bias, **kw),
        linear_init(d, cfg.n_kv_heads * dh, bias=cfg.qkv_bias, **kw),
        linear_init(cfg.n_heads * dh, d,
                    std=(cfg.n_heads * dh) ** -0.5
                    / max(2 * cfg.n_layers, 1) ** 0.5, **kw))


def gqa_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device="cuda") -> dict:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def window_gather(k_all, v_all, pos: int, window: int, sink: int):
    """The gather decode's kv rows for the query at ``pos``: the window
    ``[pos + 1 − W, pos]`` (its start clipped into the cache) after the
    sink prefix ``[0, sink)``.  Returns (k, v, kv_pos, kv_allowed); window
    rows that repeat a sink row are not allowed."""
    dev = k_all.device
    Smax = k_all.shape[1]
    W = min(window, Smax)
    start = min(max(pos + 1 - W, 0), Smax - W)
    k_win = k_all[:, start:start + W]
    v_win = v_all[:, start:start + W]
    kv_pos_w = start + torch.arange(W, device=dev)
    if sink <= 0:
        return k_win, v_win, kv_pos_w, torch.ones(W, dtype=torch.bool,
                                                  device=dev)
    return (torch.cat([k_all[:, :sink], k_win], dim=1),
            torch.cat([v_all[:, :sink], v_win], dim=1),
            torch.cat([torch.arange(sink, device=dev), kv_pos_w]),
            torch.cat([torch.ones(sink, dtype=torch.bool, device=dev),
                       kv_pos_w >= sink]))


def gqa_apply(p: GQA, x, cfg: ModelConfig, *, positions,
              cache: dict | None = None, cur_len: int = 0,
              causal: bool = True, window: int = 0, sink: int = 0):
    """One attention sublayer.  Returns (y, cache)."""
    B, S, _ = x.shape
    dh = cfg.d_head
    dt = x.dtype
    q = linear(p.wq, x, dt).reshape(B, S, cfg.n_heads, dh)
    k = linear(p.wk, x, dt).reshape(B, S, cfg.n_kv_heads, dh)
    v = linear(p.wv, x, dt).reshape(B, S, cfg.n_kv_heads, dh)
    q = constrain(q, "dp", None, "tp", None)
    k = constrain(k, "dp", None, "tp", None)
    v = constrain(v, "dp", None, "tp", None)
    if cfg.qk_norm:
        q, k = rms_headnorm(q), rms_headnorm(k)
    cos, sin = rope_angles(positions, dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if cache is not None:
        cache = _cache_write(cache, {"k": k, "v": v}, cur_len)
        k_all, v_all = cache["k"], cache["v"]
        valid = cur_len + S
    else:
        k_all, v_all = k, v
        valid = S
    g = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(B, S, cfg.n_kv_heads, g, dh)   # head h = kv·g + j

    if (cache is not None and S == 1 and window > 0
            and cfg.window_gather_decode):
        # DDM-window gather decode: only the window and the sink prefix
        # are read from the cache (traffic ∝ window, not context)
        k_cat, v_cat, kv_pos, allowed = window_gather(k_all, v_all, cur_len,
                                                      window, sink)
        out = chunked_sdpa(qg, k_cat, v_cat, positions, valid,
                           causal=causal, q_chunk=cfg.q_chunk,
                           kv_pos=kv_pos, kv_allowed=allowed)
    else:
        out = chunked_sdpa(qg, k_all, v_all, positions, valid,
                           causal=causal, window=window, sink=sink,
                           q_chunk=cfg.q_chunk)
    return constrain(linear(p.wo, out.reshape(B, S, -1), dt),
                     "dp", None, None), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): latent-compressed KV, decoupled RoPE key
# ---------------------------------------------------------------------------

class MLA(Params):
    """``w_dkv``, ``w_ukv``, ``wo``, ``kv_norm``, and ``w_dq``/``q_norm``/
    ``w_uq`` with a query LoRA, else ``wq``.

    The absorbed decode reads ``w_ukv``'s key half in float32 (its value
    half and the expanded read in the model dtype), so ``w_ukv`` keeps its
    float32 master under ``transformer.to_compute``."""

    def __init__(self, w_dkv, w_ukv, wo, kv_norm, w_dq=None, q_norm=None,
                 w_uq=None, wq=None):
        super().__init__()
        w_ukv.compute = ()
        self.w_dkv, self.w_ukv, self.wo, self.kv_norm = (w_dkv, w_ukv, wo,
                                                         kv_norm)
        self.w_dq, self.q_norm, self.w_uq, self.wq = w_dq, q_norm, w_uq, wq


def mla_init(cfg: ModelConfig, *, generator=None, device="cuda") -> MLA:
    d, nh = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    kw = dict(generator=generator, device=device)
    parts = dict(
        w_dkv=linear_init(d, cfg.kv_lora + dr, **kw),
        w_ukv=linear_init(cfg.kv_lora, nh * (dn + dv), **kw),
        wo=linear_init(nh * dv, d, std=(nh * dv) ** -0.5
                       / max(2 * cfg.n_layers, 1) ** 0.5, **kw),
        kv_norm=rmsnorm_init(cfg.kv_lora, device))
    if cfg.q_lora:
        parts.update(w_dq=linear_init(d, cfg.q_lora, **kw),
                     q_norm=rmsnorm_init(cfg.q_lora, device),
                     w_uq=linear_init(cfg.q_lora, nh * (dn + dr), **kw))
    else:
        parts["wq"] = linear_init(d, nh * (dn + dr), **kw)
    return MLA(**parts)


def mla_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device="cuda") -> dict:
    return {"ckv": torch.zeros((batch, max_len, cfg.kv_lora), dtype=dtype,
                               device=device),
            "krope": torch.zeros((batch, max_len, cfg.rope_head_dim),
                                 dtype=dtype, device=device)}


def mla_apply(p: MLA, x, cfg: ModelConfig, *, positions,
              cache: dict | None = None, cur_len: int = 0,
              causal: bool = True, window: int = 0, sink: int = 0):
    """One MLA sublayer.  Returns (y, cache)."""
    B, S, _ = x.shape
    dt = x.dtype
    nh = cfg.n_heads
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim

    # latent KV path; k_rope is rotated as a single head
    dkv = linear(p.w_dkv, x, dt)
    ckv, k_rope = dkv[..., :cfg.kv_lora], dkv[..., cfg.kv_lora:]
    ckv = rmsnorm(p.kv_norm, ckv, cfg.norm_eps)
    cos, sin = rope_angles(positions, dr, cfg.rope_theta)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]

    if cache is not None:
        cache = _cache_write(cache, {"ckv": ckv, "krope": k_rope}, cur_len)
        ckv_all, krope_all = cache["ckv"], cache["krope"]
        valid = cur_len + S
    else:
        ckv_all, krope_all = ckv, k_rope
        valid = S

    # queries
    if cfg.q_lora:
        cq = rmsnorm(p.q_norm, linear(p.w_dq, x, dt), cfg.norm_eps)
        q = linear(p.w_uq, cq, dt).reshape(B, S, nh, dn + dr)
    else:
        q = linear(p.wq, x, dt).reshape(B, S, nh, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, cos, sin)

    if cache is not None and S == 1 and cfg.mla_absorb:
        # absorbed decode (DeepSeek-V2 §2.1.4): W_uk folded into the
        # query and W_uv into the output, so attention reads the latent
        # cache directly; scores and softmax in float32, as the reference
        w_ukv = p.w_ukv.w.reshape(cfg.kv_lora, nh, dn + dv)
        w_uk = w_ukv[..., :dn].float()
        w_uv = w_ukv[..., dn:].to(dt)
        ckv_f = ckv_all.float()
        q_abs = torch.einsum("bqhd,lhd->bqhl", q_nope.float(), w_uk)
        s_nope = torch.einsum("bqhl,bkl->bhqk", q_abs, ckv_f)
        s_rope = torch.einsum("bqhd,bkd->bhqk", q_rope.float(),
                              krope_all.float())
        scores = (s_nope + s_rope) * ((dn + dr) ** -0.5)
        kv_pos = torch.arange(ckv_all.shape[1], device=x.device)
        ok = (kv_pos[None, :] < valid) & (kv_pos[None, :]
                                          <= positions[:, None])
        if window > 0:
            ok = ok & ((kv_pos[None, :] > positions[:, None] - window)
                       | (kv_pos[None, :] < sink))
        pr = torch.softmax(scores.masked_fill(~ok, float("-inf")), dim=-1)
        ctx = torch.einsum("bhqk,bkl->bqhl", pr, ckv_f).to(dt)
        out = torch.einsum("bqhl,lhd->bqhd", ctx, w_uv)
        y = linear(p.wo, out.reshape(B, S, nh * dv), dt)
        return constrain(y, "dp", None, None), cache

    # expand the latents to per-head K/V (prefill, or mla_absorb=False)
    Skv = ckv_all.shape[1]
    ukv = linear(p.w_ukv, ckv_all, dt).reshape(B, Skv, nh, dn + dv)
    k_nope, vv = ukv[..., :dn], ukv[..., dn:]
    kk = torch.cat([k_nope, krope_all[:, :, None, :].expand(B, Skv, nh, dr)],
                   dim=-1)
    qq = torch.cat([q_nope, q_rope], dim=-1).reshape(B, S, nh, 1, dn + dr)
    qq = constrain(qq, "dp", None, "tp", None, None)
    out = chunked_sdpa(qq, kk, vv, positions, valid, causal=causal,
                       window=window, sink=sink, q_chunk=cfg.q_chunk,
                       scale=(dn + dr) ** -0.5)
    y = linear(p.wo, out.reshape(B, S, nh * dv), dt)
    return constrain(y, "dp", None, None), cache


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def attn_init(cfg: ModelConfig, *, generator=None, device="cuda"):
    init = mla_init if cfg.mla else gqa_init
    return init(cfg, generator=generator, device=device)


def attn_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
                    device="cuda") -> dict:
    init = mla_cache_init if cfg.mla else gqa_cache_init
    return init(cfg, batch, max_len, dtype, device)


def attn_apply(p, x, cfg: ModelConfig, **kw):
    return (mla_apply if cfg.mla else gqa_apply)(p, x, cfg, **kw)
