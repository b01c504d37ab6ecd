"""Mamba-2 (SSD, state-space duality) mixer — arXiv:2405.21060.

The port of the JAX package's ``models/ssm.py``.  Chunked SSD: within a
chunk of Q tokens the recurrence runs in its dual quadratic form (plain
``einsum``s), across chunks a Python loop carries the (heads, head_dim,
d_state) state where the reference runs a ``lax.scan``.  Single-token
decode is the bare recurrence on the carried state.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import Params, RMSNorm, linear, linear_init, master, \
    rmsnorm_init, truncated_normal
from .sharding import constrain


class Mamba2(Params):
    # A_log, dt_bias and D are read in float32
    compute = ("conv_w", "conv_b")

    def __init__(self, cfg: ModelConfig, in_proj, out_proj, norm: RMSNorm,
                 device):
        super().__init__()
        norm.compute = ()             # the gated norm scales in float32
        conv_ch = cfg.d_inner + 2 * cfg.ssm_state
        nh = cfg.n_ssm_heads
        self.in_proj, self.out_proj, self.norm = in_proj, out_proj, norm
        self.conv_w = master((cfg.conv_width, conv_ch), device)
        self.conv_b = master((conv_ch,), device)
        self.A_log = master((nh,), device)
        self.dt_bias = master((nh,), device)
        self.D = master((nh,), device)


def _inv_softplus(x):
    return x + torch.log(-torch.expm1(-x))


def mamba2_init(cfg: ModelConfig, *, generator=None, device="cuda") -> Mamba2:
    d, di, ns = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh = cfg.n_ssm_heads
    kw = dict(generator=generator, device=device)
    p = Mamba2(cfg, linear_init(d, 2 * di + 2 * ns + nh, **kw),
               linear_init(di, d, std=di ** -0.5
                           / max(2 * cfg.n_layers, 1) ** 0.5, **kw),
               rmsnorm_init(di, device), device)
    conv_ch = di + 2 * ns
    truncated_normal(p.conv_w, conv_ch ** -0.5, generator)
    with torch.no_grad():
        p.conv_b.zero_()
        p.D.fill_(1.0)
        if generator is not None:
            dt = torch.empty(nh, device=device).uniform_(
                math.log(1e-3), math.log(1e-1), generator=generator).exp_()
            a_init = torch.empty(nh, device=device).uniform_(
                1.0, 16.0, generator=generator)
            p.A_log.copy_(torch.log(a_init))
            p.dt_bias.copy_(_inv_softplus(dt))
    return p


def mamba2_cache_init(cfg: ModelConfig, batch: int, dtype,
                      device="cuda") -> dict:
    di, ns = cfg.d_inner, cfg.ssm_state
    nh, hd = cfg.n_ssm_heads, cfg.ssm_head_dim
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, di + 2 * ns),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, nh, hd, ns), dtype=torch.float32,
                           device=device),
    }


def _causal_conv(xbc, w, b, state=None):
    """Depthwise causal conv, width W.  xbc: (B,S,C); state: (B,W-1,C).

    The W shifted products are summed in ``xbc.dtype``, in index order,
    each product and each partial sum rounded as the reference's; the
    SiLU is in float32.
    """
    W = w.shape[0]
    if state is None:
        pad = torch.zeros((xbc.shape[0], W - 1, xbc.shape[2]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)
    new_state = xp[:, -(W - 1):, :] if W > 1 else None
    S = xbc.shape[1]
    wd = w.to(xbc.dtype)
    out = xp[:, 0:S, :] * wd[0]
    for i in range(1, W):
        out = out + xp[:, i:i + S, :] * wd[i]
    out = out + b.to(xbc.dtype)
    return F.silu(out.float()).to(xbc.dtype), new_state


def _segsum(a):
    """a: (..., Q) → (..., Q, Q) with [i,j] = sum_{k=j+1..i} a_k (i≥j)."""
    Q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, float("-inf"))


def _ssd_chunked(xdt, a, Bm, Cm, chunk: int, h0=None):
    """Chunked SSD.  xdt: (B,S,H,P) (inputs pre-scaled by dt),
    a: (B,S,H) log-decay (=dt·A, negative), Bm/Cm: (B,S,N) shared across
    heads (single group).  Returns (y (B,S,H,P) float32, final state
    (B,H,P,N))."""
    b, s, h, p = xdt.shape
    n = Bm.shape[-1]
    Q = min(chunk, s)
    pad = (-s) % Q
    if pad:
        # a = 0 pads: chunk decay exp(0) = 1 and zero input; the carried
        # state passes through unchanged and padded outputs are trimmed
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    s_p = s + pad
    nc = s_p // Q
    xc = xdt.reshape(b, nc, Q, h, p).float()
    ac = a.reshape(b, nc, Q, h).float()
    Bc = Bm.reshape(b, nc, Q, n).float()
    Cc = Cm.reshape(b, nc, Q, n).float()

    acum = torch.cumsum(ac, dim=2)                           # (b,nc,Q,h)
    L = torch.exp(_segsum(ac.transpose(2, 3)))               # (b,nc,h,Q,Q)

    # intra-chunk (dual quadratic form): scores ∘ L first, then the sum
    # over s, the order opt_einsum picks for the reference's three-operand
    # einsum
    scores = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores[:, :, None] * L, xc)

    # chunk-final states
    decay_states = torch.exp(acum[:, :, -1:, :] - acum)      # (b,nc,Q,h)
    states = torch.einsum("bcsn,bcshp->bchpn", Bc,
                          xc * decay_states[..., None])

    # inter-chunk recurrence (the reference's lax.scan)
    chunk_decay = torch.exp(acum[:, :, -1, :])               # (b,nc,h)
    hprev = (torch.zeros((b, h, p, n), dtype=torch.float32,
                         device=xdt.device) if h0 is None else h0)
    hprevs = []
    for c in range(nc):
        hprevs.append(hprev)
        hprev = hprev * chunk_decay[:, c, :, None, None] + states[:, c]
    hprevs = torch.stack(hprevs, dim=1)                      # (b,nc,h,p,n)

    # off-diagonal (carried state) contribution
    out_decay = torch.exp(acum)                              # (b,nc,Q,h)
    y_off = torch.einsum("bcln,bchpn->bclhp", Cc, hprevs) \
        * out_decay[..., None]
    y = (y_diag + y_off).reshape(b, s_p, h, p)[:, :s]
    return y, hprev


def mamba2_apply(p: Mamba2, x, cfg: ModelConfig, *,
                 cache: dict | None = None):
    """One Mamba-2 mixer.  x: (B,S,d).  Returns (y, new_cache).

    Training/prefill: cache=None (or a fresh cache to fill, S ≥ 1).
    Decode: S == 1 with a carried cache.
    """
    B, S, _ = x.shape
    dt_ = x.dtype
    di, ns = cfg.d_inner, cfg.ssm_state
    nh, hd = cfg.n_ssm_heads, cfg.ssm_head_dim

    proj = linear(p.in_proj, x, dt_)
    z, xi, Bm, Cm, dt_raw = torch.split(proj, [di, di, ns, ns, nh], dim=-1)
    xbc = constrain(torch.cat([xi, Bm, Cm], dim=-1), "dp", None, "tp")

    conv_state = cache["conv"] if cache is not None else None
    xbc, new_conv = _causal_conv(xbc, p.cast("conv_w", dt_),
                                 p.cast("conv_b", dt_), conv_state)
    xi, Bm, Cm = torch.split(xbc, [di, ns, ns], dim=-1)

    # jax.nn.softplus is logaddexp(x, 0); torch's is x itself above 20,
    # where the two differ by less than float32 resolves (log1p(e^-20)
    # ≈ 2e-9 against an ulp of 20 of 1.9e-6)
    dt = F.softplus(dt_raw.float() + p.dt_bias)              # (B,S,nh)
    A = -torch.exp(p.A_log)                                  # (nh,)
    a = dt * A                                               # log decay
    xh = constrain(xi.reshape(B, S, nh, hd), "dp", None, "tp", None)
    xdt = xh.float() * dt[..., None]

    if cache is not None and S == 1:
        # bare recurrence
        h0 = cache["ssm"]
        dec = torch.exp(a[:, 0, :])                          # (B,nh)
        upd = torch.einsum("bn,bhp->bhpn", Bm[:, 0].float(), xdt[:, 0])
        hnew = h0 * dec[:, :, None, None] + upd
        y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(),
                         hnew)[:, None]                      # (B,1,nh,hd)
        new_cache = {"conv": new_conv, "ssm": hnew}
    else:
        h0 = cache["ssm"] if cache is not None else None
        y, hlast = _ssd_chunked(xdt, a, Bm, Cm, cfg.ssd_chunk, h0)
        new_cache = None if cache is None else {"conv": new_conv,
                                                "ssm": hlast}

    y = y + p.D[:, None] * xh.float()
    y = y.reshape(B, S, di).to(dt_)
    # gated RMS norm, eps = cfg.norm_eps, in float32 after the gate
    g = y * F.silu(z.float()).to(dt_)
    gf = g.float()
    var = torch.mean(torch.square(gf), dim=-1, keepdim=True)
    g = (gf * torch.rsqrt(var + cfg.norm_eps) * p.norm.scale).to(dt_)
    return constrain(linear(p.out_proj, g, dt_), "dp", None, None), \
        new_cache
