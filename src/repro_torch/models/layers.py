"""Primitive layers: linear, norms, embeddings, RoPE; ``remat_call``.

The port of the JAX package's ``models/layers.py``.  Parameters live in
small ``nn.Module`` containers of fp32 master tensors, named as the
reference's parameter dicts (``w``/``b``, ``scale``, ``table``), so
``repro_torch.convert.lm_params_from_numpy`` maps one onto the other by
name.  Compute casts to the config dtype at use, as the reference does.
Initializers draw from an explicit ``torch.Generator``; with
``generator=None`` they only allocate (the caller fills the tensors).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


class Params(nn.Module):
    """A module of fp32 master tensors; ``cast`` reads one in a compute
    dtype, as the reference's ``astype`` at every use.

    ``compute`` names the tensors that the forward reads only in the
    compute dtype.  ``transformer.to_compute`` stores those in it once,
    for serving: a cast is deterministic, so the outputs are bit for bit
    those of casting at every use, and a decode step reads the bf16
    weights only.  An instance that the forward reads in float32 (the
    logits' projection, the gated norm's scale) clears its own.
    """
    compute: tuple[str, ...] = ()

    def cast(self, name: str, dtype: torch.dtype) -> torch.Tensor:
        t = getattr(self, name)
        return t if t.dtype == dtype else t.to(dtype)


def master(shape, device) -> nn.Parameter:
    """An uninitialised fp32 master tensor."""
    return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                    device=device))


def truncated_normal(t: torch.Tensor, std: float, generator) -> torch.Tensor:
    """Fill ``t`` with ``std`` times a standard normal truncated to ±3
    (the reference's ``std * truncated_normal(key, -3, 3)``), in place."""
    if generator is not None:
        with torch.no_grad():
            nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0,
                                  generator=generator).mul_(std)
    return t


# -- linear -----------------------------------------------------------------

class Linear(Params):
    """``{"w": (d_in, d_out), "b": (d_out,)}``; ``y = x @ w + b``."""
    compute = ("w", "b")

    def __init__(self, d_in: int, d_out: int, bias: bool, device):
        super().__init__()
        self.w = master((d_in, d_out), device)
        self.b = master((d_out,), device) if bias else None


def linear_init(d_in: int, d_out: int, *, bias: bool = False,
                std: float | None = None, generator=None,
                device="cuda") -> Linear:
    p = Linear(d_in, d_out, bias, device)
    truncated_normal(p.w, std if std is not None else d_in ** -0.5,
                     generator)
    if bias:
        with torch.no_grad():
            p.b.zero_()
    return p


def linear(p: Linear, x: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    # the product rounds to ``dtype``, then the bias add rounds again
    y = x.to(dtype) @ p.cast("w", dtype)
    if p.b is not None:
        y = y + p.cast("b", dtype)
    return y


# -- norms --------------------------------------------------------------------

class RMSNorm(Params):
    compute = ("scale",)

    def __init__(self, d: int, device):
        super().__init__()
        self.scale = master((d,), device)


def rmsnorm_init(d: int, device="cuda") -> RMSNorm:
    p = RMSNorm(d, device)
    with torch.no_grad():
        p.scale.fill_(1.0)
    return p


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    # the square in x.dtype, its mean in float32; rsqrt rounded to
    # x.dtype, then two products in x.dtype, in the reference's order
    var = torch.mean(torch.square(x), dim=-1, keepdim=True,
                     dtype=torch.float32)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * p.cast("scale", x.dtype)


def rms_headnorm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Parameter-free per-head RMS norm (qk-norm), in float32."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype)


# -- embedding ----------------------------------------------------------------

class Embed(Params):
    compute = ("table",)

    def __init__(self, vocab: int, d: int, device):
        super().__init__()
        self.table = master((vocab, d), device)


def embed_init(vocab: int, d: int, *, generator=None, device="cuda") -> Embed:
    p = Embed(vocab, d, device)
    truncated_normal(p.table, d ** -0.5, generator)
    return p


def embed(p: Embed, tokens: torch.Tensor, dtype=torch.bfloat16):
    # gather, then cast: the same values as the reference's cast-then-gather.
    # F.embedding's backward sums a token's rows in a fixed order on the
    # card too, where indexing's (index_put_ with accumulate) is not
    # promised to
    return F.embedding(tokens, p.table).to(dtype)


# -- rotary positional embedding ---------------------------------------------

def rope_angles(positions: torch.Tensor, dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables (..., dim/2) for integer positions."""
    # the inverse frequencies in NumPy float32, as the reference builds
    # them (a torch pow may differ in the last place)
    inv = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    inv = torch.from_numpy(inv).to(positions.device)
    ang = positions.to(torch.float32)[..., None] * inv[None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, heads, dim); rotates the two halves (not interleaved
    pairs), in float32."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)


# -- activations --------------------------------------------------------------

def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate.float()).to(gate.dtype) * up


def remat_call(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant) while
    autograd records through it (grad mode on and a tensor argument that
    requires grad): what ``fn`` saves for its backward is recomputed
    there instead of kept (the reference's ``jax.checkpoint``).  Called
    directly otherwise, so serving under ``no_grad`` pays nothing.  The
    recompute runs the same ops on the same inputs, so the gradients are
    bit for bit those of the direct call."""
    if torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)
