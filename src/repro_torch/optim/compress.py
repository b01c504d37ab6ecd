"""int8 stochastic-rounding gradient compression: the port of the JAX
package's ``optim/compress.py``.

Gradients are quantized to int8 with a per-tensor scale (amax / 127);
stochastic rounding keeps the quantizer unbiased (E[q·scale] = x).  The
reference's docstring says that ``launch.train`` uses it under
``--compress-grads``; neither launcher has that flag, and nothing in
either package calls ``compress_tree`` (ROADMAP Queue 3 item Q).

The uniforms come from an explicit ``torch.Generator``.  JAX's
``jax.random.uniform`` draws cannot be reproduced, so ``quantize_int8``,
which takes the uniforms as an argument, holds the arithmetic: given the
same uniforms it is bit for bit the reference's.
"""
from __future__ import annotations

from typing import Mapping

import torch


def quantize_int8(x: torch.Tensor, rnd: torch.Tensor):
    """(q int8, scale float32 0-dim) from ``x`` and uniforms ``rnd`` in
    [0, 1) of ``x``'s shape: q = clip(floor(y) + (rnd < frac(y)), ±127),
    y = x / scale."""
    xf = x.float()
    amax = torch.max(torch.abs(xf))
    scale = torch.where(amax > 0, amax / torch.tensor(
        127.0, device=x.device), torch.ones_like(amax))
    y = xf / scale
    lo = torch.floor(y)
    q = lo + (rnd < y - lo).float()
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def compress_int8(x: torch.Tensor, generator: torch.Generator):
    """(q int8, scale float32); unbiased via stochastic rounding."""
    rnd = torch.rand(x.shape, generator=generator, device=x.device)
    return quantize_int8(x, rnd)


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads: Mapping[str, torch.Tensor],
                  generator: torch.Generator):
    """({name: q}, {name: scale}), the leaves drawn in mapping order
    from one generator."""
    out = {k: compress_int8(g, generator) for k, g in grads.items()}
    return ({k: q for k, (q, _) in out.items()},
            {k: s for k, (_, s) in out.items()})


def decompress_tree(qs: Mapping[str, torch.Tensor],
                    scales: Mapping[str, torch.Tensor]) -> dict:
    return {k: decompress_int8(q, scales[k]) for k, q in qs.items()}
