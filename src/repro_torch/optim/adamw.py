"""AdamW with decoupled weight decay, cosine LR schedule, global-norm
clipping: the port of the JAX package's ``optim/adamw.py``.

Parameters, gradients and the moments are mappings from parameter name to
tensor (``dict(model.named_parameters())``); the state is ``{"m", "v"}``
in float32 per parameter plus an int32 0-dim ``step``, as the
reference's.  ``adamw_update`` writes the parameters and moments in place
(a functional update would hold a second copy of all three, 29 GB at
Zamba2-2.7B's width) and returns them with the new step.

The arithmetic is the reference's, in float32 and in its order: the
clip scale ``min(1, max_norm / (norm + 1e-9))`` applied as
``(g·scale).to(g.dtype)``, ``m2 = b1·m + (1−b1)·g``, ``v2 = b2·v +
(1−b2)·g·g``, ``delta = (m2/b1c) / (sqrt(v2/b2c) + eps)``, ``p −
lr·(delta + wd·p)``, with ``b1c = 1 − b1**step`` taken in float32.  Every
division is between tensors: PyTorch's CUDA division by a host scalar
multiplies by its reciprocal instead, and ``scalar / tensor`` is a
reciprocal on every device.  So this is not ``torch.optim.AdamW``, which
decays first and divides ``sqrt(v)`` by ``sqrt(b2c)``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _const(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor), a
    float32 0-dim tensor on the step's device."""
    s = (step.to(torch.float32) if torch.is_tensor(step)
         else torch.tensor(step, dtype=torch.float32))
    dev = s.device
    warm = torch.minimum(s / _const(max(cfg.warmup_steps, 1), dev),
                         _const(1.0, dev))
    prog = torch.clamp((s - cfg.warmup_steps)
                       / _const(max(cfg.total_steps - cfg.warmup_steps, 1),
                                dev), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(_const(math.pi, dev) * prog))
    scale = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * scale


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the float32 sum of squares, leaf sums added in the
    mapping's order."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tree.values()))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(_const(max_norm, norm.device) / (norm + 1e-9),
                       max=1.0)


def clip_by_global_norm(tree: Mapping[str, torch.Tensor], max_norm: float):
    """(the tree scaled to global norm at most ``max_norm``, its norm)."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return {k: (t.float() * scale).to(t.dtype) for k, t in tree.items()}, norm


def adamw_init(params: Mapping[str, torch.Tensor]) -> dict:
    """Zero moments in float32 beside each parameter, step 0 (int32)."""
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    dev = next(iter(params.values())).device
    return {"m": zeros, "v": {k: torch.zeros_like(z) for k, z in
                              zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adamw_update(params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], state: dict,
                 cfg: AdamWConfig):
    """One AdamW step, in place on ``params`` and the state's moments.

    Returns (params, new state, {"grad_norm", "lr"}), the metrics float32
    0-dim tensors."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    step = state["step"] + 1
    lr = cosine_schedule(cfg, step)
    sf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(_const(cfg.b1, sf.device), sf)
    b2c = 1.0 - torch.pow(_const(cfg.b2, sf.device), sf)
    for name, p in params.items():
        g = grads[name]
        gf = (g.float() * scale).to(g.dtype).float()
        m, v = state["m"][name], state["v"][name]
        m2 = cfg.b1 * m + (1 - cfg.b1) * gf
        v2 = cfg.b2 * v + (1 - cfg.b2) * gf * gf
        delta = (m2 / b1c) / (torch.sqrt(v2 / b2c) + cfg.eps)
        pf = p.float()
        p.copy_(pf - lr * (delta + cfg.weight_decay * pf))
        m.copy_(m2)
        v.copy_(v2)
    new_state = {"m": state["m"], "v": state["v"], "step": step}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
