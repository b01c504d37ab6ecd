"""Dense SwiGLU MLP sublayer (the JAX package's ``models/mlp.py``)."""
from __future__ import annotations

from torch import nn

from .config import ModelConfig
from .layers import linear, linear_init, swiglu
from .sharding import constrain


class MLP(nn.Module):
    def __init__(self, w_gate, w_up, w_down):
        super().__init__()
        self.w_gate, self.w_up, self.w_down = w_gate, w_up, w_down


def mlp_init(cfg: ModelConfig, d_ff: int | None = None, *, generator=None,
             device="cuda") -> MLP:
    d_ff = d_ff or cfg.d_ff
    kw = dict(generator=generator, device=device)
    return MLP(
        linear_init(cfg.d_model, d_ff, **kw),
        linear_init(cfg.d_model, d_ff, **kw),
        linear_init(d_ff, cfg.d_model,
                    std=d_ff ** -0.5 / max(2 * cfg.n_layers, 1) ** 0.5,
                    **kw))


def mlp_apply(p: MLP, x, dtype=None):
    dt = dtype or x.dtype
    h = swiglu(linear(p.w_gate, x, dt), linear(p.w_up, x, dt))
    h = constrain(h, "dp", None, "tp")
    return constrain(linear(p.w_down, h, dt), "dp", None, None)
