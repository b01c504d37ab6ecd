"""Mixture-of-Experts sublayer (the JAX package's ``models/moe.py``).

GShard/Switch-style capacity routing, the reference's function exactly:
tokens are split into groups of ``gt`` tokens (``gt = min(group_tokens,
S)``, lowered until it divides S, so a group never crosses a batch row);
in each group every one of the top-k slots gives each token a rank among
the group's tokens routed to the same expert, and a token whose rank
reaches the capacity C = max(4, ceil(gt/E · capacity_factor)) is dropped
from that slot (it contributes exactly 0; the residual stream carries
it).  The slots are summed one after another in the model dtype.

The reference computes each slot with one-hot dispatch and combine
einsums over every expert's (G, E, C, d) buffer, a slot at a time under
``jax.checkpoint``.  The port has that form too (under
``use_form("dense")``, each slot under ``remat_call``), whose shapes
depend on no routing decision, so a trace on fake tensors
(``launch.dryrun``) can follow it; serving and training use the index
form: the kept (token, slot) assignments of all slots are sorted by
expert, each expert that received tokens runs its
SwiGLU on its rows (one host read of the per-expert counts a call), and
the rows go back to their (token, slot) places.  So a decode step reads
the weights of the experts it routes to, not all E of them.  A one-hot
dispatch copies each token exactly and its combine multiplies one
product in float32 and rounds it to the model dtype, which is what the
index form does.

Top-k: ``torch.sort(..., stable=True)`` puts the lower expert index first
on equal probabilities, as ``jax.lax.top_k`` does (``torch.topk``'s order
on ties is unspecified, and bf16 router logits tie often).

DeepSeek-V2 style: ``n_shared_experts`` dense shared experts (one MLP of
width ``n_shared_experts · moe_d_ff``) run on every token and are added
last; ``first_dense_layers`` layers use the plain MLP (the stack's
business).
"""
from __future__ import annotations

import contextlib
import functools
import math

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import Params, linear, linear_init, master, remat_call, \
    swiglu, truncated_normal
from .mlp import mlp_apply, mlp_init
from .sharding import constrain

FORMS = ("index", "dense")
_FORM = ["index"]


@contextlib.contextmanager
def use_form(form: str):
    """Make ``form`` ("index" or "dense") the form that ``moe_apply``
    computes in, for the block."""
    if form not in FORMS:
        raise ValueError(f"MoE form {form!r} is not one of {FORMS}")
    _FORM.append(form)
    try:
        yield
    finally:
        _FORM.pop()


class MoE(Params):
    """``router`` (d, E), the experts' ``w_gate``/``w_up`` (E, d, f) and
    ``w_down`` (E, f, d), and ``shared`` (an MLP) when the config has
    shared experts.

    ``route_log``: None, or a list to which each ``moe_apply`` call
    appends its routing, ``{"idx": (G, gt, k) experts, "keep": (G, gt, k)
    bool}``, for a caller that inspects it (``chip_smoke.py``)."""
    compute = ("w_gate", "w_up", "w_down")

    def __init__(self, cfg: ModelConfig, router, shared, device):
        super().__init__()
        d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
        self.router = router
        self.w_gate = master((E, d, f), device)
        self.w_up = master((E, d, f), device)
        self.w_down = master((E, f, d), device)
        self.shared = shared
        self.route_log: list | None = None


def moe_init(cfg: ModelConfig, *, generator=None, device="cuda") -> MoE:
    kw = dict(generator=generator, device=device)
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    shared = (mlp_init(cfg, d_ff=cfg.n_shared_experts * f, **kw)
              if cfg.n_shared_experts else None)
    p = MoE(cfg, linear_init(d, E, **kw), shared, device)
    truncated_normal(p.w_gate, d ** -0.5, generator)
    truncated_normal(p.w_up, d ** -0.5, generator)
    truncated_normal(p.w_down, f ** -0.5 / max(2 * cfg.n_layers, 1) ** 0.5,
                     generator)
    return p


def group_size(S: int, group_tokens: int) -> int:
    """Tokens a group: ``min(group_tokens, S)`` lowered until it divides
    S (so a prime S above ``group_tokens`` gives 1)."""
    gt = min(group_tokens, S)
    while S % gt:
        gt -= 1
    return gt


def _route(p: MoE, xg, cfg: ModelConfig):
    """Router: (vals (G,gt,k) renormalised, idx (G,gt,k), aux)."""
    E, k = cfg.n_experts, cfg.top_k
    # the product in the model dtype, upcast after (the reference's)
    logits = constrain(linear(p.router, xg, xg.dtype).float(),
                       "dp", None, None)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    vals = vals / vals.sum(dim=-1, keepdim=True)
    # Switch load-balance loss over all slots, in float32
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(idx, E).float().sum(dim=2).mean(dim=(0, 1))
    aux = E * torch.sum(me * ce) / k
    return vals, idx, aux


def _keep(idx, E: int, C: int):
    """Per slot, whether each token's rank among the group's tokens
    routed to the same expert is below C: bool (G, gt, k)."""
    one = F.one_hot(idx, E)                            # (G, gt, k, E)
    rank = torch.cumsum(one, dim=1) - 1
    return (rank * one).sum(dim=-1) < C


def _experts(p: MoE, x, token, expert, dt):
    """For each assignment i, row ``token[i]`` of ``x`` (T, d) through
    expert ``expert[i]``'s SwiGLU, in ``dt``: (n, d); an assignment whose
    expert is E (dropped) gets 0."""
    E = p.w_gate.shape[0]
    order = torch.argsort(expert, stable=True)
    counts = torch.bincount(expert, minlength=E + 1)[:E].tolist()
    kept = order[:sum(counts)]                  # grouped by expert
    xs = x[token[kept]]
    ys, start = [], 0
    for e, n in enumerate(counts):
        if n:
            rows = xs[start:start + n]
            h = swiglu(rows @ p.w_gate[e].to(dt), rows @ p.w_up[e].to(dt))
            ys.append(h @ p.w_down[e].to(dt))
            start += n
    y = torch.zeros((expert.numel(), x.shape[-1]), dtype=dt,
                    device=x.device)
    if ys:
        y[kept] = torch.cat(ys)
    return y


def _dense_slot(xg, slot_idx, slot_vals, w_gate, w_up, w_down, *, E: int,
                C: int, dt):
    """One top-k slot of the reference's dispatch: (G, gt, E, C) one-hot
    dispatch and combine tensors around the experts' batched SwiGLU over
    every expert's (G, E, C, d) buffer → (G, gt, d) in ``dt``."""
    e_onehot = F.one_hot(slot_idx, E)                         # (G, gt, E)
    rank = torch.cumsum(e_onehot, dim=1) - 1
    my_rank = (rank * e_onehot).sum(dim=-1)                   # (G, gt)
    keep = my_rank < C
    # the rank C (dropped) has no column: an all-zero one-hot row
    pos = F.one_hot(torch.where(keep, my_rank, C), C + 1)[..., :C]
    disp = e_onehot.to(dt)[..., None] * pos.to(dt)[:, :, None, :]
    xe = torch.einsum("gtec,gtd->gecd", disp.float(), xg.float()).to(dt)
    xe = constrain(xe, "dp", "tp", None, None)
    h = swiglu(torch.einsum("gecd,edf->gecf", xe, w_gate),
               torch.einsum("gecd,edf->gecf", xe, w_up))
    ye = constrain(torch.einsum("gecf,efd->gecd", h, w_down),
                   "dp", "tp", None, None)
    comb = disp * (slot_vals * keep).to(dt)[..., None, None]
    return torch.einsum("gtec,gecd->gtd", comb.float(), ye.float()).to(dt)


def _dense_slots(p: MoE, xg, vals, idx, E: int, C: int, dt):
    """The reference's dispatch: ``_dense_slot`` for each slot, each under
    ``remat_call`` (the reference's ``jax.checkpoint`` of ``one_slot``: a
    slot's one-hots and expert activations are recomputed in the
    backward instead of living for all k slots), the slots summed in
    ``dt``."""
    weights = [p.cast(n, dt) for n in ("w_gate", "w_up", "w_down")]
    slot = functools.partial(_dense_slot, E=E, C=C, dt=dt)
    out = torch.zeros_like(xg)
    for k in range(idx.shape[-1]):
        out = out + remat_call(slot, xg, idx[..., k], vals[..., k],
                               *weights)
    return out


def moe_apply(p: MoE, x, cfg: ModelConfig, *, group_tokens: int = 1024):
    """x: (B, S, d) → (y, aux loss float32), in the form ``use_form`` set
    ("index" outside any; "dense" is the same function)."""
    B, S, d = x.shape
    dt = x.dtype
    E, k = cfg.n_experts, cfg.top_k
    gt = group_size(S, group_tokens)
    G = B * (S // gt)
    xg = constrain(x.reshape(G, gt, d), "dp", None, None)
    C = max(4, math.ceil(gt / E * cfg.capacity_factor))

    vals, idx, aux = _route(p, xg, cfg)
    keep = _keep(idx, E, C)
    if p.route_log is not None:
        p.route_log.append({"idx": idx, "keep": keep})
    if _FORM[-1] == "dense":
        y = _dense_slots(p, xg, vals, idx, E, C, dt).reshape(B, S, d)
        if p.shared is not None:
            y = y + mlp_apply(p.shared, x, dt)
        return y, aux
    T = G * gt
    expert = torch.where(keep, idx, E).reshape(T * k)
    token = torch.arange(T, device=x.device).repeat_interleave(k)
    ye = _experts(p, xg.reshape(T, d), token, expert, dt).reshape(T, k, d)
    w = (vals * keep).to(dt).reshape(T, k)
    out = torch.zeros((T, d), dtype=dt, device=x.device)
    for slot in range(k):
        # the combine: one float32 product a kept token, rounded to dt
        out = out + (w[:, slot, None].float() * ye[:, slot].float()).to(dt)

    y = out.reshape(B, S, d)
    if p.shared is not None:
        y = y + mlp_apply(p.shared, x, dt)
    return y, aux
