"""Step factories: train / prefill / decode closures + abstract inputs.

The port of the JAX package's ``launch/steps.py``.  Where the reference
returns ``jax.ShapeDtypeStruct`` stand-ins, ``input_structs``,
``abstract_params``, ``abstract_opt`` and ``abstract_cache`` return
tensors on the ``meta`` device: shapes and dtypes, no storage.

A train step takes the model (``params``), the AdamW state and a batch
of tensors on the model's device, and updates the model and the state in
place (``optim.adamw_update``); it returns them with the metrics.
"""
from __future__ import annotations

import torch

from ..configs import ShapeSpec
from ..models import transformer as T
from ..models.config import ModelConfig
from ..optim import AdamWConfig, adamw_init, adamw_update

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_structs(cfg: ModelConfig, spec: ShapeSpec) -> dict:
    """Data inputs (tokens etc.) for one cell, as meta tensors."""
    B = spec.global_batch
    if spec.kind in ("train", "prefill"):
        seq = spec.seq_len + (spec.kind == "train")
        batch = {"tokens": _meta((B, seq), torch.int32)}
        if cfg.family == "audio":
            batch["frames"] = _meta((B, cfg.enc_frames, cfg.d_model),
                                    torch.bfloat16)
        return batch
    # decode: one new token against a cache of seq_len
    return {"tokens": _meta((B, 1), torch.int32),
            "cur_len": _meta((), torch.int32)}


def abstract_params(cfg: ModelConfig):
    return T.init_params(cfg, None, META)


def abstract_opt(cfg: ModelConfig):
    return adamw_init(dict(abstract_params(cfg).named_parameters()))


def abstract_cache(cfg: ModelConfig, spec: ShapeSpec):
    return T.init_cache(cfg, spec.global_batch, spec.seq_len, META)


def loss_and_grads(params: T.LM, batch: dict, cfg: ModelConfig):
    """(loss, metrics, {name: gradient}) of ``T.loss_fn`` on one batch;
    a parameter the loss does not reach gets a zero gradient."""
    named = dict(params.named_parameters())
    loss, metrics = T.loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, list(named.values()),
                                allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(named.items(), grads)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig):
    """Train step with optional gradient accumulation (``cfg.grad_accum``
    microbatches, one after another: activation memory ÷ k at the cost
    of k smaller matmuls).  The gradients are summed as the reference's
    scan does, ``acc + g.float()/k`` in microbatch order, and the
    optimizer sees their mean; loss and metrics are the microbatches'
    means."""
    k = max(cfg.grad_accum, 1)

    def train_step(params: T.LM, opt_state: dict, batch: dict):
        if k == 1:
            loss, metrics, grads = loss_and_grads(params, batch, cfg)
        else:
            grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in params.named_parameters()}
            losses, ms = [], []
            for i in range(k):
                mbatch = {key: a.reshape((k, a.shape[0] // k)
                                         + a.shape[1:])[i]
                          for key, a in batch.items()}
                loss_i, m_i, g_i = loss_and_grads(params, mbatch, cfg)
                for n, g in g_i.items():
                    grads[n] = grads[n] + g.float() / k
                del g_i
                losses.append(loss_i)
                ms.append(m_i)
            loss = torch.stack(losses).mean()
            metrics = {key: torch.stack([m[key] for m in ms]).mean()
                       for key in ms[0]}
        _, opt_state, opt_metrics = adamw_update(
            dict(params.named_parameters()), grads, opt_state, opt_cfg)
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, cache, batch):
        return T.prefill(params, batch["tokens"], cfg, cache,
                         frames=batch.get("frames"))

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, cache, batch):
        """``batch["cur_len"]``: the cache fill, a host int."""
        return T.decode_step(params, batch["tokens"], cfg, cache,
                             int(batch["cur_len"]))

    return decode_step
