"""Fault-tolerant training runtime: the port of the JAX package's
``runtime/trainer.py``.

  * periodic sharded checkpoints (atomic rename), synchronous or async,
    in the reference's on-disk layout (``{"params", "opt": {m, v,
    step}}`` as the reference's trees, ``convert.lm_params_to_numpy``);
  * restart = ``init_state`` + restore of the latest checkpoint + replay
    of the deterministic data pipeline from that step: a run that fails
    and restarts is bit for bit an uninterrupted one, on the CPU and on
    the card (the step is deterministic there: ``layers.embed``'s
    backward and ``loss_fn``'s gold logit avoid the ops whose backward
    accumulates in no fixed order);
  * failure injection (``SimulatedFailure``) at any step;
  * the restore reshards through the engine's plan
    (``checkpoint.sharded``).

As in the reference, the step ignores ``cfg.grad_accum`` (ROADMAP Queue
3 item P): it is ``launch.steps.make_train_step`` at one microbatch, so
a config with ``grad_accum = 4`` trains on the whole batch at once.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..checkpoint.sharded import AsyncSaver, latest_step, restore, save
from ..convert import (load_lm_params, lm_params_to_numpy, named_to_tree,
                       opt_state_from_numpy, opt_state_to_numpy)
from ..core.regions import resolve_device
from ..data.pipeline import DataConfig, SyntheticTokens
from ..launch.steps import make_train_step
from ..models import transformer as T
from ..models.config import ModelConfig
from ..optim import AdamWConfig, adamw_init


class SimulatedFailure(RuntimeError):
    """Injected node failure (tests / chaos drills)."""


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str
    ckpt_every: int = 5
    n_ckpt_shards: int = 1
    async_ckpt: bool = False
    log_every: int = 1


class Trainer:
    def __init__(self, model_cfg: ModelConfig, opt_cfg: AdamWConfig,
                 tcfg: TrainerConfig, data_cfg: DataConfig,
                 seed: int = 0, device="cuda"):
        self.model_cfg = model_cfg
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.data = SyntheticTokens(data_cfg)
        self._seed = seed
        self._saver = AsyncSaver()
        self._step_fn = make_train_step(
            dataclasses.replace(model_cfg, grad_accum=1), opt_cfg)

    def init_state(self):
        params = T.init_params(
            self.model_cfg,
            torch.Generator(self.device).manual_seed(self._seed),
            self.device)
        return params, adamw_init(dict(params.named_parameters()))

    def _batch(self, step: int) -> dict:
        """Step ``step``'s batch on the trainer's device: the pipeline's
        tokens, and for the audio family frames of
        ``np.random.default_rng(step)`` normals × 0.1 (the reference's)."""
        batch = {"tokens": torch.from_numpy(self.data.global_batch(step))}
        if self.model_cfg.family == "audio":
            rng = np.random.default_rng(step)
            batch["frames"] = torch.from_numpy(rng.normal(size=(
                self.data.cfg.global_batch, self.model_cfg.enc_frames,
                self.model_cfg.d_model)).astype(np.float32) * 0.1)
        return {k: v.to(self.device) for k, v in batch.items()}

    def _tree(self, params, opt_state) -> dict:
        return {"params": lm_params_to_numpy(self.model_cfg, params),
                "opt": opt_state_to_numpy(opt_state)}

    def _restore(self, step: int, params):
        shapes = named_to_tree({n: torch.empty_like(p, device="meta")
                                for n, p in params.named_parameters()})
        template = {"params": shapes, "opt": {
            "m": shapes, "v": shapes,
            "step": torch.empty((), dtype=torch.int32, device="meta")}}
        tree = restore(self.tcfg.ckpt_dir, step, template,
                       n_shards_new=self.tcfg.n_ckpt_shards,
                       device=self.device)
        load_lm_params(params, tree["params"])
        return params, opt_state_from_numpy(
            tree["opt"], dict(params.named_parameters()))

    # -- one contiguous attempt (may die on injected failure) -------------
    def run(self, n_steps: int, *,
            failure_at: int | None = None,
            on_step: Callable[[int, dict], None] | None = None):
        params, opt_state = self.init_state()
        start = 0
        last = latest_step(self.tcfg.ckpt_dir)
        if last is not None:
            params, opt_state = self._restore(last, params)
            start = last
        metrics = {}
        for step in range(start, n_steps):
            if failure_at is not None and step == failure_at:
                raise SimulatedFailure(f"injected failure at step {step}")
            params, opt_state, metrics = self._step_fn(
                params, opt_state, self._batch(step))
            done = step + 1
            if done % self.tcfg.ckpt_every == 0 or done == n_steps:
                tree = self._tree(params, opt_state)
                if self.tcfg.async_ckpt:
                    self._saver.save(self.tcfg.ckpt_dir, done, tree,
                                     n_shards=self.tcfg.n_ckpt_shards)
                else:
                    save(self.tcfg.ckpt_dir, done, tree,
                         n_shards=self.tcfg.n_ckpt_shards)
                del tree
            if on_step is not None:
                on_step(step, metrics)
        self._saver.wait()
        return params, opt_state, metrics

    # -- supervised attempts with restart ---------------------------------
    def run_resilient(self, n_steps: int, *, failures: tuple[int, ...] = (),
                      max_restarts: int = 8, on_step=None):
        """Run to completion, restarting from the latest checkpoint after
        each injected failure (the restart path real node loss takes)."""
        pending = list(failures)
        for _ in range(max_restarts + 1):
            try:
                fail_at = pending[0] if pending else None
                return self.run(n_steps, failure_at=fail_at,
                                on_step=on_step)
            except SimulatedFailure:
                pending.pop(0)
        raise RuntimeError("exceeded max_restarts")
