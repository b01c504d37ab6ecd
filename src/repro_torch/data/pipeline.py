"""Deterministic synthetic token pipeline, host-sharded: the port's copy
of the JAX package's ``data/pipeline.py`` (NumPy; it imports no JAX).

The batch for (step, host) is a pure function of (seed, step, host): no
coordinator, no state, so a host that restarts regenerates exactly its
shard and elastic re-scale re-partitions the host-index space.  The
token source is a synthetic mixture (zipfian unigrams + periodic motifs)
so that the loss has learnable structure.  Batches are NumPy int32,
byte-equal to the reference's; the trainer moves them to its device.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1


def _zipf_probs(vocab: int, a: float = 1.2):
    r = np.arange(1, vocab + 1, dtype=np.float64)
    p = 1.0 / r ** a
    return p / p.sum()


class SyntheticTokens:
    """Iterator-style pipeline: ``batch(step, host)`` -> (B_host, S+1)."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError(f"global_batch {cfg.global_batch} is not a "
                             f"multiple of n_hosts {cfg.n_hosts}")
        self.cfg = cfg
        self._probs = _zipf_probs(cfg.vocab)

    def batch(self, step: int, host: int = 0) -> np.ndarray:
        cfg = self.cfg
        bh = cfg.global_batch // cfg.n_hosts
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, host]))
        toks = rng.choice(cfg.vocab, size=(bh, cfg.seq_len + 1),
                          p=self._probs)
        # periodic motif: learnable second-order structure
        period = 7 + (step % 5)
        motif = rng.integers(0, cfg.vocab, size=(bh, 1))
        idx = np.arange(cfg.seq_len + 1)[None, :]
        mask = (idx % period) == (step % period)
        toks = np.where(mask, motif, toks)
        return toks.astype(np.int32)

    def global_batch(self, step: int) -> np.ndarray:
        return np.concatenate(
            [self.batch(step, h) for h in range(self.cfg.n_hosts)], axis=0)
