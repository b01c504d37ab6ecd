"""Training launcher: the port of the JAX package's ``launch/train.py``.

Single-host entry point driving the fault-tolerant runtime
(``runtime.trainer``), with the reference's flags and log lines plus
``--device`` (default ``cuda``; there is no CPU fallback, ``--device
cpu`` asks for the CPU).  The reference's ``--ckpt-dir`` default is
``/tmp/repro_ckpt``; here it is ``repro_torch_ckpt`` under the process's
temporary directory (``$TMPDIR``).  A directory that already holds a
checkpoint is resumed from its latest step, as in the reference.

Example (reduced config, CPU):
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --smoke --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt \\
        --device cpu
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--ckpt-shards", type=int, default=1)
    ap.add_argument("--async-ckpt", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step (FT drill)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else \
        get_config(args.arch)
    ocfg = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                       total_steps=args.steps)
    tcfg = TrainerConfig(ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every,
                         n_ckpt_shards=args.ckpt_shards,
                         async_ckpt=args.async_ckpt)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)
    tr = Trainer(cfg, ocfg, tcfg, dcfg, device=args.device)

    t0 = time.time()
    toks = args.batch * args.seq

    def log(step, m):
        if step % 10 == 0 or step == args.steps - 1:
            dt = time.time() - t0
            print(f"step {step:5d} loss {float(m['loss']):.4f} "
                  f"lr {float(m['lr']):.2e} gnorm "
                  f"{float(m['grad_norm']):.2f} "
                  f"({toks * (step + 1) / max(dt, 1e-9):.0f} tok/s)",
                  flush=True)

    failures = (args.fail_at,) if args.fail_at is not None else ()
    params, _, metrics = tr.run_resilient(args.steps, failures=failures,
                                          on_step=log)
    print(f"final loss {float(metrics['loss']):.4f} "
          f"wall {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
