"""End-to-end example of the PyTorch port: train a small LM with the full
stack — model library + optimizer + deterministic data pipeline +
fault-tolerant runtime with an injected failure + checkpoint restart.

The twin of ``examples/train_tiny_lm.py`` on ``repro_torch`` (no JAX):

    PYTHONPATH=src python examples/train_tiny_lm_torch.py --device cpu \\
        [--steps 60] [--fail-at 30]

``--device`` defaults to ``cuda``.  Uses a ~1.5M-param llama-family
config by default; pass --d-model/--layers to scale up, or --arch to
train a ``repro_torch.configs`` smoke arch.  Checkpoints go to --ckpt
(default: a new temporary directory, removed at the end).
"""
import argparse
import shutil
import tempfile
import time

from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="use a repro_torch.configs smoke arch instead")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.arch:
        cfg = get_smoke_config(args.arch)
    else:
        cfg = ModelConfig(
            name="tiny-llama", family="dense", n_layers=args.layers,
            d_model=args.d_model, n_heads=4, n_kv_heads=2,
            d_head=args.d_model // 4, d_ff=args.d_model * 3,
            vocab=2048, remat=False)
    print(f"training {cfg.name}: ~{cfg.n_params() / 1e6:.1f}M params "
          f"on {args.device}")

    ckpt = args.ckpt or tempfile.mkdtemp(prefix="train_tiny_torch_")
    tr = Trainer(
        cfg,
        AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=args.steps),
        TrainerConfig(ckpt_dir=ckpt, ckpt_every=20, async_ckpt=True),
        DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                   global_batch=args.batch),
        device=args.device)

    t0 = time.time()
    hist = []

    def log(step, m):
        hist.append(float(m["loss"]))
        if step % 10 == 0:
            print(f"step {step:4d} loss {hist[-1]:.4f} "
                  f"({args.batch * args.seq * (step + 1) / (time.time() - t0):,.0f} tok/s)",
                  flush=True)

    failures = (args.fail_at,) if args.fail_at is not None else ()
    try:
        tr.run_resilient(args.steps, failures=failures, on_step=log)
    finally:
        if args.ckpt is None:
            shutil.rmtree(ckpt, ignore_errors=True)
    print(f"\nloss {hist[0]:.3f} -> {hist[-1]:.3f} over {args.steps} "
          f"steps, wall {time.time() - t0:.1f}s"
          + (" (survived injected failure + restart)" if failures else ""))
    if not hist[-1] < hist[0]:
        raise SystemExit("loss must decrease")


if __name__ == "__main__":
    main()
