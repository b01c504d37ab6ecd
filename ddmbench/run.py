"""Run one cell of the benchmark of ``repro_torch`` on the card.

    python3 ddmbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's configuration, traffic mix and
metrics come from ``BENCHMARK.json`` (see ``ddmbench/layout.py``).
``--trace 0`` measures the window with tracing off and reports the
cell's end-to-end metrics; ``--trace 1`` traces the first
``trace_seconds`` of the window under ``torch.profiler`` and reports its
per-layer metrics, the device's busy seconds and a breakdown.  Either
way the answers are judged against the plain reference after the window.

Standard output: information lines, then one JSON line with ``correct``,
``attempted`` (ticks run in the window), ``failed`` (checked ticks whose
answer differed from the reference), ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared,
with its limit.  The same numbers are the last lines of standard error.

Exit codes: 0 with a result; 2 without a CUDA card, or with fewer cards
than the cell asks for; 3 when JAX or the JAX package was loaded.
Caches of what the program builds go under ``build/`` in the checkout.
"""
import time

T0 = time.perf_counter()   # set-up starts here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "ddmbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _fixed_caches() -> None:
    """Point every build and kernel cache of torch into the checkout, at
    fixed paths, before torch loads.  The port's own kernels build into
    ``build/repro_torch/`` (``repro_torch.kernels._build``)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _power_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"card name and power limit: not read ({e})"
    return f"card name and power limit: {out.stdout.strip()!r}"


def _metrics(entries, win) -> dict:
    from ddmbench.layout import load_plugin
    out = {}
    for e in entries:
        value = load_plugin("metrics", e["name"]).read(win)
        if value is None:
            win.note(f"{e['name']}: left out of the result line")
        else:
            out[e["name"]] = {"value": value, "unit": e["unit"]}
    return out


def measure(cell, seed: int, seconds: float, trace: bool, device,
            t0: float = T0) -> tuple[dict, list[str]]:
    """One run of ``cell``: ``(result line, information lines)``."""
    import torch

    from ddmbench import session

    win, checks, attempted, failed, info = session.run(
        cell, seed, seconds, trace, device, t0)
    if trace:
        metrics = _metrics(cell.per_layer, win)
    else:
        metrics = _metrics(cell.end_to_end, win)
        info.append(f"ticks in the window: {len(win.tick_s)} in "
                    f"{win.window_s!r} s")
    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": cell.chips, "memory_peak_bytes": win.peak_bytes}
    else:
        dev = {"platform": device.type, "kind": device.type, "count": 0,
               "memory_peak_bytes": 0}
    result = {"correct": (all(v <= lim for v, lim in checks.values())
                          and failed == 0),
              "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": dev}
    if trace and win.trace is not None:
        dev["busy_s"] = win.trace.busy_ns / 1e9
        dev["window_s"] = win.trace.window_ns / 1e9
        info.append(f"traced ticks in the trace's window: {win.trace.ticks}")
        result["breakdown"] = win.trace.breakdown
    elif trace:
        win.note("the trace holds no tick")
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result, info + win.notes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _fixed_caches()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from ddmbench.layout import load_cell
    cell = load_cell(args.workload, ROOT)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, info = measure(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0))
    info.append(_power_line())
    bad = forbidden_modules()
    if bad:
        print(f"loaded after the window: {bad} (JAX or the JAX package); "
              "no result", file=sys.stderr)
        return 3
    for line in info:
        print(line)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
