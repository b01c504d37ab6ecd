"""``python -m repro_torch.serve`` — run the self-checking serving harness.

``--smoke`` is the CI mode: a few ticks of multi-tenant churn at small
scale, every answer checked set-identical to a brute-force oracle for
the snapshot version it was served from, no kernel library load and no
new buffer capacity in steady state (``analysis.steady``), per-tenant
metrics dumped as JSON, and ``SERVE_SMOKE_OK`` printed on success
(exit 0).  It runs on the card; ``--device cpu`` runs the plain
versions.

``--threaded`` runs the same harness through the async dispatcher and
rebuild-worker threads instead of the synchronous ``pump`` drive.
Larger runs: raise ``--n/--ticks/--moves``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve")
    ap.add_argument("--smoke", action="store_true",
                    help="CI mode: small-scale churn + parity + "
                         "steady-state checks")
    ap.add_argument("--tenants", type=int, default=3)
    ap.add_argument("--n", type=int, default=2048,
                    help="regions per tenant (n_total)")
    ap.add_argument("--ticks", type=int, default=6)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--moves", type=int, default=64,
                    help="region moves per tick per tenant")
    ap.add_argument("--queries", type=int, default=48,
                    help="queries per burst per tenant")
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--threaded", action="store_true",
                    help="drive through the async worker threads")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the tenants run (cuda, or cpu for the "
                         "plain versions)")
    ap.add_argument("--no-warm-start", action="store_true",
                    help="skip building the serving kernels up front")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the metrics/stats record to PATH")
    args = ap.parse_args(argv)

    from .harness import run_churn

    t0 = time.time()
    stats = run_churn(
        tenants=args.tenants, n_total=args.n, ticks=args.ticks,
        warmup=args.warmup, moves_per_tick=args.moves,
        queries_per_tick=args.queries, max_batch=args.max_batch,
        seed=args.seed, threaded=args.threaded, device=args.device,
        warm_start=not args.no_warm_start,
        progress=lambda msg: print(f"# {msg}", flush=True))
    wall = time.time() - t0

    record = {
        "params": {k: getattr(args, k.replace("-", "_"))
                   for k in ("tenants", "n", "ticks", "warmup", "moves",
                             "queries", "threaded", "device")},
        "wall_s": round(wall, 3),
        "p50_query_us": round(stats["p50_query_s"] * 1e6, 1),
        "p99_query_us": round(stats["p99_query_s"] * 1e6, 1),
        "p99_stale_query_us": round(stats["p99_stale_query_s"] * 1e6, 1),
        "rebuild_p50_us": round(stats["rebuild_p50_s"] * 1e6, 1),
        "rebuild_p99_us": round(stats["rebuild_p99_s"] * 1e6, 1),
        "parity_checks": stats["parity_checks"],
        "metrics": stats["metrics"],
    }
    print(json.dumps(record, indent=2, sort_keys=True))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(record, fh, indent=2, sort_keys=True)
            fh.write("\n")
    if stats["parity_checks"] == 0:
        print("oracle parity never exercised", file=sys.stderr)
        return 1
    print("SERVE_SMOKE_OK" if args.smoke else "SERVE_OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
