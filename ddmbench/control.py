"""The control of the benchmark's correctness check.

The plain reference, computed in bfloat16 (the next precision below the
float32 the configurations state), is put in the program's place:
``MatchPlan.count`` returns its K of the tick's moved regions, and
``MatchPlan.pairs`` returns that K with an empty pair buffer (the
bfloat16 pair set of a 1e7-region cell would hold ~1e11 pairs, so only
its K is read).  Then whole runs of the cell go through ``run.measure``,
the same set-up, window, judging and limits as the benchmark's runs, and
each has to come out not correct.  The benchmark's own runs do not run
it.

    python3 ddmbench/control.py --workload <cell> --seeds 11 12 13 [--seconds 10]

prints each seed's ``correct`` and the numbers compared beside their
limits, then a JSON summary; exit code 0 when every seed came out not
correct, 1 otherwise, 2 without a CUDA card.
"""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


class _NoBuffer:
    """The control's pair result: K alone, no slot of the buffer."""

    cap = 0

    def decode(self, start, stop):
        raise AssertionError("the control's pair buffer has no slot")


@contextlib.contextmanager
def in_place_of_the_program():
    """``MatchPlan.count`` and ``MatchPlan.pairs`` answer with the
    bfloat16 reference while the block runs."""
    from ddmbench import reference
    from repro_torch.core.engine import MatchPlan

    def count(self, S, U):
        return reference.count_overlaps(S.lo, S.hi, U.lo, U.hi, "bfloat16")

    def pairs(self, S, U):
        return _NoBuffer(), count(self, S, U)

    saved = MatchPlan.count, MatchPlan.pairs
    MatchPlan.count, MatchPlan.pairs = count, pairs
    try:
        yield
    finally:
        MatchPlan.count, MatchPlan.pairs = saved


def control_run(cell, seed: int, seconds: float, device) -> dict:
    """One untraced run of ``cell`` with the control in the program's
    place: the result line ``run.measure`` gives."""
    from ddmbench import run
    with in_place_of_the_program():
        result, _ = run.measure(cell, seed, seconds, False, device,
                                time.perf_counter())
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from ddmbench.layout import load_cell

    cell = load_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("the control runs at the cell's size on a CUDA card",
              file=sys.stderr)
        return 2
    readings = {}
    for seed in args.seeds:
        res = control_run(cell, seed, args.seconds, torch.device("cuda", 0))
        readings[seed] = {"correct": res["correct"], "failed": res["failed"],
                          "attempted": res["attempted"],
                          "checks": res["checks"]}
        print(f"{cell.name} seed {seed}: correct {res['correct']}, failed "
              f"{res['failed']} of the checked ticks; "
              + ", ".join(f"{k} {c['value']} limit {c['limit']}"
                          for k, c in res["checks"].items()), flush=True)
    ok = not any(r["correct"] for r in readings.values())
    print(json.dumps({"workload": cell.name, "control": readings,
                      "every_seed_not_correct": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
