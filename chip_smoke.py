#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's SBM main path on one NVIDIA card and check it.

Run from the repository root on a host with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

It imports only ``torch`` and the port (``src/repro_torch``), never JAX
or the JAX package.  Phases, each of which must pass:

1. device   the card's name and power limit (``nvidia-smi``);
2. build    every kernel of the path compiled from ``src/repro_torch/csrc``;
3. K1       the sweep kernel against its plain version on the paper's
            fig. 9 workload (N = 1e6, alpha = 100), bit for bit, and the
            sweep's K against the binary-search per-subscription counts;
4. koln     ``count()`` on the Cologne-like workload, whose K passes 2^31;
5. main     the main path, ``build_plan(MatchSpec(algo="sbm"))`` with
            ``count()`` and ``pairs()`` at fig. 9 size, with the kernels'
            launch counters zeroed just before and read just after; the
            K2 buffer equals the plain pass 2 on the card, every pair
            overlaps, no pair repeats, and per-subscription pair counts
            equal the binary-search counts;
6. trunc    a fixed 2^22-slot buffer keeps the exact K and equals the
            first 2^22 rows of the main path's buffer;
7. d=2      the 2-D fig. 9 workload through ``backend="cuda"`` equals
            ``backend="torch"`` on the card;
8. times    median of CUDA-event times over warm runs, for ``count()``
            and ``pairs()`` end to end, each kernel alone and each plain
            version, beside the card's name and power limit.

Then one JSON line with a record per kernel, and as the last line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before
that line; so does a host without a CUDA device.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

FIG9 = dict(seed=42, n_total=1_000_000, alpha=100.0)
FIG9_K = 49_996_544           # the paper's fig. 9 setting, exact K
KOLN_K = 3_678_811_212        # koln_like_workload(0), past 2^31
TRUNC = 1 << 22
REPS = 5
# H100 SXM published peaks (NVIDIA datasheet): HBM bytes/s, and
# the 32-bit rate outside the tensor cores, used for the integer work here
HBM_BYTES_PER_S = 3.35e12
OPS32_PER_S = 67e12


class SmokeError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = REPS) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time for the work: max of bytes over HBM rate and operations
    over the 32-bit rate, in ms, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def run(dev: str, fig9: dict, koln_positions: int, trunc: int,
        expect_k: dict | None) -> dict:
    """Phases 3-8 on ``dev``; returns launches, kernel and end-to-end data.

    ``expect_k`` holds the known K of the full-size workloads (None when
    the sizes are cut, as in a CPU rehearsal).
    """
    import torch
    from repro_torch.core import (MatchSpec, build_plan, koln_like_workload,
                                  paper_workload, sbm)
    from repro_torch.kernels import emit, ref
    from repro_torch.kernels import sbm_sweep as sweep

    # -- 3. K1 against its plain version on the fig. 9 stream -------------
    S, U = paper_workload(**fig9, device=dev)
    n, m = S.n, U.n
    per_sub = sbm.sbm_count_per_sub(S, U)
    k_bin = int(per_sub.sum(dtype=torch.int64))
    if expect_k is not None:
        check(k_bin == expect_k["fig9"],
              f"fig9 binary-search K {k_bin} != {expect_k['fig9']}")
    is_lo, is_upd = sbm._endpoint_stream(S.lo[:, 0], S.hi[:, 0],
                                         U.lo[:, 0], U.hi[:, 0])
    c_kernel = sweep.sbm_sweep(is_lo, is_upd)
    c_plain = ref.sbm_sweep(is_lo, is_upd)
    k1_err = int((c_kernel.long() - c_plain.long()).abs().max())
    check(torch.equal(c_kernel, c_plain), f"K1 != plain (max err {k1_err})")
    k_sweep = int(c_kernel.sum(dtype=torch.int64))
    check(k_sweep == k_bin, f"K1 sweep K {k_sweep} != binary K {k_bin}")
    print(f"[K1] fig9 endpoints={is_lo.numel()} K={k_sweep} bit-equal to "
        "plain")

    # -- 4. Koln count past 2^31 -------------------------------------------
    SK, UK = koln_like_workload(0, n_positions=koln_positions, device=dev)
    before = sweep.sbm_sweep.launches
    plan_k = build_plan(MatchSpec(algo="sbm", device=dev), SK.n, UK.n, 1)
    k_koln = plan_k.count(SK, UK)
    k_koln_bin = int(sbm.sbm_count_per_sub(SK, UK).sum(dtype=torch.int64))
    check(k_koln == k_koln_bin, f"koln K {k_koln} != binary K {k_koln_bin}")
    if expect_k is not None:
        check(k_koln == expect_k["koln"],
              f"koln K {k_koln} != {expect_k['koln']}")
    koln_launches = sweep.sbm_sweep.launches - before
    print(f"[koln] N={SK.n + UK.n} K={k_koln} K1 launches={koln_launches}")
    del SK, UK, plan_k

    # -- 5. the main path, launch counters zeroed just before ---------------
    sweep.sbm_sweep.launches = 0
    emit.twopass_emit.launches = 0
    plan = build_plan(MatchSpec(algo="sbm", device=dev), n, m, 1)
    k_count = plan.count(S, U)
    res, k_pairs = plan.pairs(S, U)
    if dev == "cuda":
        torch.cuda.synchronize()
    launches = {"sbm_sweep": sweep.sbm_sweep.launches,
                "twopass_emit": emit.twopass_emit.launches}
    check(k_count == k_bin and k_pairs == k_bin,
          f"main path K count={k_count} pairs={k_pairs} != {k_bin}")
    buf = res.data
    check(tuple(buf.shape) == (k_bin, 2), f"pairs shape {tuple(buf.shape)}")
    print(f"[main] count()={k_count} pairs() K={k_pairs} launches={launches}")

    tables = sbm._twopass_phase1(S.lo[:, 0], S.hi[:, 0], U.lo[:, 0],
                                 U.hi[:, 0], k_bin)
    perm_s, perm_u, starts, counts, offs = tables[:5]
    emit_args = (offs, counts, starts, perm_s, perm_u)
    plain_buf = ref.twopass_emit(*emit_args, max_pairs=k_bin)
    k2_err = int((buf.long() - plain_buf.long()).abs().max())
    check(torch.equal(buf, plain_buf), f"K2 != plain (max err {k2_err})")
    del plain_buf
    s_idx, u_idx = buf[:, 0].long(), buf[:, 1].long()
    check(bool((s_idx >= 0).all() and (u_idx >= 0).all()),
          "pad rows inside an exact buffer")
    overlap = ((S.lo[s_idx, 0] < U.hi[u_idx, 0])
               & (U.lo[u_idx, 0] < S.hi[s_idx, 0]))
    check(bool(overlap.all()), f"{int((~overlap).sum())} pairs do not overlap")
    keys = torch.sort(s_idx * m + u_idx).values
    check(bool((keys[1:] > keys[:-1]).all()), "duplicate pairs")
    check(torch.equal(torch.bincount(s_idx, minlength=n),
                      per_sub.long()),
          "per-subscription pair counts != binary-search counts")
    del overlap, keys, u_idx
    print("[main] K2 bit-equal to plain pass 2; pairs overlap, unique, "
        "per-sub counts match")

    # -- 6. truncation ------------------------------------------------------
    plan_f = build_plan(MatchSpec(algo="sbm", capacity="fixed",
                                  max_pairs=trunc, device=dev), n, m, 1)
    res_f, k_f = plan_f.pairs(S, U)
    check(k_f == k_bin, f"truncated K {k_f} != {k_bin}")
    check(torch.equal(res_f.data, buf[:trunc]),
          "truncated buffer != prefix of the exact buffer")
    print(f"[trunc] max_pairs={trunc} K={k_f} buffer = exact prefix")
    del res_f, s_idx

    # -- 7. d = 2, cuda backend against torch backend -----------------------
    S2, U2 = paper_workload(**fig9, d=2, device=dev)
    out2 = {}
    for backend in ("cuda", "torch"):
        p2 = build_plan(MatchSpec(algo="sbm", backend=backend, device=dev),
                        S2.n, U2.n, 2)
        r2, k2 = p2.pairs(S2, U2)
        out2[backend] = (p2.count(S2, U2), k2, r2.data)
    (kc_c, kp_c, b_c), (kc_t, kp_t, b_t) = out2["cuda"], out2["torch"]
    check(kc_c == kc_t == kp_c == kp_t,
          f"d=2 K cuda=({kc_c},{kp_c}) torch=({kc_t},{kp_t})")
    check(torch.equal(b_c, b_t), "d=2 buffers differ between backends")
    print(f"[d=2] K={kp_c} cuda == torch")
    del S2, U2, out2, b_c, b_t

    # -- 8. times -----------------------------------------------------------
    times = {
        "count_e2e": time_ms(lambda: plan.count(S, U)),
        "pairs_e2e": time_ms(lambda: plan.pairs(S, U)),
        "k1": time_ms(lambda: sweep.sbm_sweep(is_lo, is_upd)),
        "k1_plain": time_ms(lambda: ref.sbm_sweep(is_lo, is_upd)),
        "k2": time_ms(lambda: emit.twopass_emit(*emit_args,
                                                max_pairs=k_bin)),
        "k2_plain": time_ms(lambda: ref.twopass_emit(*emit_args,
                                                     max_pairs=k_bin)),
    }

    T = is_lo.numel()
    E = n + m
    # K1: two int32 flags in, one int32 count out per endpoint; about a
    # dozen integer operations each (deltas, scan, report expression)
    k1_bound = bound_ms(12 * T, 12 * T)
    # K2: every table read once, 8 B written per slot; per slot a binary
    # search of ceil(log2(E+1)) steps at ~6 operations, plus ~12 more
    steps = math.ceil(math.log2(E + 1))
    k2_bytes = 4 * ((E + 1) + 2 * E + n + m) + 8 * k_bin
    k2_bound = bound_ms(k2_bytes, (6 * steps + 12) * k_bin)
    kernels = [
        {"name": "sbm_sweep", "route": "cuda",
         "source": "src/repro_torch/csrc/sbm_sweep.cu",
         "replaces": "src/repro/kernels/sbm_sweep.py:28",
         "launches": launches["sbm_sweep"], "max_abs_err": k1_err,
         "ms": times["k1"], "plain_ms": times["k1_plain"],
         "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
         "library_ms": None, "match": True},
        {"name": "twopass_emit", "route": "cuda",
         "source": "src/repro_torch/csrc/emit.cu",
         "replaces": "src/repro/kernels/emit.py:185",
         "launches": launches["twopass_emit"], "max_abs_err": k2_err,
         "ms": times["k2"], "plain_ms": times["k2_plain"],
         "bound_ms": k2_bound[0], "bound_by": k2_bound[1],
         "library_ms": None, "match": True},
    ]
    return {"launches": launches, "kernels": kernels, "times": times,
            "koln_launches": koln_launches,
            "shapes": {"endpoints": T, "emitters": E, "K": k_bin}}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    # -- 1. device ----------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi()
    name = torch.cuda.get_device_name(0)
    print(card)    # name, power limit: as nvidia-smi prints them
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.3f} s")

    out = run("cuda", FIG9, 541_222, TRUNC,
              {"fig9": FIG9_K, "koln": KOLN_K})
    for kname, count in out["launches"].items():
        check(count > 0, f"kernel {kname} was not launched on the main path")
    check(out["koln_launches"] > 0, "Koln count() did not launch K1")

    sh = out["shapes"]
    for key, ms in out["times"].items():
        print(f"[time] {key}: {ms!r} ms (median of {REPS}; endpoints="
              f"{sh['endpoints']} emitters={sh['emitters']} K={sh['K']}) "
              f"on {card}")
    print(json.dumps({"kernels": out["kernels"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 — any failed phase fails the smoke
        traceback.print_exc()
        sys.exit(1)
