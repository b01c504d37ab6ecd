#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's matching paths on one NVIDIA card and check them.

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
            version, beside the card's name and power limit;
9. bfm      ``count()`` of ``MatchSpec(algo="bfm")`` through K3 on fig. 9
            (K equal to the SBM count and to the plain per-subscription
            counts; the K3 tiles bit-equal to their plain version), on
            Koln (the int64 K past 2^31) and on fig. 9 at d = 2, and
            ``algo="gbm"``'s grid count on fig. 9;
10. mask    ``mask()`` and exact ``pairs()`` of the bfm plan at N = 8e4
            (n*m = 1.6e9): K4's mask bit-equal to the plain mask, the
            pairs bit-equal to the plain ``bfm_pairs`` and set-equal to
            SBM's pairs;
11. routes  fig. 9 through ``emit_route="streaming"`` (K5) and ``"csr"``
            (the lazy view, windows decoded by K6): the K5 buffer and
            every csr window equal the resident (K2) buffer, and K5
            equals its plain version on the same packed table;
12. koln-csr  Koln through ``csr`` at a fixed cap of INT32_MAX: K exact,
            and K6 windows at slot 0, above slot 2^30 and at the top
            equal the plain decode and a lookup over the uncompacted
            pass-1 tables;
13. times   K3, K4, K5 and K6 alone and their plain versions.

Every path runs with the launch counters of its kernels zeroed just
before and read just after; each kernel must have launched.  Then one
JSON line with a record per kernel, and as the last line
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
FIG9_D2_K = 10_100            # the fig. 9 setting at d = 2
KOLN_K = 3_678_811_212        # koln_like_workload(0), past 2^31
MASK = dict(seed=42, n_total=80_000, alpha=100.0)   # n*m = 1.6e9
TRUNC = 1 << 22
WINDOW = 1 << 22              # csr windows() chunk at fig. 9
KOLN_WINDOW = 1 << 20         # each K6 window on Koln
INT32_MAX = 2 ** 31 - 1
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


def exact_err(a, b) -> int:
    """Largest absolute difference of two integer or bool tensors."""
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max())


def run_slice2(dev: str, fig9: dict, mask_wl: dict, koln_positions: int,
               window: int, koln_window: int, expect_k: dict | None) -> dict:
    """Phases 9-13 on ``dev``: BFM/GBM, mask, and the streaming and CSR
    routes.  Returns launches, kernel records and times."""
    import torch
    from repro_torch.core import (MatchSpec, brute, build_plan,
                                  koln_like_workload, paper_workload, sbm)
    from repro_torch.kernels import bfm, emit, ops, ref

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    # -- 9. BFM count through K3 --------------------------------------------
    S, U = paper_workload(**fig9, device=dev)
    n, m = S.n, U.n
    k_sbm = sbm.sbm_count_binary(S, U)
    SK, UK = koln_like_workload(0, n_positions=koln_positions, device=dev)
    S2, U2 = paper_workload(**fig9, d=2, device=dev)
    k_d2_sbm = build_plan(MatchSpec(algo="sbm", device=dev), S2.n, U2.n,
                          2).count(S2, U2)
    bfm.bfm_tile_counts.launches = 0
    k_bfm = build_plan(MatchSpec(algo="bfm", device=dev), n, m, 1).count(
        S, U)
    k_koln = build_plan(MatchSpec(algo="bfm", device=dev), SK.n, UK.n,
                        1).count(SK, UK)
    k_d2 = build_plan(MatchSpec(algo="bfm", device=dev), S2.n, U2.n,
                      2).count(S2, U2)
    sync()
    k3_launches = bfm.bfm_tile_counts.launches
    check(k_bfm == k_sbm, f"bfm K {k_bfm} != sbm K {k_sbm}")
    k_plain = brute.bfm_count(S, U)
    check(k_bfm == k_plain, f"bfm K {k_bfm} != plain bfm_count {k_plain}")
    k_koln_sbm = sbm.sbm_count_binary(SK, UK)
    check(k_koln == k_koln_sbm, f"koln bfm K {k_koln} != sbm {k_koln_sbm}")
    check(k_d2 == k_d2_sbm, f"d=2 bfm K {k_d2} != sbm {k_d2_sbm}")
    if expect_k is not None:
        check(k_bfm == expect_k["fig9"], f"bfm K {k_bfm}")
        check(k_koln == expect_k["koln"], f"koln bfm K {k_koln}")
        check(k_d2 == expect_k["fig9_d2"], f"d=2 bfm K {k_d2}")
    k_gbm = build_plan(MatchSpec(algo="gbm", device=dev), n, m, 1).count(
        S, U)
    check(k_gbm == k_sbm, f"gbm K {k_gbm} != sbm K {k_sbm}")
    ts = tu = MatchSpec().ts
    s_lo, s_hi = ops._pad_regions(S.lo, S.hi, ts)
    u_lo, u_hi = ops._pad_regions(U.lo, U.hi, tu)
    tiles_args = (s_lo, s_hi, u_lo, u_hi)
    tiles = bfm.bfm_tile_counts(*tiles_args, ts=ts, tu=tu)
    tiles_plain = ref.bfm_tile_counts(*tiles_args, ts, tu)
    k3_err = exact_err(tiles, tiles_plain)
    check(k3_err == 0, f"K3 != plain (max err {k3_err})")
    del tiles, tiles_plain
    print(f"[bfm] fig9 K={k_bfm} (sbm {k_sbm}, plain {k_plain}, gbm "
          f"{k_gbm}); koln K={k_koln}; d=2 K={k_d2}; K3 tiles bit-equal "
          f"to plain; K3 launches={k3_launches}")
    del SK, UK, S2, U2

    # -- 10. mask() and bfm pairs() through K4 -----------------------------
    SM, UM = paper_workload(**mask_wl, device=dev)
    bfm.bfm_mask.launches = 0
    plan_m = build_plan(MatchSpec(algo="bfm", device=dev), SM.n, UM.n, 1)
    mask = plan_m.mask(SM, UM)
    res_m, k_m = plan_m.pairs(SM, UM)
    sync()
    k4_launches = bfm.bfm_mask.launches
    mask_plain = ref.bfm_mask(SM.lo, SM.hi, UM.lo, UM.hi)
    k4_err = exact_err(mask, mask_plain)
    check(k4_err == 0, f"K4 != plain mask (max err {k4_err})")
    check(int(mask.sum()) == k_m, "mask popcount != pairs() K")
    del mask_plain
    pairs_plain, k_mp = brute.bfm_pairs(SM, UM, k_m)
    check(k_mp == k_m and torch.equal(res_m.data, pairs_plain),
          "bfm pairs() != plain bfm_pairs")
    del pairs_plain
    res_s, k_s = build_plan(MatchSpec(algo="sbm", device=dev), SM.n, UM.n,
                            1).pairs(SM, UM)
    check(k_s == k_m, f"bfm pairs K {k_m} != sbm K {k_s}")
    keys_b = res_m.data[:, 0].long() * UM.n + res_m.data[:, 1].long()
    keys_s = torch.sort(res_s.data[:, 0].long() * UM.n
                        + res_s.data[:, 1].long()).values
    check(torch.equal(keys_b, keys_s), "bfm pairs != sbm pairs as sets")
    del keys_b, keys_s, res_s
    print(f"[mask] n={SM.n} m={UM.n} K={k_m}: K4 mask bit-equal to plain; "
          f"bfm pairs bit-equal to plain, set-equal to sbm; K4 launches="
          f"{k4_launches}")

    # -- 11. streaming and csr routes at fig. 9 ----------------------------
    dense, k_r = build_plan(MatchSpec(emit_route="resident", device=dev),
                            n, m, 1).pairs(S, U)
    dense = dense.data
    emit.twopass_emit_streaming.launches = 0
    res_st, k_st = build_plan(MatchSpec(emit_route="streaming", device=dev),
                              n, m, 1).pairs(S, U)
    sync()
    k5_launches = emit.twopass_emit_streaming.launches
    check(ops.last_emit_route() == "streaming", "streaming route not taken")
    check(k_st == k_r and torch.equal(res_st.data, dense),
          "streaming buffer != resident buffer")
    del res_st
    emit.csr_decode_window.launches = 0
    view, k_c = build_plan(MatchSpec(emit_route="csr", device=dev), n, m,
                           1).pairs(S, U)
    check(isinstance(view, ops.CSRPairs) and k_c == k_r, "csr view / K")
    dense_h = dense.cpu().numpy()
    nwin = 0
    for w0, win in view.windows(chunk=window):
        check((win == dense_h[w0:w0 + win.shape[0]]).all(),
              f"csr window at {w0} != resident buffer")
        nwin += 1
    del dense_h
    sync()
    k6_fig9_launches = emit.csr_decode_window.launches
    print(f"[routes] fig9 K={k_r}: streaming (K5) buffer == resident (K2); "
          f"{nwin} csr windows of {window} == resident; csr nbytes="
          f"{view.nbytes} dense_nbytes={view.dense_nbytes}; K5 launches="
          f"{k5_launches}, K6 launches={k6_fig9_launches}")
    perm_s, perm_u, starts, counts, offs = sbm._twopass_phase1(
        S.lo[:, 0], S.hi[:, 0], U.lo[:, 0], U.hi[:, 0], k_r)[:5]
    bl = emit.lane_pad(MatchSpec().block)
    tab = emit.pack_emitter_tables(offs, counts, starts, n=n, m=m,
                                   min_len=emit.stream_window(bl))
    k5_args = (tab, perm_s, perm_u)
    k5_out = emit.twopass_emit_streaming(*k5_args, max_pairs=k_r, block=bl)
    k5_plain = ref.twopass_emit_streaming(*k5_args, max_pairs=k_r)
    k5_err = exact_err(k5_out, k5_plain)
    check(k5_err == 0, f"K5 != plain (max err {k5_err})")
    del k5_out, k5_plain
    w_mid = max(k_r // 2 - window // 2, 0)
    w_n = min(window, k_r - w_mid)
    k6_args = (view.tab, view.perm_s, view.perm_u, w_mid, w_n)
    k6_err = exact_err(emit.csr_decode_window(*k6_args),
                       ref.csr_decode_window(*k6_args))
    check(k6_err == 0, f"K6 != plain (max err {k6_err})")

    # -- 12. Koln through csr at cap INT32_MAX -----------------------------
    SK, UK = koln_like_workload(0, n_positions=koln_positions, device=dev)
    emit.csr_decode_window.launches = 0
    plan_kc = build_plan(MatchSpec(emit_route="csr", capacity="fixed",
                                   max_pairs=INT32_MAX, device=dev),
                         SK.n, UK.n, 1)
    kview, kk = plan_kc.pairs(SK, UK)
    check(kk == k_koln and kview.count == k_koln,
          f"koln csr K {kk} != {k_koln}")
    kt = sbm._twopass_phase1(SK.lo[:, 0], SK.hi[:, 0], UK.lo[:, 0],
                             UK.hi[:, 0], INT32_MAX)
    k_perm_s, k_perm_u, k_starts, k_counts, k_offs = kt[:5]
    del kt
    koln_windows = (0, (1 << 30) + 12_345, INT32_MAX - koln_window)
    for w0 in koln_windows:
        got = kview.decode(w0, w0 + koln_window)
        plain = ref.csr_decode_window(kview.tab, kview.perm_s, kview.perm_u,
                                      w0, koln_window)
        lookup = sbm._twopass_window(k_offs, k_counts, k_starts, k_perm_s,
                                     k_perm_u, w0, w0 + koln_window)
        check(torch.equal(got, plain), f"koln K6 window at {w0} != plain")
        check(torch.equal(got, lookup),
              f"koln K6 window at {w0} != uncompacted lookup")
        if expect_k is not None:
            check(bool((got >= 0).all()), f"pad rows below K at {w0}")
    sync()
    k6_launches = k6_fig9_launches + emit.csr_decode_window.launches
    print(f"[koln-csr] N={SK.n + UK.n} cap={INT32_MAX} K={kk}; K6 windows "
          f"of {koln_window} at {list(koln_windows)} == plain == "
          f"uncompacted lookup; csr nbytes={kview.nbytes}")
    del kview, k_perm_s, k_perm_u, k_starts, k_counts, k_offs, SK, UK

    # -- 13. times ----------------------------------------------------------
    mask_args = (SM.lo, SM.hi, UM.lo, UM.hi)
    times = {
        "k3": time_ms(lambda: bfm.bfm_tile_counts(*tiles_args, ts=ts,
                                                  tu=tu)),
        "k3_plain": time_ms(lambda: ref.bfm_tile_counts(*tiles_args, ts,
                                                        tu)),
        "k4": time_ms(lambda: bfm.bfm_mask(*mask_args)),
        "k4_plain": time_ms(lambda: ref.bfm_mask(*mask_args)),
        "k5": time_ms(lambda: emit.twopass_emit_streaming(
            *k5_args, max_pairs=k_r, block=bl)),
        "k5_plain": time_ms(lambda: ref.twopass_emit_streaming(
            *k5_args, max_pairs=k_r)),
        "k6": time_ms(lambda: emit.csr_decode_window(*k6_args)),
        "k6_plain": time_ms(lambda: ref.csr_decode_window(*k6_args)),
        "bfm_count_e2e": time_ms(lambda: build_plan(
            MatchSpec(algo="bfm", device=dev), n, m, 1).count(S, U)),
    }
    nm, nm_mask = n * m, SM.n * UM.n
    E, e_pad = n + m, tab.shape[1]
    # K3: the padded bounds in (8 B per region at d = 1), one int32 per
    # tile out; two float32 compares per pair
    n_pad, m_pad = tiles_args[0].shape[0], tiles_args[2].shape[0]
    k3_bound = bound_ms(8 * (n_pad + m_pad) + 4 * (n_pad // ts)
                        * (m_pad // tu), 2 * nm)
    # K4: one byte per pair out, the bounds in; two compares per pair
    k4_bound = bound_ms(nm_mask + 8 * (SM.n + UM.n), 2 * nm_mask)
    win = emit.stream_window(bl)
    # K5: the packed table and the permutations in, 8 B per slot out;
    # per slot a binary search over the window plus ~12 operations
    k5_bound = bound_ms(4 * 4 * e_pad + 4 * E + 8 * k_r,
                        (6 * math.ceil(math.log2(win)) + 12) * k_r)
    # K6 reads what its window needs: one partner per slot (4 B) and
    # writes 8 B per slot; its search runs over the whole table
    k6_bound = bound_ms(12 * w_n,
                        (6 * math.ceil(math.log2(e_pad)) + 12) * w_n)

    def rec(name, src, replaces, launches, err, key, bound):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": times[key],
                "plain_ms": times[key + "_plain"], "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": None, "match": True}

    kernels = [
        rec("bfm_tile_counts", "src/repro_torch/csrc/bfm.cu",
            "src/repro/kernels/bfm.py:30", k3_launches, k3_err, "k3",
            k3_bound),
        rec("bfm_mask", "src/repro_torch/csrc/bfm.cu",
            "src/repro/kernels/bfm.py:43", k4_launches, k4_err, "k4",
            k4_bound),
        rec("twopass_emit_streaming", "src/repro_torch/csrc/emit_stream.cu",
            "src/repro/kernels/emit.py:307", k5_launches, k5_err, "k5",
            k5_bound),
        rec("csr_decode_window", "src/repro_torch/csrc/csr_decode.cu",
            "src/repro/kernels/emit.py:423", k6_launches, k6_err, "k6",
            k6_bound),
    ]
    launches = {"bfm_tile_counts": k3_launches, "bfm_mask": k4_launches,
                "twopass_emit_streaming": k5_launches,
                "csr_decode_window": k6_launches}
    return {"launches": launches, "kernels": kernels, "times": times,
            "shapes": {"fig9_pairs": nm, "mask_pairs": nm_mask, "K": k_r,
                       "k6_window": w_n}}


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

    expect = {"fig9": FIG9_K, "koln": KOLN_K, "fig9_d2": FIG9_D2_K}
    out = run("cuda", FIG9, 541_222, TRUNC, expect)
    out2 = run_slice2("cuda", FIG9, MASK, 541_222, WINDOW, KOLN_WINDOW,
                      expect)
    for kname, count in {**out["launches"], **out2["launches"]}.items():
        check(count > 0, f"kernel {kname} was not launched on its path")
    check(out["koln_launches"] > 0, "Koln count() did not launch K1")

    sh = out["shapes"]
    for key, ms in out["times"].items():
        print(f"[time] {key}: {ms!r} ms (median of {REPS}; endpoints="
              f"{sh['endpoints']} emitters={sh['emitters']} K={sh['K']}) "
              f"on {card}")
    sh2 = out2["shapes"]
    for key, ms in out2["times"].items():
        print(f"[time] {key}: {ms!r} ms (median of {REPS}; {sh2}) on {card}")
    print(json.dumps({"kernels": out["kernels"] + out2["kernels"]}))
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
