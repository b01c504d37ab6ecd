#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's matching and LM paths on one NVIDIA card.

Run from the repository root on a host with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

``python3 chip_smoke.py --overlap-check`` runs only phases 27 and 28,
alone and beside phase 29's background dry runs (``overlap_check``).

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
            and ``pairs()`` end to end, each kernel and each plain
            version, beside the card's name and power limit; K1 and K2
            also alone (20 back-to-back raw launches over one event
            pair), K1 with L2 hot and cold and at tiles of 2048, 4096,
            8192 and 16384 endpoints (each checked bit-equal), through its
            wrapper at Koln and at the planner's T = 1,024 and 16,384,
            K2 also at fig. 12's alpha = 1 (K = 489,667, checked
            bit-equal to plain), their TB/s, K2's tile, and K1's and
            K2's registers, shared memory and spills (``cuobjdump``);
9. bfm      ``count()`` of ``MatchSpec(algo="bfm")`` through K3 on fig. 9
            (K equal to the SBM count and to the plain per-subscription
            counts; the K3 tiles bit-equal to their plain version, also
            with one subnormal bound, which takes K3's all-FSETP
            instance), on
            Koln (the int64 K past 2^31) and on fig. 9 at d = 2, and
            ``algo="gbm"``'s grid count on fig. 9;
10. mask    ``mask()`` and exact ``pairs()`` of the bfm plan at N = 8e4
            (n*m = 1.6e9): K4's mask bit-equal to the plain mask, the
            pairs bit-equal to the plain ``bfm_pairs`` and set-equal to
            SBM's pairs; K4 at d = 2 (same n, m) bit-equal to plain;
11. routes  fig. 9 through ``emit_route="streaming"`` (K5) and ``"csr"``
            (the lazy view, windows decoded by K6): the K5 buffer and
            every csr window equal the resident (K2) buffer, and K5
            equals its plain version on the same packed table;
12. koln-csr  Koln through ``csr`` at a fixed cap of INT32_MAX: K exact,
            and K6 windows at slot 0, above slot 2^30 and at the top
            equal the plain decode and a lookup over the uncompacted
            pass-1 tables;
13. times   K3, K4, K5 and K6 alone and their plain versions; K3
            also without the wrapper's host read and in its all-FSETP
            instance; K3's fig. 9 tiles take its d1 path, whose SASS
            instructions per pair (``cuobjdump`` of the built library)
            give the issue floor at fig. 9; its registers and spills;
            K4, K5 and K6 also alone (20 back-to-back raw launches over
            one event pair), K4 at d = 2, the store ceiling (``fill_``
            of the mask's bytes), K5 at tiles of 512, 1024 and 2048
            slots, K6 on a 65,536-slot window and over K5's whole
            [0, K), their TB/s, and every K4/K5/K6 instance's
            registers, shared memory and spills (``cuobjdump``);
14. planner the sparse-attention planner's ``block_windows`` at
            Zamba2-2.7B's plan (S = 32,768, 128-token blocks, window
            4096, one sink block) on the card, through K1 and K2: the
            windows equal the ``device="cpu"`` run bit for bit and the
            arithmetic hull; the same at ``long_500k``'s S = 524,288;
15. attn    K7 on the phase-14 windows at Zamba2's attention width in
            bfloat16 (B = 1, H = 32, dh = 80; this run's main path is
            planner → engine → K7), against its plain version on the
            card; then float32 at H = 4, the JAX auditor's shape (BH 8,
            S 2048, dh 128, sink 256), a ragged S and sink, and
            B·H·S·dh past 2^31 (BH 1024, window 128, the last slice
            checked);
16. times   K7 alone, its plain version, ``block_windows`` end to end
            and the one-call yardstick (SDPA with the token mask, the
            efficient backend) at the phase-15 Zamba2 shape; K7's
            achieved TFLOP/s, the tensor-core design its bf16 path ran
            (HMMA/HGMMA in its SASS) and its registers and spills.
17. host    the host time of K1's, K2's and K6's wrappers at fig. 9,
            split into the steps of their call path (median µs of 2,000
            calls each, ``host_phase``);
18. itm     the interval tree through K8 (``csrc/itm_walk.cu``, the tree
            walk, which the JAX package runs as a vmapped
            ``lax.while_loop``): at fig. 9 K8's counts and its (b, cap)
            ids bit-equal to the plain lock-step walk, through the
            regime rule and forced into each of its two regimes (a
            thread a query, a CTA a query); then the main
            path ``build_plan(MatchSpec(algo="itm"))`` with ``count()``
            and exact ``pairs()`` (launch counter zeroed just before):
            K equal to SBM's, the buffer bit-equal to the
            ``backend="torch"`` plan and, sorted, to SBM's pairs; Koln's
            ``count()`` through K8 equal to SBM's K (3,678,811,212), and
            K8's Koln counts in both regimes equal to the plain walk's;
            fig. 9 at d = 2, pairs set-equal to SBM's;
19. dynamic ``DDMService`` (itm, grow, cap 8192) at the repo's full-scale
            churn setting, 1e6 regions at alpha = 5: ``connect()``, one
            tick of 10,000 ``update_regions`` moves (drawn by the serving
            harness's move law, width up to 5e3, from a generator of
            their own), the ledger equal to a from-scratch SBM
            ``pairs()`` set, 64 snapshot boxes of width 5e3, of each
            kind, equal to ``oracle_ids``; the same at d = 2 with 1e5
            regions and three ticks (sub, upd, sub), where the last
            tick's query also runs through K8 in both regimes against
            the plain walk;
20. times   K8 (count and pairs instances) through its wrapper and alone
            in each regime, at fig. 9 and on serving's batch of 64 boxes
            on the 1e6-region setting's tree (cap 8192, both regimes
            checked against the plain walk there too), the wrapper's
            query sort, the plain walk, the bounds and the CTA regime's
            depth floor (the tree's height times the L2 hit latency of a
            pointer chase), itm ``count()``/``pairs()`` beside sbm's at
            fig. 9, ``connect()`` and the median tick (host clock), the
            registers, stack and spills of K8's four kernels
            (``cuobjdump``);
21. hsbm    the hybrid grid+SBM, ``build_plan(MatchSpec(algo="hsbm"))``,
            at fig. 9 with K2's, K5's and K6's launch counters zeroed just
            before and read just after: ``count()`` and ``pairs()`` under
            ``auto`` (resident, K2), then ``emit_route="streaming"`` (K5)
            and ``"csr"`` (K6 windows of 2^22 slots); K equal to sbm's,
            each buffer bit-equal to the ``backend="torch"`` plain pass 2
            and, sorted, to sbm's pairs; K2, K5 and K6 bit-equal to their
            plain versions on the hybrid tables; fig. 9 at d = 2
            set-equal to sbm; Koln's ``count()`` (K past 2^31), its
            hybrid tables on the resident route, and ``csr`` at cap
            INT32_MAX with windows above slot 2^30 equal to the plain
            decode and an uncompacted lookup; K2 on Koln's tables; then
            the times: hsbm ``count()``/``pairs()`` beside sbm's, the
            geometry (the copy to the host and the NumPy apart), pass 1,
            K2/K5/K6 on the hybrid tables, ``remap_slot_pairs``;
22. serve   ``repro_torch.serve.harness.run_churn`` at the repo's
            full-scale churn setting (one tenant of 1e6 regions, 10,000
            moves and 64 queries a tick, three ticks, batches of 64, cap
            8192, seed 2) on the card, every answer checked against its
            snapshot's oracle, the steady-state guard on, K8's counters
            zeroed just before; query, stale-query and rebuild latencies;
            one batch split into its steps, its K8 walks in both regimes
            against the plain walk;
23. entry   ``python -m repro_torch.serve --smoke`` (3 tenants, d = 1
            and 2), then with ``--threaded``, as subprocesses: each must
            exit 0 and print ``SERVE_SMOKE_OK``.
24. dist    the distributed backend on a NCCL process group of world
            size 1 (a ``file://`` store in a temporary directory), K1's,
            K2's and K8's launch counters zeroed just before and read just
            after: ``count()`` at fig. 9 and Koln, exact ``pairs()`` at
            fig. 9 at d = 1 and 2, ``query()`` of 64 boxes of width 5e3 on
            the 1e6-region setting's tree; K and both buffers equal to the
            ``cuda`` backend's, the query's ids and counts too; K1 on the
            rank's segment and on two carried middle thirds of fig. 9's
            sorted stream (active counts below 0; the seeded sums equal the
            full sweep's), K2 on the rank's tables and on rank 1 of 4's
            chunk table (count 0 outside it), K8 on the rank's rows (also
            forced into each regime, counts and cap-8192 ids), each
            bit-equal to its plain version; then the times, beside the
            ``cuda`` backend's.
25. audit   the port's auditor on the card, ``repro_torch.analysis.run_all
            (device="cuda")``: every engine row's plan methods under the
            dispatch capture (the cuda backend's host syncs held against
            ``torch.cuda.set_sync_debug_mode``), K1-K8 launched at the
            JAX auditor's production shapes and K8's two regimes under
            the launch capture (each launch checked before it runs:
            int32 arguments, shared memory against the card's opt-in
            limit, grid and block limits), the compiled functions'
            resources, the grow bounds and steady-state probes, the lint;
            then the seeded-defect corpus (``tests/torch_analysis_corpus``)
            with its card case, a real launch refused for its shared
            memory.  Prints the summary, an ``[audit]`` line per kernel
            function (registers, static shared, stack, local bytes, the
            largest dynamic shared memory captured against the opt-in
            limit) and the audit's wall time; any error finding or missed
            defect fails.

26. lm      the LM serving path (``repro_torch.models``,
            ``launch/lm_serve``) of Zamba2-2.7B at its published width,
            parameters from a seeded ``torch.Generator``: (a) 6 of its 54
            layers in float32, a 64-token prefill and 8 decode steps at B
            2 on the card against the CPU; (b) ``chunked_sdpa`` at the
            shared block's width (bf16, 32 heads, dh 80) over 4,496
            tokens, past window 4,096 + sink 128, against a float64
            dense softmax under the token mask, and the gather read of
            the last position against it and the masked read; (c) all
            54 layers in float32: ``forward`` over 4,496 tokens against
            a 4,480-token ``prefill`` and 16 ``decode_step``s; (d)
            ``python -m repro_torch.launch.lm_serve --arch zamba2-2.7b``
            (bf16, B 4, 48 + 32) in a fresh process; (e) bf16, timed: B
            1 with a 4,480-token prompt and B 4 with 48, 32 generated
            each: prefill ms, decode ms a token, tok/s,
            ``max_memory_allocated``, and one decode step under
            ``torch.profiler`` split into matmul, attention, ssd/conv and
            elementwise.  It launches none of K1-K8 (the JAX LM path
            reaches no ``pallas_call``).
27. lm27    the LM serving path of the MoE, MLA and audio families at
            their published widths (``LM27``): (a) DeepSeek-V2-236B at 2
            of its 60 layers (1 dense + 1 MoE: d 5120, 128 heads, MLA
            kv_lora 512 + rope 64, 160 experts top-6), Phi-3.5-MoE at 2
            of 32 and Whisper-medium at 2 + 2 over its 1,500 frames, in
            float32, a 64-token prefill and 8 decode steps at B 2 on the
            card against the CPU on the same weights, with every token
            whose experts differ between the devices printed (from
            ``MoE.route_log``); (b) on (a)'s DeepSeek-V2, MLA's absorbed
            decode against its expanded read; (c) DeepSeek-V2 at 4
            layers, float32, ``mla_absorb=False`` and ``capacity_factor``
            raised to 160 (no token drops, checked): ``forward`` over
            1,040 tokens against a 1,024-token prefill and 16 steps; (d)
            ``python -m repro_torch.launch.lm_serve`` for
            ``whisper-medium`` and, with ``--smoke``, the two MoE configs
            in fresh processes; (e) bf16, timed as 26 (e): DeepSeek-V2 at
            4 layers (B 1 × 1,024 and B 4 × 48, with each MoE layer's
            share of (token, slot) assignments dropped by capacity in the
            prefill), Phi-3.5-MoE at 8 layers and Whisper-medium in full
            (B 4 × 48).  It launches none of K1-K8.
28. train   the LM training path (``repro_torch.optim``,
            ``launch/steps``, ``checkpoint/sharded``,
            ``runtime/trainer``, ``launch/train``) of Zamba2-2.7B at its
            published width (``TRAIN``): (a) all 54 layers and the shared
            block (2.42e9 parameters; float32 masters, AdamW's m and v)
            through ``Trainer.run`` at ``train_4k``'s S 4,096, B 2 (the
            global batch of 256 cut to one card), a warm step and three
            timed steps, the run ended by a failure injected after them
            so that it writes no 29 GB checkpoint: seconds a step,
            tokens/s, loss, grad_norm, lr, ``max_memory_allocated``;
            (b) ``make_train_step`` with the config's ``grad_accum`` 4
            at B 4 (microbatches of 1), then at B 2 the step's forward
            and backward and its AdamW update timed apart and one step
            under ``torch.profiler`` (kernels, device busy share);
            (c) one group (6 Mamba2 layers and the shared block) in
            float32, B 1 × S 256: one ``make_train_step`` on the card
            against the CPU from the same parameters (loss, grad_norm,
            each tensor's update); (d) on that model in bf16, B 1 × S
            512, the restart drill: 4 steps with 2-shard checkpoints
            every 2, a failure injected at step 3, ``run_resilient``'s
            params, m, v and step bit for bit the uninterrupted run's;
            (e) that checkpoint restored at 3 shards with K2's counter
            zeroed: the tree bit for bit the saved one, K2 launched once
            a leaf, every leaf's ``_reshard_plan`` equal to the plain
            pass 2's (``device="cpu"``); (f) one shared-attention
            call alone at (a)'s width, bf16, B 2 × S 4,096 (32 heads,
            dh 80, window 4,096, sink 128): forward and backward
            through ``chunked_sdpa`` (a checkpoint a query chunk) and
            through the un-checkpointed loop of its chunk function, the
            gradients of q, k and v bit-equal, the peak and time of
            each; (g) ``python -m repro_torch.launch.train --arch
            zamba2-2.7b --smoke`` (30 steps) in a fresh process, its
            last logged loss below its first.  Its kernel: K2 on the
            restore's reshard plans.
29. multi   the LM stack's multi-device modules (``launch/mesh``,
            ``launch/partition``, ``models/sharding``,
            ``runtime/pipeline``, ``launch/dryrun``) and the quickstart
            twin (``MULTI``): (a) ``examples/quickstart_torch.py`` on the
            card and with ``--device cpu`` in fresh processes, the same
            lines, K1, K2, K3 and K8 launched on the card; (b)
            Zamba2-2.7B, 54 layers, float32, its parameters and cache as
            DTensors placed by ``partition``'s specs on a (1, 1) NCCL mesh
            under ``launch.mesh.sharded`` (a size-1 mesh dim
            replicates, so every placement is replicated, each
            ``constrain`` returns its input and no op is repaired: the
            phase shows that replicated DTensors run the model bit for
            bit, not a redistribution), a 512-token prefill and 8 decode steps
            against the plain path on the same weights (``LM_C_TOL``; bit
            equality printed), decode ms a token beside the plain path's;
            (c) Mamba2-780m, 48 layers, bf16, B 8 × S 2,048 through
            ``pipeline_forward`` at 4 microbatches over NCCL at world size
            1: bit-equal to the stack run microbatch by microbatch, within
            ``MULTI_C_TOL`` of the whole batch, times beside both; (d) the
            dry run, started in fresh processes before phase 27 so that
            its host work overlaps phases 27 and 28: ``--smoke`` (mamba2-780m,
            ``long_500k``, both meshes) on cuda fake tensors, the
            production cell zamba2-2.7b ``train_4k`` on the 256-rank mesh
            at 12 of its 54 layers (two groups: the one-unit trace's
            difference still gives a layer's cost) with its wall time,
            and the one-card cell (Zamba2 train, B 2
            × S 4,096, ``grad_accum`` 1, a (1, 1) mesh), whose
            ``flops_per_device`` must equal ``FlopCounterMode`` on the
            real step and whose ``peak_estimate`` over phase 28 (a)'s
            measured peak must lie in ``MULTI_PEAK_RATIO``.  It launches
            K1, K2, K3 and K8 in (a)'s card process only.

Every path runs with the launch counters of its kernels zeroed just
before and read just after; each kernel must have launched.  Then one
JSON line with a record per kernel, and as the last line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before
that line; so does a host without a CUDA device.
"""
from __future__ import annotations

import functools
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.analysis.kernel_audit import (  # noqa: E402
    kernel_code, pick, resources)

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
# Zamba2-2.7B's shared attention block (src/repro/configs/zamba2_2_7b.py)
# at prefill_32k's sequence, and long_500k's sequence; the JAX auditor's
# sequence (src/repro/analysis/matrix.py)
ZAMBA2 = dict(seq=32_768, heads=32, dh=80, block=128, window=4096, sink=1,
              long_seq=524_288, f32_heads=4, big_bh=1024, aud_seq=2048)
# K7 is held to its plain version within the kernel's stated accuracy,
# ``repro_torch.kernels.sparse_attn.BF16_TOL`` / ``F32_TOL``: in bfloat16
# it rounds P to bf16 before P·V, so each element may move by
# 2^-8·plain(|v|) besides one output rounding; in float32, 2e-5.
# H100 SXM published peaks (NVIDIA datasheet): HBM bytes/s, the 32-bit
# rate outside the tensor cores (used for the integer work here), and
# the dense bf16 tensor-core rate (used for attention)
HBM_BYTES_PER_S = 3.35e12
OPS32_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12


# Phase 26, the LM serving path of Zamba2-2.7B
# (src/repro_torch/configs/zamba2_2_7b.py): (a) 6 of its 54 layers (one
# Mamba group and the shared block) in float32, B 2, a 64-token prefill
# and 8 steps on the card and on the CPU; (b) chunked_sdpa at the shared
# block's width, S 4,496 (past window 4,096 + sink 128); (c) all 54
# layers in float32, B 1, forward over 4,496 tokens against a 4,480-token
# prefill (35 chunks of 128) and 16 steps; (d) the launcher's docstring
# example without --smoke; (e) bf16 timed runs (batch, prompt, generated)
LM_PHASE = dict(arch="zamba2_2_7b", a_layers=6, a_batch=2,
                a_prompt=64, a_steps=8, b_seq=4496, c_prompt=4480,
                c_steps=16, e_runs=((1, 4480, 32), (4, 48, 32)),
                cli=("--batch", "4", "--prompt-len", "48", "--gen", "32"))
# float32 logits, held as |got - want| <= tol + tol·|want|: (a) the card
# against the CPU (6 layers), (c) the cache path against the forward (54
# layers; the SSD's chunks against its recurrence)
LM_A_TOL = 1e-3
LM_C_TOL = 2e-3
# Phase 27, the LM serving path of the MoE, MLA and audio families at
# their published widths (src/repro_torch/configs/deepseek_v2_236b.py,
# phi3_5_moe_42b.py, whisper_medium.py): (a) each at reduced depth in
# float32, B 2, a 64-token prefill and 8 steps on the card and on the CPU
# (DeepSeek-V2 1 dense + 1 MoE layer, Phi-3.5-MoE 2, Whisper-medium 2 + 2
# over its 1,500 frames); (b) MLA's absorbed decode against its expanded
# read on (a)'s DeepSeek-V2; (c) DeepSeek-V2 at 4 of its 60 layers in
# float32, mla_absorb=False, capacity_factor raised to E = 160 so that
# no token drops in either run, B 1: forward over 1,040 tokens against a
# 1,024-token prefill and 16 steps (at 1.25 the forward's groups of 520
# tokens and the decode's groups of one drop different tokens); (d) the
# launcher in fresh processes (Whisper-medium at its published config,
# the two MoE configs with --smoke: on one card they do not fit at
# full depth); (e) bf16 timed runs: (arch, depth or None for all,
# (batch, prompt, generated) runs)
LM27 = dict(a=(("deepseek_v2_236b", {"n_layers": 2}),
               ("phi3_5_moe_42b", {"n_layers": 2}),
               ("whisper_medium", {"n_layers": 2, "enc_layers": 2})),
            a_batch=2, a_prompt=64, a_steps=8,
            c_layers=4, c_prompt=1024, c_steps=16,
            cli=(("whisper-medium",), ("deepseek-v2-236b", "--smoke"),
                 ("phi3.5-moe-42b-a6.6b", "--smoke")),
            e=(("deepseek_v2_236b", 4, ((1, 1024, 32), (4, 48, 32))),
               ("phi3_5_moe_42b", 8, ((4, 48, 32),)),
               ("whisper_medium", None, ((4, 48, 32),))))
# (b) float32 logits, |got - want| <= tol + tol·|want|: the absorbed
# decode is the expanded read's products in another association
LM_MLA_TOL = 1e-3
# Phase 28, the LM training path of Zamba2-2.7B
# (src/repro_torch/configs/zamba2_2_7b.py; train_4k is S 4,096 at a
# global batch of 256, configs/__init__.py SHAPES): (a) full depth through
# Trainer.run at B 2, one warm step and a_steps timed; (b) make_train_step
# at the config's grad_accum 4 with B 4; (c) one Mamba group (6 layers and
# the shared block) in float32 at B 1 × S 256, card against CPU; (d) the
# restart drill on that model at B 1 × S 512; (e) its 2-shard checkpoint
# restored at 3 shards; (f) one shared-attention call at (a)'s B and S,
# through chunked_sdpa and through the un-checkpointed loop; (g) the
# launcher
TRAIN = dict(arch="zamba2_2_7b", seq=4096, a_batch=2, a_steps=3,
             b_batch=4, c_layers=6, c_seq=256, d_seq=512, d_steps=4,
             d_every=2, d_shards=2, d_fail=3, e_shards=3,
             cli=("--arch", "zamba2-2.7b", "--smoke", "--steps", "30",
                  "--batch", "8", "--seq", "64"))
# (c) the card against the CPU after one float32 step: loss and grad_norm
# relative; each parameter tensor's update Δ = p_after − p_before as
# ||Δ_card − Δ_cpu|| / ||Δ_cpu||.  At step 1 AdamW moves an element by
# lr·g/(|g| + eps), so an element whose |g| is near eps carries the
# devices' gradient difference into its update at full size; the L2 ratio
# bounds how much of a tensor's update such elements are.
TRAIN_C_TOL = dict(loss=1e-4, grad_norm=1e-3, update=1e-2)


# Phase 29, the LM stack's multi-device modules (launch/mesh.py,
# launch/partition.py, models/sharding.py, runtime/pipeline.py,
# launch/dryrun.py, launch/probe_buffers.py) and the quickstart twin: (a)
# examples/quickstart_torch.py on the card against --device cpu; (b)
# Zamba2-2.7B at full width and depth in float32 with its parameters and
# cache placed by partition's specs on a (1, 1) NCCL mesh, constrain
# active, a b_prompt-token prefill and b_steps decode steps against the
# plain path on the same weights (held to LM_C_TOL); (c) Mamba2-780m at
# full width and depth in bf16, B c_batch × S c_seq through
# pipeline_forward at c_micro microbatches over NCCL at world size 1;
# (d) the dry run: --smoke on cuda fake tensors, the production cell
# d_prod on the 256-rank single mesh at d_prod_layers (its depth cut so
# that the script ends well inside its time limit: the per-chunk remat
# made the 54-layer trace ~600 s of host time on the card's host), and
# the one-card cell (Zamba2 train at B d_batch × S d_seq on a (1, 1)
# mesh, grad_accum 1 as Trainer.run)
MULTI = dict(b_arch="zamba2_2_7b", b_prompt=512, b_steps=8,
             c_arch="mamba2_780m", c_batch=8, c_seq=2048, c_micro=4,
             d_prod=("zamba2-2.7b", "train_4k"), d_prod_layers=12,
             d_batch=2, d_seq=4096)
# (c) the pipeline against the whole-batch stack, bf16: the microbatch
# stack is its bits (checked equal); the whole batch's products take
# other shapes, |got - want| <= atol + rtol·|want| and the relative RMS
# error at most rms
MULTI_C_TOL = dict(atol=1e-1, rtol=1e-1, rms=5e-2)
# (d) the one-card cell's peak_estimate over phase 28 (a)'s measured
# max_memory_allocated: the trace sees every tensor the step's Python
# code makes, not the workspaces that kernels allocate inside one op
MULTI_PEAK_RATIO = (0.90, 1.05)


class SmokeError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def smi(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def instructions_per_pair(sass: list[str], mixed: bool) -> tuple[float, int,
                                                                  int]:
    """Instructions per pair in one of K3's unrolled row loops, found as a
    backward branch and the code it jumps back over.  A pair costs two
    FFMA.SAT (FMA form) or two FSETP (FSETP form); ``mixed`` picks the
    loop that holds both forms, else the loop of FSETP alone, the densest
    in pairs either way.  Returns (ratio, instructions, pairs)."""
    ins = []
    for line in sass:
        hit = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]+);", line)
        if hit:
            ins.append((int(hit.group(1), 16), hit.group(2).strip()))
    best = None
    for addr, text in ins:
        jump = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", text)
        if jump and int(jump.group(1), 16) <= addr:
            top = int(jump.group(1), 16)
            body = [t for a, t in ins if top <= a <= addr]
            sat = sum("FFMA.SAT" in t for t in body)
            pairs = (sat + sum("FSETP" in t for t in body)) // 2
            if pairs and (sat > 0) == mixed and (
                    best is None or pairs / len(body) > best[0]):
                best = (pairs / len(body), len(body), pairs)
    check(best is not None, f"no {'mixed' if mixed else 'FSETP'} row loop "
          "in K3's d1 kernel")
    return best[1] / best[2], best[1], best[2]


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


def time_back_to_back(fn, launches: int = 20, reps: int = REPS) -> float:
    """Median over ``reps`` of one CUDA-event pair around ``launches``
    back-to-back calls of ``fn``, divided by ``launches``: while the card
    runs the queued kernels, the host's time between launches is hidden,
    so a raw launch function gives the kernel's own time."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float = OPS32_PER_S) -> tuple[float, str]:
    """Least time for the work: max of bytes over HBM rate and operations
    over ``ops_per_s`` (the 32-bit rate unless named), in ms, and which
    of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
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
    koln_flags = sbm._endpoint_stream(SK.lo[:, 0], SK.hi[:, 0], UK.lo[:, 0],
                                      UK.hi[:, 0])
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
    # K2 at the alpha = 1 of fig. 12's sweep: most emitters have count 0,
    # so its tiles span thousands of uncompacted entries
    S1, U1 = paper_workload(**{**fig9, "alpha": 1.0}, device=dev)
    k_a1 = sbm.sbm_count_binary(S1, U1)
    a1_args = sbm._twopass_phase1(S1.lo[:, 0], S1.hi[:, 0], U1.lo[:, 0],
                                  U1.hi[:, 0], k_a1)[:5]
    a1_args = (a1_args[4], a1_args[3], a1_args[2], a1_args[0], a1_args[1])
    k2_a1_err = exact_err(emit.twopass_emit(*a1_args, max_pairs=k_a1),
                          ref.twopass_emit(*a1_args, max_pairs=k_a1))
    check(k2_a1_err == 0, f"K2 at alpha = 1 != plain (max err {k2_a1_err})")
    print(f"[K2] alpha=1 N={S1.n + U1.n} K={k_a1}: bit-equal to plain")
    del S1, U1
    times = {
        "count_e2e": time_ms(lambda: plan.count(S, U)),
        "pairs_e2e": time_ms(lambda: plan.pairs(S, U)),
        "k1": time_ms(lambda: sweep.sbm_sweep(is_lo, is_upd)),
        "k1_plain": time_ms(lambda: ref.sbm_sweep(is_lo, is_upd)),
        "k2": time_ms(lambda: emit.twopass_emit(*emit_args,
                                                max_pairs=k_bin)),
        "k2_plain": time_ms(lambda: ref.twopass_emit(*emit_args,
                                                     max_pairs=k_bin)),
        "k2_alpha1": time_ms(lambda: emit.twopass_emit(*a1_args,
                                                       max_pairs=k_a1)),
    }
    if dev == "cuda":
        times.update(time_k1_k2(is_lo, is_upd, emit_args, k_bin, a1_args,
                                k_a1))
        times.update(time_k1_wrapper(koln_flags))
        print_k1_k2(times, k_bin, k_a1, is_lo.numel())
    del koln_flags

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


def tbs(nbytes: float, ms: float) -> float:
    """Terabytes a second of ``nbytes`` moved in ``ms``."""
    return nbytes / (ms * 1e-3) / 1e12


def raw_launch(fn, *args):
    """``fn(*args, stream)`` once, checked, and a closure that repeats it
    (a kernel's launch function called without its wrapper)."""
    import torch
    stream = torch.cuda.current_stream().cuda_stream
    check(fn(*args, stream) == 0, f"{fn.__name__} refused the launch")
    return lambda: fn(*args, stream)


# K1's tile sizes timed beside its default, as (SBM_SWEEP_BLOCK threads,
# SBM_SWEEP_ITEMS endpoints a thread) of csrc/sbm_sweep.cu: tiles of
# 2048, 4096, 8192 and 16384 endpoints
K1_SHAPES = ((256, 8), (256, 16), (256, 32), (512, 32))
# K1 with cold L2: rotate over enough copies of its inputs, output and
# scratch that each launch's were evicted (the card's L2 is 50 MB)
K1_COLD_BYTES = 100e6


def k1_variants(shapes=K1_SHAPES) -> dict:
    """K1's library built at each (threads, endpoints a thread) of
    ``shapes`` (one ``nvcc`` each, all started together, into the build
    directory), for timing its tile sizes: {tile: (library, path)}.  The
    tile of the library ``_build`` loads, csrc/sbm_sweep.cu's default,
    is not built again."""
    from repro_torch.kernels import _build
    default = _build.load("sbm_sweep")
    libs = {default.const["sbm_sweep_tile"]:
            (default, _build._target("sbm_sweep"))}
    nvcc, jobs = _build._nvcc(), {}
    for block, items in shapes:
        if block * items in libs:
            continue
        path = _build.BUILD_DIR / f"libsbm_sweep_{block}x{items}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, f"-DSBM_SWEEP_BLOCK={block}",
               f"-DSBM_SWEEP_ITEMS={items}", "-o", str(path),
               str(_build.CSRC / "sbm_sweep.cu")]
        jobs[path] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    try:
        for path, job in jobs.items():
            out, _ = job.communicate()
            check(job.returncode == 0, f"nvcc of {path.name} failed:\n{out}")
            lib = _build._open("sbm_sweep", path)
            libs.setdefault(lib.const["sbm_sweep_tile"], (lib, path))
    finally:
        for job in jobs.values():      # never leave nvcc running
            if job.poll() is None:
                job.kill()
                job.wait()
    return libs


def time_k1(is_lo, is_upd) -> dict:
    """K1 alone at each tile size (``k1_variants``): its launch function
    (the scratch memset and the kernel) called raw, 20 launches back to
    back, with L2 hot (one set of arrays) and cold (launches rotating
    over copies of the flags, output and scratch past
    ``K1_COLD_BYTES``)."""
    import torch
    from repro_torch.kernels import sbm_sweep as sweep
    T = is_lo.numel()
    stream = torch.cuda.current_stream().cuda_stream
    t = {}
    for tile, (lib, path) in sorted(k1_variants().items()):
        for kname, fn in sorted(kernel_code("sbm_sweep", path).items()):
            inst = "vector" if "ILb1E" in kname else "scalar"
            print(f"[K1] tiles of {tile}, {inst} instance: {resources(fn)}, "
                  f"static shared {fn.get('shared', 'not read')} B")
        sw = sweep.scratch_words(T, tile)      # the wrapper's layout
        copies = math.ceil(K1_COLD_BYTES / (4 * (3 * T + sw))) + 1
        sets = [(is_lo.clone(), is_upd.clone(),
                 torch.empty(sw + T, dtype=torch.int32, device="cuda"))
                for _ in range(copies)]
        calls = []
        for lo, up, buf in sets:
            args = (lo.data_ptr(), up.data_ptr(), buf.data_ptr() + 4 * sw,
                    buf.data_ptr(), T)
            check(lib.sbm_sweep_launch(*args, stream) == 0,
                  f"{path.name} refused the launch")
            torch.cuda.synchronize()
            check(torch.equal(buf[sw:], sets[0][2][sw:]),
                  f"{path.name}: copies disagree")
            calls.append(functools.partial(lib.sbm_sweep_launch, *args,
                                           stream))
        check(torch.equal(sets[0][2][sw:], sweep.sbm_sweep(is_lo, is_upd)),
              f"K1 in tiles of {tile} != the wrapper's K1")
        turn = itertools.cycle(calls)
        t[f"k1_alone_tile{tile}"] = time_back_to_back(calls[0])
        t[f"k1_alone_cold_tile{tile}"] = time_back_to_back(
            lambda: next(turn)())
        del sets, calls, turn
    return t


def time_k1_wrapper(koln_flags) -> dict:
    """K1 through its wrapper on Koln's endpoint stream and on the
    sparse planner's at Zamba2's plan (T = 1,024) and at long_500k's
    (T = 16,384), the streams ``block_windows`` gives K1."""
    from repro_torch.core import sbm
    from repro_torch.kernels import sbm_sweep as sweep
    from repro_torch.sparse import BlockPlan, planner
    z = ZAMBA2
    t = {"k1_koln": time_ms(lambda: sweep.sbm_sweep(*koln_flags))}
    for seq in (z["seq"], z["long_seq"]):
        plan = BlockPlan(seq, z["block"], z["block"], z["window"], z["sink"])
        S, U = planner._q_subscriptions(plan), planner._kv_updates(plan)
        flags = sbm._endpoint_stream(S.lo[:, 0], S.hi[:, 0], U.lo[:, 0],
                                     U.hi[:, 0])
        t[f"k1_planner_T{flags[0].numel()}"] = time_ms(
            lambda: sweep.sbm_sweep(*flags))
    return t


def time_k1_k2(is_lo, is_upd, emit_args, k, a1_args, k_a1) -> dict:
    """K1 and K2 beside their wrappers' times: each launch function
    called raw, 20 launches back to back (``time_back_to_back``); K1 at
    its tile sizes, L2 hot and cold (``time_k1``), K2 at fig. 9 and at
    alpha = 1."""
    import torch
    from repro_torch.kernels import _build
    lib2 = _build.load("emit")
    out2 = torch.empty((max(k, k_a1), 2), dtype=torch.int32, device="cuda")

    def k2_raw(args, slots):
        offs, counts, starts, perm_s, perm_u = args
        return raw_launch(lib2.twopass_emit_launch, offs.data_ptr(),
                          counts.data_ptr(), starts.data_ptr(),
                          perm_s.data_ptr(), perm_u.data_ptr(),
                          perm_s.shape[0], perm_u.shape[0], slots,
                          out2.data_ptr())

    t = time_k1(is_lo, is_upd)
    tile = _build.load("sbm_sweep").const["sbm_sweep_tile"]
    t["k1_alone"] = t[f"k1_alone_tile{tile}"]
    t["k1_alone_cold"] = t[f"k1_alone_cold_tile{tile}"]
    return {
        **t,
        "k2_alone": time_back_to_back(k2_raw(emit_args, k)),
        "k2_alpha1_alone": time_back_to_back(k2_raw(a1_args, k_a1)),
    }


def print_k1_k2(t: dict, k: int, k_a1: int, endpoints: int) -> None:
    """K1's and K2's achieved rates (K1: 12 B an endpoint; K2: 8 B
    written and a 4-byte partner read a slot), K2's tile and every K2
    instance's registers, shared memory and spills (``cuobjdump``; the
    dynamic shared memory from the tile: the owner array and the
    window of three table rows)."""
    from repro_torch.kernels import _build, emit
    tile = _build.load("emit").twopass_emit_tile
    t9, t1 = tile(k), tile(k_a1)
    print(f"[K1] {endpoints} endpoints: {t['k1']!r} ms through the wrapper, "
          f"{t['k1_alone']!r} ms alone with L2 hot "
          f"({tbs(12 * endpoints, t['k1_alone'])!r} TB/s of 12 B an "
          f"endpoint), {t['k1_alone_cold']!r} ms with L2 cold "
          f"({tbs(12 * endpoints, t['k1_alone_cold'])!r} TB/s); through the "
          f"wrapper at Koln {t['k1_koln']!r} ms, "
          + ", ".join(f"at the planner's T = {key[12:]} {t[key]!r} ms"
                      for key in sorted(t)
                      if key.startswith("k1_planner_T")))
    k1_tiles = sorted(int(key[13:]) for key in t
                      if key.startswith("k1_alone_tile"))
    for tile_k1 in k1_tiles:
        print(f"[K1] tiles of {tile_k1} endpoints alone: "
              f"{t[f'k1_alone_tile{tile_k1}']!r} ms hot, "
              f"{t[f'k1_alone_cold_tile{tile_k1}']!r} ms cold")
    funcs = sorted(kernel_code("sbm_sweep"))
    print(f"[K1] kernel functions in libsbm_sweep: {len(funcs)} {funcs}")
    print(f"[K2] fig. 9 K={k} (tiles of {t9} slots): {t['k2']!r} ms through "
          f"the wrapper, {t['k2_alone']!r} ms alone "
          f"({tbs(12 * k, t['k2_alone'])!r} TB/s of 12 B a slot); alpha=1 "
          f"K={k_a1} (tiles of {t1}): {t['k2_alpha1']!r} / "
          f"{t['k2_alpha1_alone']!r} ms "
          f"({tbs(12 * k_a1, t['k2_alpha1_alone'])!r} TB/s)")
    for kname, fn in sorted(kernel_code("emit").items()):
        print(f"[K2] {kname}: {resources(fn)}, static shared "
              f"{fn.get('shared', 'not read')} B, dynamic shared "
              f"{4 * t9 + 12 * emit.EMIT_WMAX} B at fig. 9")


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
    from repro_torch.kernels import _build, bfm, emit, ops, ref

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
    # the same bounds with one subnormal s_lo: no K makes the FMA compare
    # exact, so K3 takes its all-FSETP instance
    fsetp_args = (s_lo.clone(), s_hi, u_lo, u_hi)
    fsetp_args[0][0, 0] = 1e-40
    check(bfm.fma_scale(*fsetp_args) == 0.0,
          "fma_scale allows the FMA form with a subnormal bound")
    tiles = bfm.bfm_tile_counts(*fsetp_args, ts=ts, tu=tu)
    tiles_plain = ref.bfm_tile_counts(*fsetp_args, ts, tu)
    k3_fsetp_err = exact_err(tiles, tiles_plain)
    check(k3_fsetp_err == 0,
          f"K3's FSETP instance != plain (max err {k3_fsetp_err})")
    del tiles, tiles_plain
    print(f"[bfm] fig9 K={k_bfm} (sbm {k_sbm}, plain {k_plain}, gbm "
          f"{k_gbm}); koln K={k_koln}; d=2 K={k_d2}; K3 tiles bit-equal "
          f"to plain, in both instances (FMA K "
          f"{bfm.fma_scale(*tiles_args)!r}, and 0 with a subnormal bound); "
          f"K3 launches={k3_launches}")
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
    # the same n and m at d = 2: K4 holds both dimensions in registers
    SM2, UM2 = paper_workload(**mask_wl, d=2, device=dev)
    mask2_args = (SM2.lo, SM2.hi, UM2.lo, UM2.hi)
    mask2 = bfm.bfm_mask(*mask2_args)
    k4_d2_err = exact_err(mask2, ref.bfm_mask(*mask2_args))
    check(k4_d2_err == 0, f"K4 at d = 2 != plain (max err {k4_d2_err})")
    print(f"[mask] d=2 n={SM2.n} m={UM2.n} K={int(mask2.sum())}: K4 "
          "bit-equal to plain")
    del mask2

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
    k3_K = bfm.fma_scale(*tiles_args)
    times = {
        "k3": time_ms(lambda: bfm.bfm_tile_counts(*tiles_args, ts=ts,
                                                  tu=tu)),
        # K3 without the wrapper's read of the exponent range, and in its
        # all-FSETP instance
        "k3_no_read": time_ms(lambda: bfm._launch_tile_counts(
            *tiles_args, ts, tu, k3_K)),
        "k3_fsetp": time_ms(lambda: bfm.bfm_tile_counts(*fsetp_args, ts=ts,
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
    # K3's d1 path: SASS instructions per pair and the issue floor they
    # imply at fig. 9 (four schedulers of 32 lanes per SM, each issuing
    # one instruction a cycle at the card's top SM clock)
    if dev == "cuda":
        check(bool(_build.load("bfm").bfm_tile_counts_d1_path(ts, tu, 1)),
              f"fig. 9's {ts} x {tu} tiles do not take K3's d1 path")
        code = kernel_code("bfm")
        form = "mixed" if bfm.fma_scale(*tiles_args) else "FSETP"
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        clk_mhz = float(smi("clocks.max.sm").split()[0])
        issue = sms * 4 * 32 * clk_mhz * 1e6
        for name in ("mixed", "FSETP"):
            _, d1 = pick(code, "bfm_tile_counts_d1_kernel",
                         "ILb1E" if name == "mixed" else "ILb0E")
            ipp, loop_ins, loop_pairs = instructions_per_pair(
                d1["sass"], name == "mixed")
            floor_ms = n_pad * m_pad * ipp / issue * 1e3
            print(f"[K3] d1 path, {name} row loop"
                  f"{' (fig. 9 takes it)' if name == form else ''}: "
                  f"{loop_ins} SASS instructions for {loop_pairs} pairs in "
                  f"the row loop, {ipp!r} a pair; issue floor at fig. 9 "
                  f"{floor_ms!r} ms ({sms} SMs x 128 lanes x {clk_mhz} "
                  f"MHz); {resources(d1)}")
        print(f"[K3] fig. 9: {n_pad * m_pad / (times['k3'] * 1e-3) / 1e12!r} "
              f"Tpairs/s achieved; {times['k3']!r} ms through the wrapper, "
              f"{times['k3_no_read']!r} ms without its read of the bounds' "
              f"exponent range, {times['k3_fsetp']!r} ms in the all-FSETP "
              f"instance (one subnormal bound)")
    # K4: one byte per pair out, the bounds in; two compares per pair
    k4_bound = bound_ms(nm_mask + 8 * (SM.n + UM.n), 2 * nm_mask)
    if dev == "cuda":
        times.update(time_k4_k6(mask_args, mask2_args, k6_args))
        print_k4_k6(times, k4_bound, nm_mask, k6_args[4])
        times.update(time_k5(k5_args, k_r, bl))
        print_k5(times, k_r, bl)
    win = emit.stream_window(bl)
    # K5: the packed table and the permutations in, 8 B per slot out;
    # per slot a binary search over the window plus ~12 operations
    k5_bound = bound_ms(4 * 4 * e_pad + 4 * E + 8 * k_r,
                        (6 * math.ceil(math.log2(win)) + 12) * k_r)
    # K6 reads what its window needs: one partner per slot (4 B) and
    # writes 8 B per slot; about a dozen operations a slot (its owner from
    # the scan, the decode), the two searches a tile negligible beside them
    k6_bound = bound_ms(12 * w_n, 12 * w_n)

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
        rec("bfm_mask", "src/repro_torch/csrc/bfm_mask.cu",
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


def time_k4_k6(mask_args, mask2_args, k6_args) -> dict:
    """K4 and K6 beside their wrappers' times: each launch function
    called raw, 20 launches back to back (``time_back_to_back``); K4 at
    d = 2, the store ceiling (``fill_`` of the mask's bytes) and K6 on a
    65,536-slot window (``windows()``'s default chunk)."""
    import torch
    from repro_torch.kernels import _build, bfm, emit
    raw = raw_launch
    lib4, lib6 = _build.load("bfm_mask"), _build.load("csr_decode")
    n, m = mask_args[0].shape[0], mask_args[2].shape[0]
    out4 = torch.empty((n, m), dtype=torch.bool, device="cuda")

    def k4_raw(args):
        return raw(lib4.bfm_mask_launch, *(x.data_ptr() for x in args),
                   n, m, args[0].shape[1], out4.data_ptr())

    tab, perm_s, perm_u, w0, nsl = k6_args
    small = (tab, perm_s, perm_u, w0, 1 << 16)
    out6 = torch.empty((nsl, 2), dtype=torch.int32, device="cuda")

    def k6_raw(nslots):
        return raw(lib6.csr_decode_launch, tab.data_ptr(), tab.shape[1],
                   perm_s.data_ptr(), perm_u.data_ptr(), perm_s.shape[0],
                   perm_u.shape[0], w0, nslots, out6.data_ptr())

    fill = torch.empty((n, m), dtype=torch.uint8, device="cuda")
    return {
        "k4_alone": time_back_to_back(k4_raw(mask_args)),
        "k4_d2": time_ms(lambda: bfm.bfm_mask(*mask2_args)),
        "k4_d2_alone": time_back_to_back(k4_raw(mask2_args)),
        "store_ceiling_fill": time_ms(lambda: fill.fill_(1)),
        "store_ceiling_fill_alone": time_back_to_back(lambda: fill.fill_(1)),
        "k6_alone": time_back_to_back(k6_raw(nsl)),
        "k6_65536": time_ms(lambda: emit.csr_decode_window(*small)),
        "k6_65536_alone": time_back_to_back(k6_raw(1 << 16)),
    }


def time_k5(k5_args, k: int, bl: int) -> dict:
    """K5 beside its wrapper's time: its launch function called raw, 20
    launches back to back, at the default tile and at tiles of 512, 1024
    and 2048 slots; and K6's kernel decoding the same [0, K)."""
    import torch
    from repro_torch.kernels import _build
    tab, perm_s, perm_u = k5_args
    out = torch.empty((k, 2), dtype=torch.int32, device="cuda")
    lib5, lib6 = _build.load("emit_stream"), _build.load("csr_decode")

    def k5_raw(block):
        return raw_launch(lib5.emit_stream_launch, tab.data_ptr(),
                          tab.shape[1], perm_s.data_ptr(), perm_u.data_ptr(),
                          perm_s.shape[0], perm_u.shape[0], k, block,
                          out.data_ptr())

    t = {"k6_whole_alone": time_back_to_back(raw_launch(
        lib6.csr_decode_launch, tab.data_ptr(), tab.shape[1],
        perm_s.data_ptr(), perm_u.data_ptr(), perm_s.shape[0],
        perm_u.shape[0], 0, k, out.data_ptr()))}
    for block in sorted({bl, 512, 1024, 2048}):
        key = "k5_alone" if block == bl else f"k5_alone_block{block}"
        t[key] = time_back_to_back(k5_raw(block))
    return t


def print_k5(t: dict, k: int, bl: int) -> None:
    """K5's achieved rate (8 B written and a 4-byte partner read a slot)
    and every K5 instance's registers, shared memory (dynamic: the owner
    array and the window of four table rows) and spills."""
    from repro_torch.kernels import emit
    print(f"[K5] fig. 9 K={k}: {t['k5']!r} ms through the wrapper, "
          f"{t['k5_alone']!r} ms alone ({tbs(12 * k, t['k5_alone'])!r} TB/s "
          f"of 12 B a slot); "
          f"K6's kernel over the same [0, K): {t['k6_whole_alone']!r} ms "
          f"alone")
    for key in sorted(t):
        if key.startswith("k5_alone_block"):
            print(f"[K5] tiles of {key[14:]} slots alone: {t[key]!r} ms")
    for kname, fn in sorted(kernel_code("emit_stream").items()):
        print(f"[K5] {kname}: {resources(fn)}, static shared "
              f"{fn.get('shared', 'not read')} B, dynamic shared "
              f"{4 * bl + 16 * emit.EMIT_WMAX} B at tiles of {bl}")


def print_k4_k6(t: dict, k4_bound, mask_bytes: int, k6_slots: int) -> None:
    """K4's and K6's achieved rates and each instance's registers, shared
    memory and spills (``cuobjdump`` of the built libraries)."""
    print(f"[K4] n*m = {mask_bytes} B: {t['k4']!r} ms through the wrapper, "
          f"{t['k4_alone']!r} ms alone ({tbs(mask_bytes, t['k4_alone'])!r} "
          f"TB/s); d = 2 {t['k4_d2']!r} / {t['k4_d2_alone']!r} ms; store "
          f"ceiling (fill_ of the same bytes) "
          f"{t['store_ceiling_fill']!r} / {t['store_ceiling_fill_alone']!r} ms "
          f"({tbs(mask_bytes, t['store_ceiling_fill_alone'])!r} TB/s); bound "
          f"{k4_bound[0]!r} ms")
    # K6's bound counts 8 B written and a 4-byte partner read per slot
    print(f"[K6] {k6_slots} slots: {t['k6']!r} ms through the wrapper, "
          f"{t['k6_alone']!r} ms alone ({tbs(12 * k6_slots, t['k6_alone'])!r} "
          f"TB/s of 12 B a slot); 65536 slots {t['k6_65536']!r} / "
          f"{t['k6_65536_alone']!r} ms ({tbs(12 << 16, t['k6_65536_alone'])!r}"
          f" TB/s)")
    for lib, stem in (("bfm_mask", "bfm_mask_kernel"),
                      ("csr_decode", "csr_decode_kernel")):
        for kname, fn in sorted(kernel_code(lib).items()):
            if stem not in kname:
                continue
            inst = re.search(r"ILi(\d+)ELi(\d+)E", kname)
            what = f"V={inst.group(1)} NREG={inst.group(2)}" if inst else ""
            print(f"[{'K4' if lib == 'bfm_mask' else 'K6'}] {stem} {what}: "
                  f"{resources(fn)}, static shared "
                  f"{fn.get('shared', 'not read')} B")


def check_close(got, want, what: str, *, atol: float, rtol: float,
                rms: float, ptol: float = 0.0,
                want_abs_v=None) -> tuple[float, float]:
    """``|got - want| <= atol + ptol·want_abs_v + rtol·|want|`` everywhere
    (``want_abs_v``: the plain version on |v|, needed when ``ptol`` > 0)
    and ``||got - want|| <= rms·||want||``; the max abs err and the
    relative RMS error."""
    import torch
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    diff = (got - want).abs()
    lim = atol + rtol * want.abs()
    if ptol:
        lim = lim + ptol * want_abs_v.float()
    bad = diff > lim
    err = float(diff.max())
    rel = float(diff.norm()) / max(float(want.norm()), 1e-30)
    check(not bool(bad.any()), f"{what}: {int(bad.sum())} elements off by "
          f"more than {atol} + {ptol}·plain(|v|) + {rtol}·|want| (max abs "
          f"err {err})")
    check(rel <= rms, f"{what}: relative RMS error {rel} > {rms}")
    return err, rel


def allowed_pairs(starts, ends, *, sq: int, skv: int, bq: int, bkv: int,
                  sink_end: int) -> int:
    """(query, key) pairs K7 needs: keys of a walked block with
    ``kv <= q``, ``kv < end`` and ``kv < skv``, summed over the queries."""
    import torch
    from repro_torch.kernels import ref
    first, count = ref.window_blocks(starts, ends, bkv=bkv,
                                     sink_end=sink_end)
    nq = sq // bq
    top = torch.minimum(                     # allowed keys lie below top
        torch.arange(1, sq + 1, device=starts.device).view(nq, bq),
        torch.clamp(ends.long(), max=skv)[:, None])
    sink = torch.clamp(top, min=0, max=sink_end // bkv * bkv)
    lo, hi = first * bkv, (first + count) * bkv
    win = torch.clamp(torch.minimum(top, hi[:, None]) - lo[:, None], min=0)
    return int((sink + win).sum())


def run_slice3(dev: str, z: dict) -> dict:
    """Phases 14-16 on ``dev``: the sparse-attention planner through K1
    and K2, then K7.  Returns launches, the K7 record and times.

    ``z`` holds the shapes (``ZAMBA2`` on the card).
    """
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels import emit, ref
    from repro_torch.kernels import sbm_sweep as sweep
    from repro_torch.kernels import sparse_attn as tsa
    from repro_torch.sparse import BlockPlan, block_windows
    BF16_TOL, F32_TOL = tsa.BF16_TOL, tsa.F32_TOL

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    def hull_ok(plan, starts, ends) -> bool:
        end = np.minimum((np.arange(plan.nq) + 1) * plan.block_q,
                         plan.seq_len)
        hs = np.maximum(0, end - plan.window) // plan.block_kv * plan.block_kv
        return (np.array_equal(ends.cpu().numpy(), end)
                and np.array_equal(starts.cpu().numpy(), hs))

    S, H, dh, blk = z["seq"], z["heads"], z["dh"], z["block"]
    plan = BlockPlan(S, blk, blk, z["window"], z["sink"])
    sink_end = plan.sink_end
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.float32).to(dtype)

    q, k, v = (randn(1, S, H, dh, dtype=torch.bfloat16) for _ in range(3))
    sync()

    # -- 14/15. the main path, launch counters zeroed just before ---------
    sweep.sbm_sweep.launches = 0
    emit.twopass_emit.launches = 0
    tsa.sparse_attn_bh.launches = 0
    starts, ends = block_windows(plan, device=dev)
    sync()
    launches = {"sbm_sweep": sweep.sbm_sweep.launches,
                "twopass_emit": emit.twopass_emit.launches}
    out = tsa.sparse_attn(q, k, v, starts, ends, bq=blk, bkv=blk,
                          sink_end=sink_end)
    sync()
    launches["sparse_attn"] = tsa.sparse_attn_bh.launches
    print(f"[main] block_windows (K1 {launches['sbm_sweep']}, K2 "
          f"{launches['twopass_emit']} launches) then sparse_attn (K7 "
          f"{launches['sparse_attn']}) at B=1 S={S} H={H} dh={dh}")
    check(launches["sbm_sweep"] > 0 and launches["twopass_emit"] > 0,
          f"block_windows did not run K1 and K2: {launches}")

    # -- 14. planner checks ----------------------------------------------
    cs, ce = block_windows(plan, device="cpu")
    check(starts.dtype == ends.dtype == torch.int32, "windows not int32")
    check(torch.equal(starts.cpu(), cs) and torch.equal(ends.cpu(), ce),
          "planner windows on the card != the CPU run")
    check(hull_ok(plan, starts, ends), "windows != the arithmetic hull")
    print(f"[planner] S={S} nq={plan.nq}: windows == cpu run == hull "
          f"[{int(starts[0])}, {int(ends[0])}) ... [{int(starts[-1])}, "
          f"{int(ends[-1])})")
    long_plan = BlockPlan(z["long_seq"], blk, blk, z["window"], z["sink"])
    sweep.sbm_sweep.launches = emit.twopass_emit.launches = 0
    ls, le = block_windows(long_plan, device=dev)
    sync()
    long_launches = (sweep.sbm_sweep.launches, emit.twopass_emit.launches)
    check(min(long_launches) > 0, f"long plan K1/K2 launches {long_launches}")
    lcs, lce = block_windows(long_plan, device="cpu")
    check(torch.equal(ls.cpu(), lcs) and torch.equal(le.cpu(), lce),
          "long plan windows on the card != the CPU run")
    check(hull_ok(long_plan, ls, le), "long plan windows != the hull")
    print(f"[planner] long S={long_plan.seq_len} nq={long_plan.nq}: "
          f"windows == cpu run == hull; K1/K2 launches {long_launches}")
    del ls, le, lcs, lce

    # -- 15. K7 against its plain version ---------------------------------
    def fold(x):
        return x.transpose(1, 2).reshape(-1, x.shape[1], x.shape[3]) \
            .contiguous()

    qf, kf, vf = fold(q), fold(k), fold(v)
    del q, k, v
    attn = dict(bq=blk, bkv=blk, sink_end=sink_end)
    plain = ref.sparse_attn_bh(qf, kf, vf, starts, ends, **attn)
    plain_abs_v = ref.sparse_attn_bh(qf, kf, vf.abs(), starts, ends, **attn)
    check(tuple(out.shape) == (1, S, H, dh) and out.dtype == torch.bfloat16,
          f"K7 output {tuple(out.shape)} {out.dtype}")
    k7_err, k7_rms = check_close(fold(out), plain, "K7 bf16 Zamba2",
                                 want_abs_v=plain_abs_v, **BF16_TOL)
    del plain_abs_v
    print(f"[attn] bf16 B=1 S={S} H={H} dh={dh}: K7 == plain within "
          f"{BF16_TOL} (max abs err {k7_err}, relative RMS {k7_rms})")

    H4 = z["f32_heads"]
    q4, k4, v4 = (randn(1, S, H4, dh, dtype=torch.float32)
                  for _ in range(3))
    o4 = tsa.sparse_attn(q4, k4, v4, starts, ends, bq=blk, bkv=blk,
                         sink_end=sink_end)
    p4 = ref.sparse_attn_bh(fold(q4), fold(k4), fold(v4), starts, ends,
                            bq=blk, bkv=blk, sink_end=sink_end)
    f32_err, f32_rms = check_close(fold(o4), p4, "K7 float32", **F32_TOL)
    del q4, k4, v4, o4, p4
    print(f"[attn] float32 H={H4}: K7 == plain within {F32_TOL} (max abs "
          f"err {f32_err}, relative RMS {f32_rms})")

    def one_case(name, plan_c, BH, dh_c, dtype, sink_c, tol):
        sc, ec = block_windows(plan_c, device=dev)
        qc, kc, vc = (randn(BH, plan_c.seq_len, dh_c, dtype=dtype)
                      for _ in range(3))
        kw = dict(bq=plan_c.block_q, bkv=plan_c.block_kv, sink_end=sink_c)
        got = tsa.sparse_attn_bh(qc, kc, vc, sc, ec, **kw)
        want = ref.sparse_attn_bh(qc, kc, vc, sc, ec, **kw)
        want_abs_v = ref.sparse_attn_bh(qc, kc, vc.abs(), sc, ec, **kw)
        err, rel = check_close(got, want, f"K7 {name}",
                               want_abs_v=want_abs_v, **tol)
        print(f"[attn] {name}: BH={BH} S={plan_c.seq_len} dh={dh_c} "
              f"{str(dtype)[6:]} sink_end={sink_c}: K7 == plain within "
              f"{tol} (max abs err {err}, relative RMS {rel})")

    # the JAX auditor's entry (src/repro/analysis/matrix.py): BH 8,
    # S 2048, dh 128, sink 256; then S % bkv != 0 and sink_end % bkv != 0
    one_case("auditor", BlockPlan(z["aud_seq"], 128, 128, 1024, 2), 8, 128,
             torch.float32, 256, F32_TOL)
    one_case("ragged", BlockPlan(2000, 80, 64, 300, 1), 4, dh,
             torch.bfloat16, 100, BF16_TOL)

    # B·H·S·dh past 2^31 at a small cost: a 128-token window, no sink
    BHb = z["big_bh"]
    big_plan = BlockPlan(S, blk, blk, blk, 0)
    sb, eb = block_windows(big_plan, device=dev)
    qb, kb, vb = (randn(BHb, S, dh, dtype=torch.bfloat16) for _ in range(3))
    ob = tsa.sparse_attn_bh(qb, kb, vb, sb, eb, bq=blk, bkv=blk, sink_end=0)
    big_err = 0.0
    for sl in (slice(0, 1), slice(BHb - 1, BHb)):
        kw = dict(bq=blk, bkv=blk, sink_end=0)
        want = ref.sparse_attn_bh(qb[sl], kb[sl], vb[sl], sb, eb, **kw)
        want_abs_v = ref.sparse_attn_bh(qb[sl], kb[sl], vb[sl].abs(), sb,
                                        eb, **kw)
        big_err = max(big_err, check_close(ob[sl], want, "K7 past 2^31",
                                           want_abs_v=want_abs_v,
                                           **BF16_TOL)[0])
    print(f"[attn] BH={BHb} S={S} dh={dh} (B·H·S·dh = {qb.numel()}, 2^31 = "
          f"{2 ** 31}): first and last slices == plain within {BF16_TOL} "
          f"(max abs err {big_err})")
    del qb, kb, vb, ob

    # -- 16. times ----------------------------------------------------------
    qp = torch.arange(S, device=dev)[:, None]
    kp = torch.arange(S, device=dev)[None, :]
    qblk = torch.arange(S, device=dev) // blk
    s64, e64 = starts.long()[qblk][:, None], ends.long()[qblk][:, None]
    mask = (kp <= qp) & (((kp >= s64) & (kp < e64)) | (kp < sink_end))
    del qp, kp, qblk, s64, e64
    q4d, k4d, v4d = (x.view(1, H, S, dh) for x in (qf, kf, vf))

    def sdpa():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(q4d, k4d, v4d,
                                                  attn_mask=mask)

    # SDPA against K7's plain version (float32, P unrounded): SDPA
    # rounds the softmax weights to bf16 before P·V, per element up to
    # 2^-8·plain(|v|) <= 2^-8·max|v|, and rounds its output (2^-8·|want|);
    # roundings of <= 2^-8 relative give a relative RMS below 2^-8, held
    # to 2^-7
    sdpa_tol = dict(atol=2 ** -8 * float(vf.abs().max()), rtol=2 ** -6,
                    rms=2 ** -7)
    lib_err, lib_rms = check_close(sdpa()[0], plain,
                                   "SDPA yardstick vs K7's plain version",
                                   **sdpa_tol)
    del plain
    print(f"[times] SDPA with the token mask computes K7's function here "
          f"within {sdpa_tol} (max abs err {lib_err}, relative RMS "
          f"{lib_rms})")
    times = {
        "k7": time_ms(lambda: tsa.sparse_attn_bh(qf, kf, vf, starts, ends,
                                                 **attn)),
        "k7_plain": time_ms(lambda: ref.sparse_attn_bh(qf, kf, vf, starts,
                                                       ends, **attn)),
        "k7_library_sdpa": time_ms(sdpa),
        "block_windows_e2e": time_ms(lambda: block_windows(plan,
                                                           device=dev)),
    }
    del mask

    # K7: 4·dh FLOP per allowed (query, key) pair and head, counted from
    # this run's windows; q, k, v read and out written once
    pairs = allowed_pairs(starts, ends, sq=S, skv=S, bq=blk, bkv=blk,
                          sink_end=sink_end)
    flops = 4 * dh * pairs * H
    nbytes = 4 * qf.numel() * qf.element_size() + 8 * plan.nq
    bound = bound_ms(nbytes, flops, BF16_TC_FLOP_PER_S)
    # the bf16 path's design, read from its SASS: HGMMA is wgmma, HMMA
    # mma.sync; every bf16 instance must use one of them
    code = kernel_code("sparse_attn")
    tc = {k: f for k, f in code.items() if "sparse_attn_tc_kernel" in k}
    check(len(tc) > 0, "no bf16 tensor-core K7 kernel in the library")
    for kname, fn in tc.items():
        check(any("HMMA" in x or "HGMMA" in x for x in fn["sass"]),
              f"{kname} issues no HMMA/HGMMA")
    _, tc80 = pick(tc, f"Li{(dh + 15) // 16 * 16}E")
    n_hgmma = sum("HGMMA" in x for x in tc80["sass"])
    n_hmma = sum("HMMA" in x for x in tc80["sass"]) - n_hgmma
    design = "wgmma (HGMMA)" if n_hgmma else "mma.sync (HMMA)"
    _, f32 = pick(code, "sparse_attn_kernelIf",
                  f"Li{(dh + 15) // 16}E")
    print(f"[K7] bf16 design: {design}, {n_hmma} HMMA and {n_hgmma} HGMMA "
          f"in the dh-{dh} instance ({resources(tc80)}); "
          f"{flops / (times['k7'] * 1e-3) / 1e12!r} TFLOP/s achieved "
          f"({flops} FLOP in {times['k7']!r} ms); bf16 instances "
          f"{sorted(f.get('regs', 0) for f in tc.values())} registers, "
          f"max local {max(f.get('local', 0) for f in tc.values())} B; "
          f"float32 dh-{dh} instance {resources(f32)}")
    kernels = [{"name": "sparse_attn", "route": "cuda",
                "source": "src/repro_torch/csrc/sparse_attn.cu",
                "replaces": "src/repro/kernels/sparse_attn.py:31",
                "launches": launches["sparse_attn"], "max_abs_err": k7_err,
                "ms": times["k7"], "plain_ms": times["k7_plain"],
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": times["k7_library_sdpa"], "match": True}]
    return {"launches": launches, "kernels": kernels, "times": times,
            "shapes": {"S": S, "H": H, "dh": dh, "allowed_pairs": pairs,
                       "flop": flops, "bytes": nbytes, "design": design,
                       "k7_rel_rms": k7_rms, "f32_err": f32_err,
                       "big_err": big_err, "sdpa_vs_plain_err": lib_err,
                       "sdpa_vs_plain_rel_rms": lib_rms}}


# the dynamic service at the repo's full-scale churn setting
# (benchmarks/ddm_dynamic.py:120-123): 1e6 regions at alpha = 5 made from
# seed 2, a per-query cap floor of 8192, ticks of 10,000 moves and 64
# query boxes drawn from a generator of their own (seed + 100) by the
# harness's laws (src/repro/serve/harness.py:36-45,75); the same at d = 2
# with 1e5 regions.  One tick at d = 1 (each is 47-61 s of host work on
# the ledger on an NVIDIA H100 80GB HBM3 host at 700 W, PERF.md), three at
# d = 2.
DYN = dict(seed=2, n_total=1_000_000, alpha=5.0, cap=8192, moves=10_000,
           ticks=1, boxes=64, d2_n_total=100_000, d2_ticks=3)
# the harness's space, its move law (lo uniform on [0, 0.9 space), width
# uniform on [1, 5e3)) and its query boxes (width 5e3)
SPACE = 1.0e6
MOVE_WIDTH = (1.0, 5e3)
BOX_WIDTH = 5e3
# operations a K8 node visit takes: two loads and compares to prune,
# three more to hit, the pushes and the loop (csrc/itm_walk.cu)
K8_OPS_PER_VISIT = 20
# K8 at serving's batch: the serving setting's 64 boxes on its snapshot's
# tree, at its per-query cap floor
K8_BATCH = 64
K8_BATCH_CAP = 8192
# the L2 pointer chase behind K8's depth floor: a random cycle, one index
# every 128-byte line of 4 MB (more than an SM's L1, less than the L2)
CHASE = dict(nbytes=4 << 20, stride=32, steps=200_000)


def k8_regimes(tree, q_lo, q_hi, want: dict, what: str) -> int:
    """K8 forced into each regime on the same inputs against the plain
    walk's ``want`` = {cap: (ids, counts)} (cap 0: the count instance,
    ids unused): the largest error, which must be 0.  These launches
    compare the kernel with its plain version; no counted path runs."""
    from repro_torch.kernels import itm as k8
    err = 0
    for regime in k8.REGIMES:
        for cap, (ids_w, cnt_w) in want.items():
            ids, cnt = k8.itm_walk(tree, q_lo, q_hi, cap, _regime=regime)
            e = exact_err(cnt, cnt_w)
            if cap:
                e = max(e, exact_err(ids, ids_w))
            check(e == 0, f"K8 in the {regime} regime (cap {cap}) at {what} "
                  f"!= the plain walk (max err {e})")
            err = max(err, e)
            del ids, cnt
    return err


def l2_latency_ns() -> float:
    """The card's L2 hit latency, ns: one thread's dependent reads
    (``ld.global.cg``, past L1) of a random cycle
    (``itm_walk_chase_launch``), the median CUDA-event time of REPS warm
    launches over its steps."""
    import torch
    from repro_torch.kernels import _build
    lib = _build.load("itm_walk")
    nodes = CHASE["nbytes"] // 4 // CHASE["stride"]
    at = torch.randperm(nodes, generator=torch.Generator().manual_seed(0))
    at = at * CHASE["stride"]
    nxt = torch.zeros(CHASE["nbytes"] // 4, dtype=torch.int32)
    nxt[at] = torch.roll(at, -1).to(torch.int32)   # one cycle through 0
    nxt = nxt.cuda()
    out = torch.empty(1, dtype=torch.int32, device="cuda")
    ms = time_ms(raw_launch(lib.itm_walk_chase_launch, nxt.data_ptr(),
                            CHASE["steps"], out.data_ptr()))
    return ms * 1e6 / CHASE["steps"]


def run_slice4(dev: str, fig9: dict, koln_positions: int, dyn: dict,
               expect_k: dict | None) -> dict:
    """Phases 18-20 on ``dev``: the interval tree through K8, the dynamic
    service, and their times.  Returns launches, the K8 record and times.
    """
    import numpy as np
    import torch
    from repro_torch.core import (DDMService, MatchSpec, build_plan, itm,
                                  koln_like_workload, make_regions,
                                  paper_workload, sbm)
    from repro_torch.kernels import itm as k8
    from repro_torch.kernels import ref

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    def keys(buf, m):
        return torch.sort(buf[:, 0].long() * m + buf[:, 1].long()).values

    # -- 18. itm: count() and pairs() through K8 ---------------------------
    S, U = paper_workload(**fig9, device=dev)
    n, m = S.n, U.n
    k_sbm = sbm.sbm_count_binary(S, U)
    tree = itm.build_tree(S)
    u_lo, u_hi = U.lo[:, 0], U.hi[:, 0]
    _, c_kernel = k8.itm_walk(tree, u_lo, u_hi)
    _, c_plain, visits = itm._lockstep(tree, u_lo, u_hi)
    k8_err = exact_err(c_kernel, c_plain)
    check(k8_err == 0, f"K8 counts != plain walk (max err {k8_err})")
    n_visits = int(visits.sum(dtype=torch.int64))
    steps = int(visits.max())
    per_q = int(c_kernel.max())
    ids_k, cnt_k = k8.itm_walk(tree, u_lo, u_hi, per_q)
    ids_p, cnt_p = ref.itm_walk(tree, u_lo, u_hi, per_q)
    check(torch.equal(ids_k, ids_p) and torch.equal(cnt_k, cnt_p),
          f"K8 pairs instance != plain walk (err {exact_err(ids_k, ids_p)})")
    k8_err = max(k8_err, k8_regimes(tree, u_lo, u_hi,
                                    {0: (None, c_plain),
                                     per_q: (ids_p, cnt_p)}, "fig9"))
    del ids_k, ids_p, cnt_k, cnt_p
    print(f"[K8] fig9 b={m} tree {tree.lo.numel()} nodes: counts and the "
          f"(b, {per_q}) ids bit-equal to the plain walk, through the rule "
          f"and in both regimes; {n_visits} node visits, {steps} lock-step "
          f"steps")

    k8.itm_walk.launches = 0
    plan = build_plan(MatchSpec(algo="itm", device=dev), n, m, 1)
    k_count = plan.count(S, U)
    res, k_pairs = plan.pairs(S, U)
    sync()
    launches = {"itm_walk": k8.itm_walk.launches}
    check(k_count == k_pairs == k_sbm,
          f"itm K count={k_count} pairs={k_pairs} != sbm {k_sbm}")
    if expect_k is not None:
        check(k_count == expect_k["fig9"], f"itm K {k_count}")
    plan_t = build_plan(MatchSpec(algo="itm", backend="torch", device=dev),
                        n, m, 1)
    res_t, k_t = plan_t.pairs(S, U)
    check(k_t == k_pairs and torch.equal(res.data, res_t.data),
          "itm pairs: cuda backend != torch backend")
    del res_t
    plan_s = build_plan(MatchSpec(algo="sbm", device=dev), n, m, 1)
    res_s, _ = plan_s.pairs(S, U)
    check(torch.equal(keys(res.data, m), keys(res_s.data, m)),
          "itm pairs sorted != sbm pairs sorted")
    del res_s
    print(f"[itm] fig9 count()={k_count} pairs() K={k_pairs} == sbm; "
          f"buffer == torch backend; launches={launches}")

    SK, UK = koln_like_workload(0, n_positions=koln_positions, device=dev)
    before = k8.itm_walk.launches
    plan_k = build_plan(MatchSpec(algo="itm", device=dev), SK.n, UK.n, 1)
    k_koln = plan_k.count(SK, UK)
    koln_launches = k8.itm_walk.launches - before
    k_koln_sbm = sbm.sbm_count_binary(SK, UK)
    check(k_koln == k_koln_sbm, f"itm Koln K {k_koln} != sbm {k_koln_sbm}")
    if expect_k is not None:
        check(k_koln == expect_k["koln"], f"itm Koln K {k_koln}")
    koln_ms = time_ms(lambda: plan_k.count(SK, UK))
    # K8 at Koln's count, in both regimes, against the plain walk: the
    # tree on the smaller set, as count() builds it
    TK, QK = (SK, UK) if SK.n <= UK.n else (UK, SK)
    tree_k = itm.build_tree(TK)
    t0 = time.perf_counter()
    koln_plain = ref.itm_walk(tree_k, QK.lo[:, 0], QK.hi[:, 0])[1]
    sync()
    koln_plain_s = time.perf_counter() - t0
    check(int(koln_plain.sum(dtype=torch.int64)) == k_koln,
          "the plain walk's Koln K != count()'s")
    k8_err = max(k8_err, k8_regimes(tree_k, QK.lo[:, 0], QK.hi[:, 0],
                                    {0: (None, koln_plain)}, "koln"))
    print(f"[itm] koln N={SK.n + UK.n} K={k_koln} == sbm; K8 launches="
          f"{koln_launches}; count() {koln_ms!r} ms; K8's {QK.n} counts "
          f"in both regimes == the plain walk ({koln_plain_s!r} s)")
    del tree_k, koln_plain

    S2, U2 = paper_workload(**fig9, d=2, device=dev)
    got2 = {}
    for algo in ("itm", "sbm"):
        r2, k2 = build_plan(MatchSpec(algo=algo, device=dev), S2.n, U2.n,
                            2).pairs(S2, U2)
        got2[algo] = (k2, keys(r2.data, U2.n))
    check(got2["itm"][0] == got2["sbm"][0]
          and torch.equal(got2["itm"][1], got2["sbm"][1]),
          "itm d=2 pairs != sbm pairs as sets")
    if expect_k is not None:
        check(got2["itm"][0] == expect_k["fig9_d2"], "itm d=2 K")
    print(f"[itm] fig9 d=2 K={got2['itm'][0]} set-equal to sbm")
    del S2, U2, got2, SK, UK, plan_k

    # -- 19. the dynamic service ----------------------------------------------
    dyn_launches = {}
    dyn_times = {}
    for d, n_total, n_ticks in ((1, dyn["n_total"], dyn["ticks"]),
                                (2, dyn["d2_n_total"], dyn["d2_ticks"])):
        DS, DU = paper_workload(seed=dyn["seed"], n_total=n_total,
                                alpha=dyn["alpha"], d=d, device=dev)
        spec = MatchSpec(algo="itm", capacity="grow", max_pairs=dyn["cap"],
                         device=dev)
        k8.itm_walk.launches = 0
        svc = DDMService(DS, DU, cap_hint=dyn["cap"], spec=spec)
        t0 = time.perf_counter()
        svc.connect()
        t_connect = (time.perf_counter() - t0) * 1e3
        k0 = len(svc.pairs)
        rng = np.random.default_rng(dyn["seed"] + 100)
        ticks = []
        for tick in range(n_ticks):
            kind = "sub" if tick % 2 == 0 else "upd"
            nk = svc.s_lo.shape[0] if kind == "sub" else svc.u_lo.shape[0]
            idx = rng.choice(nk, dyn["moves"], replace=False)
            lo = rng.uniform(0.0, 0.9 * SPACE,
                             (dyn["moves"], d)).astype(np.float32)
            hi = lo + rng.uniform(*MOVE_WIDTH,
                                  (dyn["moves"], d)).astype(np.float32)
            t0 = time.perf_counter()
            svc.update_regions(kind, idx, lo, hi)
            ticks.append((time.perf_counter() - t0) * 1e3)
        # the device side of a tick: its one batched query of 2 x moves
        # boxes (K8 twice, the hit selection, the hits to the host)
        t0 = time.perf_counter()
        svc._overlap_hits(kind, np.concatenate([lo, lo]),
                          np.concatenate([hi, hi]))
        t_query = (time.perf_counter() - t0) * 1e3
        sync()
        dyn_launches[d] = k8.itm_walk.launches
        check(dev != "cuda" or dyn_launches[d] > 0,
              f"the d={d} service launched no K8")
        if d == 2:
            # that query's dim-0 walk in both regimes against the plain one
            tree_q = svc.tree_U() if kind == "sub" else svc.tree_S()
            ql = torch.from_numpy(np.concatenate([lo, lo])[:, 0]).to(dev)
            qh = torch.from_numpy(np.concatenate([hi, hi])[:, 0]).to(dev)
            c_q = ref.itm_walk(tree_q, ql, qh)[1]
            cap_q = max(int(c_q.max()), 1)
            k8_err = max(k8_err, k8_regimes(
                tree_q, ql, qh, {0: (None, c_q),
                                 cap_q: ref.itm_walk(tree_q, ql, qh, cap_q)},
                "the d=2 service's query"))
            print(f"[K8] the d=2 service's query of {ql.numel()} boxes (cap "
                  f"{cap_q}): both regimes == the plain walk")
            del tree_q, c_q
        Sn = make_regions(svc.s_lo, svc.s_hi, dev)
        Un = make_regions(svc.u_lo, svc.u_hi, dev)
        res_n, k_n = build_plan(MatchSpec(algo="sbm", device=dev), Sn.n,
                                Un.n, d).pairs(Sn, Un)
        mm = Un.n
        ledger = np.fromiter((s * mm + u for s, u in svc.pairs),
                             dtype=np.int64, count=len(svc.pairs))
        check(len(svc.pairs) == k_n and np.array_equal(
            np.sort(ledger), keys(res_n.data, mm).cpu().numpy()),
            f"d={d} ledger ({len(svc.pairs)}) != from-scratch sbm ({k_n})")
        del res_n, ledger
        snap = svc.snapshot()
        blo = rng.uniform(0.0, SPACE - BOX_WIDTH,
                          (dyn["boxes"], d)).astype(np.float32)
        bhi = (blo + BOX_WIDTH).astype(np.float32)
        n_hits = 0
        for kind in ("sub", "upd"):
            ids, cnt = svc.query_snapshot(snap, kind, blo, bhi)
            ids = ids.cpu()
            for i in range(dyn["boxes"]):
                row = ids[i]
                got = set(row[row >= 0].tolist())
                check(got == snap.oracle_ids(kind, blo[i], bhi[i]),
                      f"d={d} snapshot box {i} ({kind}) != oracle")
                n_hits += len(got)
        dyn_times[f"d{d}_connect"] = t_connect
        dyn_times[f"d{d}_tick_median"] = statistics.median(ticks)
        dyn_times[f"d{d}_tick_query"] = t_query
        print(f"[dynamic] d={d} N={n_total}: connect() {t_connect!r} ms "
              f"(K={k0}), ticks of {dyn['moves']} moves {ticks!r} ms "
              f"(the query of one {t_query!r}), "
              f"ledger == from-scratch sbm (K={k_n}), "
              f"{2 * dyn['boxes']} snapshot boxes == oracle ({n_hits} ids), "
              f"K8 launches={dyn_launches[d]}")
        del svc, snap, DS, DU, Sn, Un

    # -- 20. times ------------------------------------------------------------
    plan_sbm = build_plan(MatchSpec(algo="sbm", device=dev), n, m, 1)
    times = {
        "k8": time_ms(lambda: k8.itm_walk(tree, u_lo, u_hi)),
        "k8_plain": time_ms(lambda: ref.itm_walk(tree, u_lo, u_hi)),
        "k8_pairs": time_ms(lambda: k8.itm_walk(tree, u_lo, u_hi, per_q)),
        "itm_build_tree": time_ms(lambda: itm.build_tree(S)),
        "itm_count_e2e": time_ms(lambda: plan.count(S, U)),
        "itm_count_koln_e2e": koln_ms,
        "itm_pairs_e2e": time_ms(lambda: plan.pairs(S, U)),
        "sbm_count_e2e": time_ms(lambda: plan_sbm.count(S, U)),
        "sbm_pairs_e2e": time_ms(lambda: plan_sbm.pairs(S, U)),
        **dyn_times,
    }
    # K8: the tree read once, 8 B a query in and 4 B a count out; about
    # K8_OPS_PER_VISIT operations for each node this run's walks visit
    tree_bytes = 4 * 5 * tree.lo.numel()
    k8_bound = bound_ms(tree_bytes + 12 * m, K8_OPS_PER_VISIT * n_visits)
    k8_pairs_bound = bound_ms(tree_bytes + 12 * m + 4 * m * per_q,
                              K8_OPS_PER_VISIT * n_visits)
    if dev == "cuda":
        from repro_torch.kernels import _build
        from repro_torch.serve import harness
        lib = _build.load("itm_walk")
        cnt_buf = torch.empty(m, dtype=torch.int32, device=dev)
        ids_buf = torch.full((m, per_q), -1, dtype=torch.int32, device=dev)
        order = k8.query_order(u_lo)
        walk = (tree.lo.data_ptr(), tree.hi.data_ptr(),
                tree.minlower.data_ptr(), tree.maxupper.data_ptr(),
                tree.ids.data_ptr(), tree.lo.numel() - 1, u_lo.data_ptr(),
                u_hi.data_ptr(), u_lo.stride(0), order.data_ptr(), m)
        # alone: the launch without the wrapper's sort and buffers, in the
        # rule's regime at this b (the thread regime: 20 back-to-back
        # launches) and in the other one (the CTA regime, a launch a time)
        times["k8_alone"] = time_back_to_back(raw_launch(
            lib.itm_walk_launch, *walk, 0, None, cnt_buf.data_ptr(), 0))
        check(torch.equal(cnt_buf, c_plain), "K8 alone != plain")
        times["k8_pairs_alone"] = time_back_to_back(raw_launch(
            lib.itm_walk_launch, *walk, per_q, ids_buf.data_ptr(),
            cnt_buf.data_ptr(), 0))
        times["k8_cta_alone"] = time_ms(raw_launch(
            lib.itm_walk_launch, *walk, 0, None, cnt_buf.data_ptr(), 1))
        times["k8_pairs_cta_alone"] = time_ms(raw_launch(
            lib.itm_walk_launch, *walk, per_q, ids_buf.data_ptr(),
            cnt_buf.data_ptr(), 1))
        check(torch.equal(cnt_buf, c_plain), "K8 alone (CTA regime) != plain")
        times["k8_order_argsort"] = time_ms(lambda: k8.query_order(u_lo))
        del ids_buf

        # serving's batch: 64 boxes on the 1e6-region setting's tree (phase
        # 22's), alone in each regime, each checked against the plain walk
        QS, _ = paper_workload(seed=dyn["seed"], n_total=dyn["n_total"],
                               alpha=dyn["alpha"], device=dev)
        tree_b = itm.build_tree(QS)
        blo, bhi = harness.make_query_boxes(
            np.random.default_rng(dyn["seed"] + 100), K8_BATCH, 1)
        b_lo = torch.from_numpy(blo[:, 0]).to(dev)
        b_hi = torch.from_numpy(bhi[:, 0]).to(dev)
        _, b_plain, b_visits = itm._lockstep(tree_b, b_lo, b_hi)
        b_ids_plain, _ = ref.itm_walk(tree_b, b_lo, b_hi, K8_BATCH_CAP)
        b_cnt = torch.empty(K8_BATCH, dtype=torch.int32, device=dev)
        b_ids = torch.full((K8_BATCH, K8_BATCH_CAP), -1, dtype=torch.int32,
                           device=dev)
        b_order = k8.query_order(b_lo)
        bwalk = (tree_b.lo.data_ptr(), tree_b.hi.data_ptr(),
                 tree_b.minlower.data_ptr(), tree_b.maxupper.data_ptr(),
                 tree_b.ids.data_ptr(), tree_b.lo.numel() - 1,
                 b_lo.data_ptr(), b_hi.data_ptr(), 1, b_order.data_ptr(),
                 K8_BATCH)
        for regime, per_cta in (("cta", 1), ("thread", 0)):
            times[f"k8_b64_{regime}_alone"] = time_back_to_back(raw_launch(
                lib.itm_walk_launch, *bwalk, 0, None, b_cnt.data_ptr(),
                per_cta))
            check(torch.equal(b_cnt, b_plain), f"K8 b=64 {regime} != plain")
            times[f"k8_b64_pairs_{regime}_alone"] = time_back_to_back(
                raw_launch(lib.itm_walk_launch, *bwalk, K8_BATCH_CAP,
                           b_ids.data_ptr(), b_cnt.data_ptr(), per_cta))
            check(torch.equal(b_ids, b_ids_plain),
                  f"K8 b=64 pairs {regime} != plain")
        times["k8_b64"] = time_ms(lambda: k8.itm_walk(tree_b, b_lo, b_hi))
        times["k8_b64_pairs"] = time_ms(lambda: k8.itm_walk(
            tree_b, b_lo, b_hi, K8_BATCH_CAP))
        times["k8_b64_plain"] = time_ms(lambda: ref.itm_walk(tree_b, b_lo,
                                                             b_hi), reps=1)
        b_visits_n = int(b_visits.sum(dtype=torch.int64))
        b_nodes, b_walked = k8_nodes_visited(tree_b, b_lo, b_hi)
        check(b_walked == b_visits_n, "the level walk's visits at b=64 != "
              "the plain walk's")
        b_bytes = 4 * 5 * b_nodes + 12 * K8_BATCH
        k8_b64_bound = bound_ms(b_bytes, K8_OPS_PER_VISIT * b_visits_n)
        k8_b64_pairs_bound = bound_ms(
            b_bytes + 4 * K8_BATCH * K8_BATCH_CAP,
            K8_OPS_PER_VISIT * b_visits_n)
        l2_ns = l2_latency_ns()
        h_b = tree_b.height
        times["l2_hit_latency"] = l2_ns * 1e-6
        times["k8_b64_depth_floor"] = h_b * l2_ns * 1e-6
        times["k8_b64_bound"] = k8_b64_bound[0]
        times["k8_b64_pairs_bound"] = k8_b64_pairs_bound[0]
        del b_ids, b_ids_plain, tree_b, QS

        code = kernel_code("itm_walk")
        picks = {f"{name} {inst}": pick(code, f"{name}ILb{i}")[1]
                 for name in ("walk_per_thread", "walk_per_cta")
                 for i, inst in enumerate(("count", "pairs"))}
        print(f"[K8] fig9 b={m} ({n_visits} visits, {steps} steps): count "
              f"instance {times['k8']!r} ms through the wrapper, "
              f"{times['k8_alone']!r} alone (the "
              f"order's argsort {times['k8_order_argsort']!r}); pairs "
              f"instance (cap {per_q}) {times['k8_pairs']!r} / "
              f"{times['k8_pairs_alone']!r} alone; forced into the CTA "
              f"regime, alone: count {times['k8_cta_alone']!r}, pairs "
              f"{times['k8_pairs_cta_alone']!r}; plain "
              f"walk {times['k8_plain']!r}; bound {k8_bound[0]!r} "
              f"({k8_bound[1]}), pairs {k8_pairs_bound[0]!r} "
              f"({k8_pairs_bound[1]}); {n_visits / (times['k8_alone'] * 1e-3)!r}"
              f" visits/s alone")
        print(f"[K8] b={K8_BATCH} on the {dyn['n_total']}-region "
              f"setting's tree (h={h_b}; {b_visits_n} visits of {b_nodes} "
              f"distinct nodes; {int(b_plain.sum())} hits, the most "
              f"{int(b_plain.max())}): count instance {times['k8_b64']!r} ms "
              f"through the wrapper, {times['k8_b64_cta_alone']!r} alone "
              f"(thread regime {times['k8_b64_thread_alone']!r}); pairs "
              f"instance (cap {K8_BATCH_CAP}) {times['k8_b64_pairs']!r} / "
              f"{times['k8_b64_pairs_cta_alone']!r} alone (thread regime "
              f"{times['k8_b64_pairs_thread_alone']!r}); plain walk "
              f"{times['k8_b64_plain']!r}; bound {k8_b64_bound[0]!r} "
              f"({k8_b64_bound[1]}), pairs {k8_b64_pairs_bound[0]!r} "
              f"({k8_b64_pairs_bound[1]}); depth floor "
              f"{times['k8_b64_depth_floor']!r} ms ({h_b} levels x the L2 "
              f"hit latency {l2_ns!r} ns, pointer chase)")
        print("[K8] " + "; ".join(
            f"{name}: {resources(f)}, static shared "
            f"{f.get('shared', 'not read')} B" for name, f in picks.items()))
    print(f"[itm] fig9 count() {times['itm_count_e2e']!r} ms, pairs() "
          f"{times['itm_pairs_e2e']!r} ms; sbm count() "
          f"{times['sbm_count_e2e']!r}, pairs() {times['sbm_pairs_e2e']!r}")
    kernels = [{"name": "itm_walk", "route": "cuda",
                "source": "src/repro_torch/csrc/itm_walk.cu",
                "replaces": "src/repro/core/itm.py:113",
                "launches": launches["itm_walk"], "max_abs_err": k8_err,
                "ms": times["k8"], "plain_ms": times["k8_plain"],
                "bound_ms": k8_bound[0], "bound_by": k8_bound[1],
                "library_ms": None, "match": True}]
    return {"launches": {**launches, "itm_walk (koln)": koln_launches,
                         **{f"itm_walk (dynamic d={d})": v
                            for d, v in dyn_launches.items()}},
            "kernels": kernels, "times": times,
            "shapes": {"queries": m, "tree_nodes": tree.lo.numel(),
                       "visits": n_visits, "steps": steps, "per_q": per_q,
                       "K": k_count}}


# the serving harness at the repo's full-scale churn setting
# (benchmarks/ddm_dynamic.py:120-123): one tenant of 1e6 regions at d = 1,
# three ticks (one warm-up) of 10,000 moves and 64 queries in batches of
# 64, a per-query cap floor of 8192, seed 2
SERVE = dict(tenants=1, n_total=1_000_000, ticks=3, warmup=1,
             moves_per_tick=10_000, queries_per_tick=64, max_batch=64,
             cap_hint=8192, seed=2, d_cycle=(1,))
# K2's slots on Koln's hybrid tables: the first 2^26 slots of its buffer
KOLN_K2_SLOTS = 1 << 26


def k2_hybrid_bytes(offs, counts, starts, n_a: int, slots: int) -> int:
    """Bytes K2 must move to fill the first ``slots`` slots from the
    hybrid's tables (offsets saturated at ``slots``): the offset, count
    and start of each emitter whose offset falls below ``slots`` (and the
    offset after the last), the id-table rows those slots read, each row
    once (an emitter's own row and its partners' window, in the
    concatenated [class A ids; class B ids] space), and 8 B a slot
    written."""
    import torch
    e = counts.numel()
    used = int(torch.searchsorted(offs[:e], slots, side="left"))
    c = (offs[1:used + 1] - offs[:used]).long()
    idx = torch.arange(used, device=offs.device)
    lo = starts[:used].long() + torch.where(idx < n_a, n_a, 0)
    edges = torch.zeros(e + 1, dtype=torch.long, device=offs.device)
    edges.index_add_(0, lo, torch.ones_like(lo))
    edges.index_add_(0, lo + c, -torch.ones_like(lo))
    rows = torch.cumsum(edges[:e], 0) > 0
    rows[:used] |= c > 0
    return 4 * ((used + 1) + 2 * used + int(rows.sum())) + 8 * slots


def hsbm_count_split(plan, S, U, reps: int = REPS) -> dict:
    """The steps of one hsbm ``plan.count()`` (``MatchPlan._count_hsbm``)
    through the functions it calls, the card drained after each: median
    host-clock ms over ``reps`` runs after a warm-up of ``sbm.hsbm_inputs``
    ("inputs"), split into its NumPy geometry (``grid.hsbm_geometry``,
    timed inside the call, "numpy") and the rest ("copies": the bounds to
    the host, ``lb``/``width`` back), then ``sbm._hsbm_phase1`` ("pass1"),
    ``sbm._total`` ("sum"), their sum ("steps") and ``plan.count()``
    whole ("count"), which must return the steps' K."""
    import torch
    from repro_torch.core import grid, sbm
    geometry = grid.hsbm_geometry
    numpy_ms = []

    def timed_geometry(*args, **kwargs):
        t0 = time.perf_counter()
        g = geometry(*args, **kwargs)
        numpy_ms.append((time.perf_counter() - t0) * 1e3)
        return g

    names = ("inputs", "numpy", "copies", "pass1", "sum", "steps", "count")
    runs = []
    grid.hsbm_geometry = timed_geometry
    try:
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            first = len(numpy_ms)
            t = [time.perf_counter()]
            b, g, lb, width = sbm.hsbm_inputs(S, U, plan.spec.hsbm_ncells)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            counts = sbm._hsbm_phase1(*b, lb, width, max_pairs=1,
                                      **g.statics())[3]
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            k = sbm._total(counts)
            t.append(time.perf_counter())
            k_count = plan.count(S, U)
            t.append(time.perf_counter())
            check(k == k_count, f"hsbm count() {k_count} != its steps {k}")
            inputs, pass1, sum_ms, count = [(b_ - a_) * 1e3
                                            for a_, b_ in zip(t, t[1:])]
            geo = numpy_ms[first]
            runs.append((inputs, geo, inputs - geo, pass1, sum_ms,
                         inputs + pass1 + sum_ms, count))
    finally:
        grid.hsbm_geometry = geometry
    return {name: statistics.median(r[i] for r in runs[1:])
            for i, name in enumerate(names)}


def run_slice5(dev: str, fig9: dict, koln_positions: int, window: int,
               koln_window: int, expect_k: dict | None) -> dict:
    """Phase 21 on ``dev``: the hybrid grid+SBM (``algo="hsbm"``) through
    K2, K5 and K6 on its emitter-slot tables, at fig. 9 (every route, and
    d = 2) and Koln, and its times.  Returns launches and times."""
    import numpy as np
    import torch
    from repro_torch.core import (MatchSpec, build_plan, koln_like_workload,
                                  paper_workload, sbm)
    from repro_torch.kernels import emit, ops, ref

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    def keys(buf, m):
        buf = buf[buf[:, 0] >= 0]
        return torch.sort(buf[:, 0].long() * m + buf[:, 1].long()).values

    # -- 21. hsbm: count() and pairs() on every route ----------------------
    S, U = paper_workload(**fig9, device=dev)
    n, m = S.n, U.n
    res_s, k_sbm = build_plan(MatchSpec(algo="sbm", device=dev), n, m,
                              1).pairs(S, U)
    sbm_keys = keys(res_s.data, m)
    del res_s
    if expect_k is not None:
        check(k_sbm == expect_k["fig9"], f"fig9 sbm K {k_sbm}")
    plain_res, k_plain = build_plan(MatchSpec(algo="hsbm", backend="torch",
                                              device=dev), n, m,
                                    1).pairs(S, U)
    plain = plain_res.data
    check(k_plain == k_sbm, f"hsbm torch backend K {k_plain} != {k_sbm}")

    emit.twopass_emit.launches = 0
    emit.twopass_emit_streaming.launches = 0
    emit.csr_decode_window.launches = 0
    plan = build_plan(MatchSpec(algo="hsbm", device=dev), n, m, 1)
    k_count = plan.count(S, U)
    res, k_pairs = plan.pairs(S, U)
    route_auto = ops.last_emit_route()
    plan_st = build_plan(MatchSpec(algo="hsbm", emit_route="streaming",
                                   device=dev), n, m, 1)
    res_st, k_st = plan_st.pairs(S, U)
    plan_csr = build_plan(MatchSpec(algo="hsbm", emit_route="csr",
                                    device=dev), n, m, 1)
    view, k_csr = plan_csr.pairs(S, U)
    plain_h = plain.cpu().numpy()
    nwin = 0
    for w0, win in view.windows(chunk=window):
        check((win == plain_h[w0:w0 + win.shape[0]]).all(),
              f"hsbm csr window at {w0} != the plain pass 2")
        nwin += 1
    del plain_h
    sync()
    launches = {"twopass_emit (hsbm)": emit.twopass_emit.launches,
                "twopass_emit_streaming (hsbm)":
                    emit.twopass_emit_streaming.launches,
                "csr_decode_window (hsbm)": emit.csr_decode_window.launches}
    check(route_auto == "resident", f"hsbm auto took {route_auto}")
    check(k_count == k_pairs == k_st == k_csr == k_sbm,
          f"hsbm K count={k_count} pairs={k_pairs} streaming={k_st} "
          f"csr={k_csr} != sbm {k_sbm}")
    for name, buf in (("resident", res.data), ("streaming", res_st.data)):
        check(torch.equal(buf, plain), f"hsbm {name} != the plain pass 2")
        check(torch.equal(keys(buf, m), sbm_keys),
              f"hsbm {name} pairs sorted != sbm pairs sorted")
    del res_st, sbm_keys
    print(f"[hsbm] fig9 count()={k_count} pairs() K={k_pairs} == sbm; "
          f"auto route {route_auto}; resident (K2) and streaming (K5) "
          f"buffers == the plain pass 2 (torch backend) and, sorted, == "
          f"sbm; {nwin} csr windows of {window} (K6) == the plain pass 2; "
          f"csr nbytes={view.nbytes}; launches={launches}")

    S2, U2 = paper_workload(**fig9, d=2, device=dev)
    got2 = {}
    for algo in ("hsbm", "sbm"):
        r2, k2 = build_plan(MatchSpec(algo=algo, device=dev), S2.n, U2.n,
                            2).pairs(S2, U2)
        got2[algo] = (k2, keys(r2.data, U2.n))
    check(got2["hsbm"][0] == got2["sbm"][0]
          and torch.equal(got2["hsbm"][1], got2["sbm"][1]),
          "hsbm d=2 pairs != sbm pairs as sets")
    if expect_k is not None:
        check(got2["hsbm"][0] == expect_k["fig9_d2"], "hsbm d=2 K")
    print(f"[hsbm] fig9 d=2 K={got2['hsbm'][0]} set-equal to sbm")
    del S2, U2, got2

    # the hybrid tables at fig. 9, for the kernel checks and times
    b, g, lb, width = sbm.hsbm_inputs(S, U)
    n_a, n_b = g.n_emit_s, g.n_emit_u
    sid, uid, starts, counts, offs = sbm._hsbm_phase1(
        *b, lb, width, max_pairs=k_sbm, **g.statics())
    ps, pu = sid + n_a, uid + n_b
    emit_args = (offs, counts, starts, ps, pu)
    slots = emit.twopass_emit(*emit_args, max_pairs=k_sbm)
    k2_err = exact_err(slots, ref.twopass_emit(*emit_args, max_pairs=k_sbm))
    bl = emit.lane_pad(MatchSpec().block)
    tab = emit.pack_emitter_tables(offs, counts, starts, n=n_a, m=n_b,
                                   min_len=emit.stream_window(bl))
    k5_err = exact_err(
        emit.twopass_emit_streaming(tab, ps, pu, max_pairs=k_sbm, block=bl),
        ref.twopass_emit_streaming(tab, ps, pu, max_pairs=k_sbm))
    w_mid = k_sbm // 2
    k6_args = (tab, ps, pu, w_mid, min(window, k_sbm - w_mid))
    k6_err = exact_err(emit.csr_decode_window(*k6_args),
                       ref.csr_decode_window(*k6_args))
    remapped = emit.remap_slot_pairs(slots, sid, uid)
    check(k2_err == k5_err == k6_err == 0,
          f"on the hybrid tables K2/K5/K6 != plain (max err {k2_err}, "
          f"{k5_err}, {k6_err})")
    check(torch.equal(remapped, plain), "remapped K2 != the plain pass 2")
    del remapped, res
    print(f"[hsbm] {g}: E = {n_a + n_b} emitter rows "
          f"({(n_a + n_b) / (n + m)!r} x (n+m)); K2, K5 and K6 bit-equal "
          "to plain on the hybrid tables")

    # -- Koln: count() past 2^31, and csr at cap INT32_MAX ------------------
    SK, UK = koln_like_workload(0, n_positions=koln_positions, device=dev)
    k_koln_sbm = sbm.sbm_count_binary(SK, UK)
    plan_kc = build_plan(MatchSpec(algo="hsbm", device=dev), SK.n, UK.n, 1)
    k_koln = plan_kc.count(SK, UK)
    check(k_koln == k_koln_sbm, f"hsbm koln K {k_koln} != {k_koln_sbm}")
    if expect_k is not None:
        check(k_koln == expect_k["koln"], f"hsbm koln K {k_koln}")
    kb, kg, klb, kwidth = sbm.hsbm_inputs(SK, UK)
    ke = kg.n_emit_s + kg.n_emit_u
    check(ops.choose_emit_route(kg.n_emit_s, kg.n_emit_u) == "resident",
          f"koln hybrid tables ({ke} rows) do not take resident")
    before = emit.csr_decode_window.launches
    kview, kk = build_plan(MatchSpec(algo="hsbm", emit_route="csr",
                                     capacity="fixed", max_pairs=INT32_MAX,
                                     device=dev), SK.n, UK.n,
                           1).pairs(SK, UK)
    check(kk == k_koln and isinstance(kview, ops.HsbmCSRPairs),
          f"hsbm koln csr K {kk} / view {type(kview).__name__}")
    kt = sbm._hsbm_phase1(*kb, klb, kwidth, max_pairs=INT32_MAX,
                          **kg.statics())
    k_sid, k_uid, k_starts, k_counts, k_offs = kt
    koln_windows = (0, (1 << 30) + 12_345, INT32_MAX - koln_window)
    for w0 in koln_windows:
        got = kview.decode(w0, w0 + koln_window)
        plain_w = emit.remap_slot_pairs(
            ref.csr_decode_window(kview.tab, kview.perm_s, kview.perm_u, w0,
                                  koln_window), k_sid, k_uid)
        lookup = emit.remap_slot_pairs(
            sbm._twopass_window(k_offs, k_counts, k_starts, kview.perm_s,
                                kview.perm_u, w0, w0 + koln_window),
            k_sid, k_uid)
        check(torch.equal(got, plain_w), f"hsbm koln window at {w0} != plain")
        check(torch.equal(got, lookup),
              f"hsbm koln window at {w0} != uncompacted lookup")
        if expect_k is not None:
            check(bool((got >= 0).all()), f"pad rows below K at {w0}")
        s_i, u_i = got[:, 0].long(), got[:, 1].long()
        check(bool(((SK.lo[s_i, 0] < UK.hi[u_i, 0])
                    & (UK.lo[u_i, 0] < SK.hi[s_i, 0])).all()),
              f"hsbm koln window at {w0}: pairs that do not overlap")
    sync()
    launches["csr_decode_window (hsbm koln)"] = (
        emit.csr_decode_window.launches - before)
    del kt, kview, k_offs
    # K2 on Koln's hybrid tables, at their edge of the L2 budget: the first
    # KOLN_K2_SLOTS slots, against the plain version
    kp = sbm._hsbm_phase1(*kb, klb, kwidth, max_pairs=KOLN_K2_SLOTS,
                          **kg.statics())
    koln_args = (kp[4], kp[3], kp[2], kp[0] + kg.n_emit_s,
                 kp[1] + kg.n_emit_u)
    k2_koln_err = exact_err(
        emit.twopass_emit(*koln_args, max_pairs=KOLN_K2_SLOTS),
        ref.twopass_emit(*koln_args, max_pairs=KOLN_K2_SLOTS))
    check(k2_koln_err == 0, f"K2 on koln's hybrid tables != plain")
    print(f"[hsbm] koln N={SK.n + UK.n} count() K={k_koln} == sbm; {kg}: "
          f"E = {ke}, resident bytes "
          f"{ops.emit_route_bytes(kg.n_emit_s, kg.n_emit_u)['resident']}; "
          f"csr at cap {INT32_MAX}: K6 windows of {koln_window} at "
          f"{list(koln_windows)} == plain == uncompacted lookup; K2 on the "
          f"first {KOLN_K2_SLOTS} slots == plain")

    # -- times --------------------------------------------------------------
    plan_sbm = build_plan(MatchSpec(algo="sbm", device=dev), n, m, 1)
    times = {
        "hsbm_count_e2e": time_ms(lambda: plan.count(S, U)),
        "hsbm_pairs_e2e": time_ms(lambda: plan.pairs(S, U)),
        "sbm_count_e2e": time_ms(lambda: plan_sbm.count(S, U)),
        "sbm_pairs_e2e": time_ms(lambda: plan_sbm.pairs(S, U)),
        "hsbm_streaming_pairs_e2e": time_ms(lambda: plan_st.pairs(S, U)),
        "hsbm_csr_pairs_e2e": time_ms(lambda: plan_csr.pairs(S, U)),
        "hsbm_koln_count_e2e": time_ms(lambda: plan_kc.count(SK, UK)),
        "hsbm_pass1": time_ms(lambda: sbm._hsbm_phase1(
            *b, lb, width, max_pairs=k_sbm, **g.statics())),
        "hsbm_k2": time_ms(lambda: emit.twopass_emit(*emit_args,
                                                     max_pairs=k_sbm)),
        "hsbm_k5": time_ms(lambda: emit.twopass_emit_streaming(
            tab, ps, pu, max_pairs=k_sbm, block=bl)),
        "hsbm_k6_window": time_ms(lambda: emit.csr_decode_window(
            tab, ps, pu, 0, window)),
        "hsbm_k2_koln": time_ms(lambda: emit.twopass_emit(
            *koln_args, max_pairs=KOLN_K2_SLOTS)),
        "hsbm_remap": time_ms(lambda: emit.remap_slot_pairs(slots, sid,
                                                            uid)),
        "hsbm_plain_pass2": time_ms(lambda: sbm._hsbm_emit(
            *b, lb, width, max_pairs=k_sbm, **g.statics())),
    }
    # K2 on the hybrid tables: per slot a binary search of the E + 1
    # offsets at ~6 operations a step, plus ~12 more, as phase 8's K2
    # bound; the bytes are what this run's slots read and write
    e = n_a + n_b
    k2_bound = bound_ms(k2_hybrid_bytes(offs, counts, starts, n_a, k_sbm),
                        (6 * math.ceil(math.log2(e + 1)) + 12) * k_sbm)
    k2k_bound = bound_ms(
        k2_hybrid_bytes(kp[4], kp[3], kp[2], kg.n_emit_s, KOLN_K2_SLOTS),
        (6 * math.ceil(math.log2(ke + 1)) + 12) * KOLN_K2_SLOTS)
    print(f"[hsbm] fig9 bounds: K2 {k2_bound[0]!r} ({k2_bound[1]}), K2 on "
          f"koln's first {KOLN_K2_SLOTS} slots {k2k_bound[0]!r} "
          f"({k2k_bound[1]})")
    if dev == "cuda":
        for what, (p, R1, R2) in (("fig9", (plan, S, U)),
                                  ("koln", (plan_kc, SK, UK))):
            split = hsbm_count_split(p, R1, R2)
            times.update({f"hsbm_count_{what}_{k}": v
                          for k, v in split.items()})
            print(f"[hsbm] {what} count() step by step, median host ms of "
                  f"{REPS}: " + ", ".join(f"{k} {v!r}"
                                          for k, v in split.items()))
    del SK, UK, kp, koln_args, slots, plain, view
    return {"launches": launches, "times": times,
            "bounds": {"hsbm_k2": k2_bound[0], "hsbm_k2_koln": k2k_bound[0]},
            "shapes": {"geometry": repr(g), "E": n_a + n_b, "K": k_sbm,
                       "koln_geometry": repr(kg)}}


def run_slice6(dev: str, serve: dict, smoke_args: tuple = ()) -> dict:
    """Phases 22-23 on ``dev``: the serving harness at the repo's
    full-scale churn setting with the oracle and the steady-state guard
    on, then ``python -m repro_torch.serve --smoke`` in both drive modes
    as subprocesses.  Returns K8's launches and the serving numbers."""
    import os
    import numpy as np
    import torch
    from repro_torch.core import DDMService, MatchSpec, paper_workload
    from repro_torch.kernels import itm as k8
    from repro_torch.kernels import ref
    from repro_torch.serve import batching, harness

    # -- 22. serving at full scale -------------------------------------------
    k8.itm_walk.launches = 0
    k8.itm_walk.cta_launches = 0
    t0 = time.perf_counter()
    stats = harness.run_churn(**serve, warm_start=dev == "cuda", device=dev)
    wall = time.perf_counter() - t0
    if dev == "cuda":
        torch.cuda.synchronize()
    launches = {"itm_walk (serving)": k8.itm_walk.launches}
    cta_launches = k8.itm_walk.cta_launches
    check(stats["parity_checks"] > 0, "serving parity never exercised")
    c = stats["metrics"]["tenants"]["tenant0"]["counters"]
    numbers = {
        "serve_p50_query_us": stats["p50_query_s"] * 1e6,
        "serve_p99_query_us": stats["p99_query_s"] * 1e6,
        "serve_p99_stale_query_us": stats["p99_stale_query_s"] * 1e6,
        "serve_rebuild_p50_us": stats["rebuild_p50_s"] * 1e6,
        "serve_rebuild_p99_us": stats["rebuild_p99_s"] * 1e6,
    }
    print(f"[serve] N={serve['n_total']} ticks={serve['ticks']} (warm-up "
          f"{serve['warmup']}), {serve['moves_per_tick']} moves and "
          f"{serve['queries_per_tick']} queries a tick: every answer == its "
          f"snapshot's oracle ({stats['parity_checks']} parity checks), "
          f"steady-state guard quiet; " + ", ".join(
              f"{k} {v!r}" for k, v in numbers.items())
          + f"; counters {c}; K8 launches={launches['itm_walk (serving)']} "
          f"({cta_launches} in the CTA regime); wall {wall!r} s")
    if dev == "cuda":
        # one query batch at the same scale, step by step: the tenant's
        # first snapshot and one burst's boxes of each target, padded
        S, U = paper_workload(seed=serve["seed"], n_total=serve["n_total"],
                              alpha=5.0, device=dev)
        svc = DDMService(S, U, spec=MatchSpec(
            algo="itm", capacity="grow", max_pairs=serve["cap_hint"],
            device=dev))
        snap = svc.snapshot()
        rng = np.random.default_rng(serve["seed"] + 100)
        blo, bhi = harness.make_query_boxes(rng, serve["max_batch"], 1)
        q_lo = torch.from_numpy(blo).to(dev)
        q_hi = torch.from_numpy(bhi).to(dev)
        tree, opp = snap.target("sub")
        cap = serve["cap_hint"]
        ids, _ = svc.query_snapshot(snap, "sub", blo, bhi)
        hits = int((ids >= 0).sum())
        # the batch's walks in both regimes against the plain walk
        ql, qh = q_lo[:, 0], q_hi[:, 0]
        k8_regimes(tree, ql, qh, {0: (None, ref.itm_walk(tree, ql, qh)[1]),
                                  cap: ref.itm_walk(tree, ql, qh, cap)},
                   "serving's batch")
        print(f"[K8] serving's batch of {serve['max_batch']} boxes (cap "
              f"{cap}): both regimes == the plain walk")
        split = {
            "batch_query": time_ms(lambda: svc.query_snapshot(
                snap, "sub", blo, bhi)),
            "batch_k8_count": time_ms(lambda: k8.itm_walk(
                tree, q_lo[:, 0], q_hi[:, 0])),
            "batch_k8_pairs": time_ms(lambda: k8.itm_walk(
                tree, q_lo[:, 0], q_hi[:, 0], cap)),
            "batch_ids_to_host": time_ms(lambda: ids.cpu()),
            "batch_pad_boxes": time_ms(lambda: batching.pad_boxes(
                [], 1, serve["max_batch"])),
        }
        numbers.update({f"serve_{k}_us": v * 1e3 for k, v in split.items()})
        print(f"[serve] one batch of {serve['max_batch']} boxes on the "
              f"1e6-region snapshot ({hits} hits, cap {cap}), median ms of "
              f"{REPS}: " + ", ".join(f"{k} {v!r}" for k, v in split.items()))
        del svc, snap, S, U, ids

    # -- 23. the entry point, both drive modes --------------------------------
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for mode in ((), ("--threaded",)):
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.serve", "--smoke",
             *smoke_args, *mode], capture_output=True, text=True,
            timeout=600, env=env, cwd=ROOT)
        lines = out.stdout.strip().splitlines()
        check(out.returncode == 0 and lines and lines[-1] == "SERVE_SMOKE_OK",
              f"python -m repro_torch.serve --smoke {' '.join(mode)} exited "
              f"{out.returncode}:\n{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
        rec = json.loads(out.stdout[out.stdout.index("{"):
                                    out.stdout.rindex("}") + 1])
        print(f"[serve-smoke] {' '.join(mode) or '(pump)'}: exit 0, "
              f"SERVE_SMOKE_OK, {rec['parity_checks']} parity checks, p50 "
              f"{rec['p50_query_us']} us, p99 {rec['p99_query_us']} us, wall "
              f"{time.perf_counter() - t0!r} s")
    return {"launches": launches, "times": numbers}


HOST_CALLS = 2000


def host_us(fn, calls: int = HOST_CALLS, sync_every: int = 32) -> float:
    """Median host time of one ``fn()`` in µs over ``calls`` calls, each
    timed alone with ``time.perf_counter_ns``.  Nothing synchronises
    inside a timed call; every ``sync_every`` calls the card is drained
    outside the timed spans, so a call that enqueues work never waits on
    a full launch queue and the time is the host's alone."""
    import torch
    fn()
    torch.cuda.synchronize()
    ns = []
    for i in range(calls):
        t0 = time.perf_counter_ns()
        fn()
        ns.append(time.perf_counter_ns() - t0)
        if (i + 1) % sync_every == 0:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return statistics.median(ns) / 1e3


def host_phase(card: str | None = None) -> dict:
    """Phase 17: the host time of K1's, K2's and K6's wrappers at fig. 9,
    split into the steps of their call path (``host_us`` of each step,
    then of the whole wrapper call).  Builds its own fig. 9 inputs, so it
    also runs alone: ``python3 -c 'import chip_smoke as c;
    c.host_phase()'``."""
    import torch
    from repro_torch.core import MatchSpec, build_plan, paper_workload, sbm
    from repro_torch.kernels import _build, emit
    from repro_torch.kernels import sbm_sweep as sweep
    card = card or smi()
    dev = torch.device("cuda", torch.cuda.current_device())
    S, U = paper_workload(**FIG9, device="cuda")
    is_lo, is_upd = sbm._endpoint_stream(S.lo[:, 0], S.hi[:, 0],
                                         U.lo[:, 0], U.hi[:, 0])
    k = sbm.sbm_count_binary(S, U)
    perm_s, perm_u, starts, counts, offs = sbm._twopass_phase1(
        S.lo[:, 0], S.hi[:, 0], U.lo[:, 0], U.hi[:, 0], k)[:5]
    emit_args = (offs, counts, starts, perm_s, perm_u)
    n, m = perm_s.shape[0], perm_u.shape[0]
    view, _ = build_plan(MatchSpec(emit_route="csr", device="cuda"), n, m,
                         1).pairs(S, U)
    tab, w0, nsl = view.tab, 0, WINDOW
    T = is_lo.numel()

    def ctx():
        with torch.cuda.device(dev):
            pass

    common = {
        "torch.cuda.device(dev) enter+exit": ctx,
        "torch.cuda.current_device()": torch.cuda.current_device,
        "torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "torch.cuda.current_stream(index).cuda_stream":
            lambda: torch.cuda.current_stream(dev.index).cuda_stream,
        "x.data_ptr()": is_lo.data_ptr,
    }
    split = {"common": {name: host_us(fn) for name, fn in common.items()}}
    stream = torch.cuda.current_stream().cuda_stream

    lib1 = _build.load("sbm_sweep")
    sw = sweep.scratch_words(T, lib1.const["sbm_sweep_tile"])
    words = sw + T
    buf1 = torch.empty(words, dtype=torch.int32, device=dev)
    k1_args = (is_lo.data_ptr(), is_upd.data_ptr(), buf1.data_ptr() + 4 * sw,
               buf1.data_ptr(), T)
    split["K1"] = {name: host_us(fn) for name, fn in {
        "_check_flags": lambda: sweep._check_flags(is_lo, is_upd),
        "torch.empty(scratch + out)": lambda: torch.empty(
            words, dtype=torch.int32, device=dev),
        "_build.load": lambda: _build.load("sbm_sweep"),
        "lib.const[tile]": lambda: lib1.const["sbm_sweep_tile"],
        "the counts' view buf[sw:]": lambda: buf1[sw:],
        "raw ctypes launch (memset + kernel)":
            lambda: lib1.sbm_sweep_launch(*k1_args, stream),
        "_build.launch": lambda: _build.launch(dev, lib1.sbm_sweep_launch,
                                               *k1_args),
        "whole sbm_sweep": lambda: sweep.sbm_sweep(is_lo, is_upd),
    }.items()}
    # what an event-timed call sees: the host time of a call that follows
    # a synchronisation, the card idle
    split["K1"]["whole sbm_sweep, each call after a sync"] = host_us(
        lambda: sweep.sbm_sweep(is_lo, is_upd), sync_every=1)

    lib2 = _build.load("emit")
    out2 = torch.empty((k, 2), dtype=torch.int32, device=dev)
    k2_args = (*(x.data_ptr() for x in emit_args), n, m, k, out2.data_ptr())
    split["K2"] = {name: host_us(fn) for name, fn in {
        "_check_slots": lambda: emit._check_slots(k),
        "_check_tables": lambda: emit._check_tables(*emit_args),
        "torch.empty(out)": lambda: torch.empty((k, 2), dtype=torch.int32,
                                                device=dev),
        "_build.load": lambda: _build.load("emit"),
        "raw ctypes launch": lambda: lib2.twopass_emit_launch(*k2_args,
                                                              stream),
        "_build.launch": lambda: _build.launch(dev, lib2.twopass_emit_launch,
                                               *k2_args),
        "whole twopass_emit": lambda: emit.twopass_emit(*emit_args,
                                                        max_pairs=k),
    }.items()}
    del out2

    lib6 = _build.load("csr_decode")
    out6 = torch.empty((nsl, 2), dtype=torch.int32, device=dev)
    k6_args = (tab.data_ptr(), tab.shape[1], perm_s.data_ptr(),
               perm_u.data_ptr(), n, m, w0, nsl, out6.data_ptr())
    k6_call = (tab, perm_s, perm_u, w0, nsl)
    split["K6"] = {name: host_us(fn) for name, fn in {
        "_check_packed": lambda: emit._check_packed(tab, perm_s, perm_u),
        "torch.empty(out)": lambda: torch.empty((nsl, 2), dtype=torch.int32,
                                                device=dev),
        "_build.load": lambda: _build.load("csr_decode"),
        "raw ctypes launch": lambda: lib6.csr_decode_launch(*k6_args,
                                                            stream),
        "_build.launch": lambda: _build.launch(dev, lib6.csr_decode_launch,
                                               *k6_args),
        "whole csr_decode_window": lambda: emit.csr_decode_window(*k6_call),
    }.items()}
    shapes = {"K1": f"T={T}", "K2": f"K={k} E={n + m}",
              "K6": f"window of {nsl} slots"}
    for what, parts in split.items():
        body = ", ".join(f"{name} {us!r}" for name, us in parts.items())
        print(f"[host] {what} {shapes.get(what, '')}: median µs of "
              f"{HOST_CALLS} calls: {body}; on {card}")
    return split


# the distributed phase's query: 64 boxes of width BOX_WIDTH on the tree of
# the serving setting's update regions, from a generator of their own
DIST_BOXES = 64
# K1 on a carried segment: the middle third of fig. 9's sorted stream,
# cut on a 16-byte boundary (the vector instance) and one element past it
DIST_CUT = 3
# K2 on a chunk table: the emitters of rank 1 of 4
DIST_CHUNK = (1, 4)


def k8_nodes_visited(tree, q_lo, q_hi) -> tuple[int, int]:
    """``(distinct nodes, node visits)`` of the queries' walks, level by
    level: node c is visited when its parent p was, p is live for the
    query, c exists, and, for a right child, q_hi > lo[p]
    (``core.itm._lockstep``'s pushes)."""
    import torch
    M = tree.lo.numel() - 1
    seen = torch.ones((q_lo.numel(), 1), dtype=torch.bool,
                      device=q_lo.device)
    distinct, visits = 1, seen.numel()
    lo, hi = q_lo[:, None], q_hi[:, None]
    first = 1
    while 2 * first <= M:
        k = torch.arange(first, 2 * first, device=q_lo.device)
        live = seen & ~((tree.maxupper[k] <= lo) | (tree.minlower[k] >= hi))
        left = live & (2 * k <= M)
        right = left & (hi > tree.lo[k])
        seen = torch.stack([left, right], dim=2).reshape(seen.shape[0], -1)
        distinct += int(seen.any(dim=0).sum())
        visits += int(seen.sum())
        first *= 2
    return distinct, visits


def run_slice7(dev: str, fig9: dict, koln_positions: int, dyn: dict,
               expect_k: dict | None) -> dict:
    """Phase 24 on ``dev``: the distributed backend on a process group of
    world size 1 (NCCL on the card, gloo on the CPU), through K1, K2 and
    K8, against the ``cuda`` backend.  Returns launches, the three
    kernels' records on this path, and the times."""
    import datetime
    import tempfile
    import torch
    import torch.distributed as dist

    backend = "nccl" if dev == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        if dev == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                                world_size=1, rank=0,
                                timeout=datetime.timedelta(seconds=300))
        try:
            return _slice7_body(dev, fig9, koln_positions, dyn, expect_k,
                                backend)
        finally:
            dist.destroy_process_group()


def _slice7_body(dev: str, fig9: dict, koln_positions: int, dyn: dict,
                 expect_k: dict | None, backend: str) -> dict:
    import numpy as np
    import torch
    from repro_torch.core import (MatchSpec, build_plan, itm,
                                  koln_like_workload, paper_workload, sbm)
    from repro_torch.core import distributed as tdist
    from repro_torch.core.engine import MatchPlan
    from repro_torch.kernels import emit, ref
    from repro_torch.kernels import itm as k8
    from repro_torch.kernels import sbm_sweep as sweep

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    # -- 24. the distributed backend at P = 1 --------------------------------
    S, U = paper_workload(**fig9, device=dev)
    n, m = S.n, U.n
    SK, UK = koln_like_workload(0, n_positions=koln_positions, device=dev)
    S2, U2 = paper_workload(**fig9, d=2, device=dev)
    QS, QU = paper_workload(seed=dyn["seed"], n_total=dyn["n_total"],
                            alpha=dyn["alpha"], device=dev)
    tree = itm.build_tree(QU)
    rng = np.random.default_rng(dyn["seed"] + 200)
    blo = rng.uniform(0.0, SPACE - BOX_WIDTH,
                      (DIST_BOXES, 1)).astype(np.float32)
    q_lo = torch.from_numpy(blo).to(dev)
    q_hi = torch.from_numpy(blo + np.float32(BOX_WIDTH)).to(dev)
    spec = MatchSpec(backend="distributed", device=dev)
    dplan = build_plan(spec, n, m, 1)
    dplan_k = build_plan(spec, SK.n, UK.n, 1)
    dplan_2 = build_plan(spec, S2.n, U2.n, 2)
    qspec = dict(algo="itm", capacity="grow", max_pairs=dyn["cap"],
                 device=dev)
    dplan_q = MatchPlan(MatchSpec(backend="distributed", **qspec), QS.n,
                        QU.n, 1)
    sync()

    sweep.sbm_sweep.launches = 0
    emit.twopass_emit.launches = 0
    k8.itm_walk.launches = 0
    k_count = dplan.count(S, U)
    k_koln = dplan_k.count(SK, UK)
    res, k_pairs = dplan.pairs(S, U)
    res2, k2 = dplan_2.pairs(S2, U2)
    ids, cnt = dplan_q.query(tree, QU, q_lo, q_hi)
    sync()
    launches = {"sbm_sweep (distributed)": sweep.sbm_sweep.launches,
                "twopass_emit (distributed)": emit.twopass_emit.launches,
                "itm_walk (distributed)": k8.itm_walk.launches}
    print(f"[dist] {backend} world 1: count() fig9 {k_count}, Koln "
          f"{k_koln}; pairs() fig9 K={k_pairs} ({res!r}), d=2 K={k2}; "
          f"query() of {DIST_BOXES} boxes ({int(cnt.sum())} ids); "
          f"launches {launches}")
    for name, count in launches.items():
        check(dev != "cuda" or count > 0,
              f"the distributed path did not launch {name}")

    cplan = build_plan(MatchSpec(device=dev), n, m, 1)
    cplan_k = build_plan(MatchSpec(device=dev), SK.n, UK.n, 1)
    cplan_2 = build_plan(MatchSpec(device=dev), S2.n, U2.n, 2)
    cplan_q = MatchPlan(MatchSpec(**qspec), QS.n, QU.n, 1)
    want_k = cplan.count(S, U)
    want_koln = cplan_k.count(SK, UK)
    check(k_count == k_pairs == want_k,
          f"distributed K fig9 count={k_count} pairs={k_pairs} != {want_k}")
    check(k_koln == want_koln, f"distributed Koln K {k_koln} != {want_koln}")
    if expect_k is not None:
        check(k_count == expect_k["fig9"] and k_koln == expect_k["koln"]
              and k2 == expect_k["fig9_d2"], "distributed K")
    cres, _ = cplan.pairs(S, U)
    check(torch.equal(res.to_dense(), cres.data),
          "distributed pairs() fig9 != the cuda backend's buffer")
    cres2, ck2 = cplan_2.pairs(S2, U2)
    check(k2 == ck2 and torch.equal(res2.to_dense(), cres2.data),
          "distributed pairs() fig9 d=2 != the cuda backend's buffer")
    cids, ccnt = cplan_q.query(tree, QU, q_lo, q_hi)
    check(torch.equal(ids, cids) and torch.equal(cnt, ccnt),
          "distributed query() != the cuda backend's")
    print(f"[dist] K at fig9, Koln and fig9 d=2 == the cuda backend's; "
          f"both pairs() buffers and the query's ids and counts bit-equal")
    del cres, cres2, res, res2

    # K1 on the rank's segment (the path's input) and on carried segments
    tot = 2 * (n + m)
    seg_lo, seg_upd, _ = tdist._segment(
        S, U, nshards=1, me=0, cap=tdist.bucket_cap(tot, 1, 2.5), group=None)
    k1_err = exact_err(sweep.sbm_sweep(seg_lo, seg_upd),
                       ref.sbm_sweep(seg_lo, seg_upd))
    is_lo, is_upd = sbm._endpoint_stream(S.lo[:, 0], S.hi[:, 0], U.lo[:, 0],
                                         U.hi[:, 0])
    full = sweep.sbm_sweep(is_lo, is_upd).long()
    T = is_lo.numel()
    a0 = T // DIST_CUT // 4 * 4
    b0 = 2 * T // DIST_CUT
    for a in (a0, a0 + 1):
        c_lo, c_upd = is_lo[a:b0], is_upd[a:b0]
        got = sweep.sbm_sweep(c_lo, c_upd)
        want = ref.sbm_sweep(c_lo, c_upd)
        k1_err = max(k1_err, exact_err(got, want))
        sign = 2 * is_lo[:a].long() - 1
        cu = int((sign * is_upd[:a]).sum())
        cs = int(sign.sum()) - cu
        seeded = int(tdist.seeded_sweep(c_lo, c_upd, cu, cs))
        check(int(want.min()) < 0, "the carried segment has no negative "
              "active count")
        check(seeded == int(full[a:b0].sum()),
              f"seeded sweep of [{a}, {b0}) != the full sweep's sum")
    check(k1_err == 0, f"K1 on the distributed segments != plain "
          f"(max err {k1_err})")
    print(f"[K1] the rank's segment ({seg_lo.numel()} endpoints) and the "
          f"carried segments [{a0}, {b0}) and [{a0 + 1}, {b0}) (active "
          f"counts below 0, carries {cu}/{cs}) bit-equal to plain; seeded "
          f"sums == the full sweep's")

    # K2 on the rank's tables (P = 1) and on a chunk table of rank 1 of 4
    E = n + m
    p1, _, need = tdist._dist_pairs_pass1(S, U, overprovision=2.5,
                                          group=None)
    tabs = tdist.chunk_tables(p1, E, need)
    k2_args = (*tabs, p1.perm_s, p1.perm_u)
    k2_rows = emit.twopass_emit(*k2_args, max_pairs=need)
    k2_err = exact_err(k2_rows, ref.twopass_emit(*k2_args, max_pairs=need))
    me, P = DIST_CHUNK
    c0, c1 = tdist._chunk_bounds(E, P, me)
    chunk = tdist._chunk_ranges(S, U, p1.perm_s, p1.perm_u, c0, c1)
    need_c = int(chunk.cnt.sum(dtype=torch.int64))
    chunk_args = (*tdist.chunk_tables(chunk, E, need_c), p1.perm_s,
                  p1.perm_u)
    k2_err = max(k2_err, exact_err(
        emit.twopass_emit(*chunk_args, max_pairs=need_c),
        ref.twopass_emit(*chunk_args, max_pairs=need_c)))
    check(k2_err == 0, f"K2 on the distributed tables != plain "
          f"(max err {k2_err})")
    print(f"[K2] the rank's tables (cap_dev {need}) and rank {me} of {P}'s "
          f"chunk [{c0}, {c1}) ({need_c} slots, count 0 outside it) "
          f"bit-equal to plain")

    # K8 on the rank's rows
    rows = tdist._query_rows(q_lo, q_hi, group=None)
    lo0, hi0 = rows.lo[:, 0], rows.hi[:, 0]
    _, c_plain, visits = itm._lockstep(tree, lo0, hi0)
    k8_err = exact_err(k8.itm_walk(tree, lo0, hi0, order=rows.order)[1],
                       c_plain)
    check(k8_err == 0, f"K8 on the rank's rows != plain (max err {k8_err})")
    k8_err = max(k8_err, k8_regimes(
        tree, lo0, hi0, {0: (None, c_plain),
                         K8_BATCH_CAP: ref.itm_walk(tree, lo0, hi0,
                                                    K8_BATCH_CAP)},
        "the rank's rows"))
    n_visits = int(visits.sum(dtype=torch.int64))
    n_nodes, n_walked = k8_nodes_visited(tree, lo0, hi0)
    check(n_walked == n_visits, f"level walk {n_walked} visits != the "
          f"plain walk's {n_visits}")
    print(f"[K8] the rank's {lo0.numel()} rows on the {tree.lo.numel()}-"
          f"node tree: counts bit-equal to the plain walk ({n_visits} "
          f"visits of {n_nodes} distinct nodes)")

    times = {
        "dist_count_fig9": time_ms(lambda: dplan.count(S, U)),
        "cuda_count_fig9": time_ms(lambda: cplan.count(S, U)),
        "dist_count_koln": time_ms(lambda: dplan_k.count(SK, UK)),
        "cuda_count_koln": time_ms(lambda: cplan_k.count(SK, UK)),
        "dist_pairs_fig9": time_ms(lambda: dplan.pairs(S, U)),
        "cuda_pairs_fig9": time_ms(lambda: cplan.pairs(S, U)),
        "dist_pairs_fig9_d2": time_ms(lambda: dplan_2.pairs(S2, U2)),
        "cuda_pairs_fig9_d2": time_ms(lambda: cplan_2.pairs(S2, U2)),
        "dist_query": time_ms(lambda: dplan_q.query(tree, QU, q_lo, q_hi)),
        "cuda_query": time_ms(lambda: cplan_q.query(tree, QU, q_lo, q_hi)),
        "k1_dist": time_ms(lambda: sweep.sbm_sweep(seg_lo, seg_upd)),
        "k1_dist_plain": time_ms(lambda: ref.sbm_sweep(seg_lo, seg_upd)),
        "k2_dist": time_ms(lambda: emit.twopass_emit(*k2_args,
                                                     max_pairs=need)),
        "k2_dist_plain": time_ms(lambda: ref.twopass_emit(*k2_args,
                                                          max_pairs=need)),
        "k2_chunk": time_ms(lambda: emit.twopass_emit(*chunk_args,
                                                      max_pairs=need_c)),
        "k8_dist": time_ms(lambda: k8.itm_walk(tree, lo0, hi0,
                                               order=rows.order)),
        "k8_dist_plain": time_ms(lambda: ref.itm_walk(tree, lo0, hi0)),
        # the steps of one warm distributed count() and pairs() at fig. 9
        "dist_count_segment": time_ms(lambda: tdist._segment(
            S, U, nshards=1, me=0, cap=tdist.bucket_cap(tot, 1, 2.5),
            group=None)),
        "dist_pairs_pass1": time_ms(lambda: tdist._dist_pairs_pass1(
            S, U, overprovision=2.5, group=None)),
        "dist_pairs_emit": time_ms(lambda: tdist._dist_pairs_emit(
            p1, E, cap_dev=need)),
        "dist_pairs_gather": time_ms(lambda: tdist._all_gather(
            k2_rows, None)),
    }
    Ts = seg_lo.numel()
    k1_bound = bound_ms(12 * Ts, 12 * Ts)
    steps = math.ceil(math.log2(E + 1))
    k2_bound = bound_ms(4 * ((E + 1) + 2 * E + n + m) + 8 * need,
                        (6 * steps + 12) * need)
    # K8: the nodes the walks visit read once (five 4-byte fields), 8 B a
    # query in and 4 B a count out; K8_OPS_PER_VISIT operations a visit
    b = lo0.numel()
    k8_bound = bound_ms(4 * 5 * n_nodes + 12 * b,
                        K8_OPS_PER_VISIT * n_visits)
    print(f"[dist] bounds: K1 {k1_bound[0]!r} ({k1_bound[1]}), K2 "
          f"{k2_bound[0]!r} ({k2_bound[1]}), K8 {k8_bound[0]!r} "
          f"({k8_bound[1]})")

    def rec(name, src, replaces, err, key, bound):
        return {"name": f"{name} (distributed)", "route": "cuda",
                "source": src, "replaces": replaces,
                "launches": launches[f"{name} (distributed)"],
                "max_abs_err": err, "ms": times[key],
                "plain_ms": times[f"{key}_plain"], "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": None, "match": True}

    kernels = [
        rec("sbm_sweep", "src/repro_torch/csrc/sbm_sweep.cu",
            "src/repro/kernels/sbm_sweep.py:28", k1_err, "k1_dist",
            k1_bound),
        rec("twopass_emit", "src/repro_torch/csrc/emit.cu",
            "src/repro/kernels/emit.py:185", k2_err, "k2_dist", k2_bound),
        rec("itm_walk", "src/repro_torch/csrc/itm_walk.cu",
            "src/repro/core/itm.py:113", k8_err, "k8_dist", k8_bound),
    ]
    return {"launches": launches, "kernels": kernels, "times": times,
            "shapes": {"segment": Ts, "emitters": E, "cap_dev": need,
                       "chunk_slots": need_c, "rows": b,
                       "tree_nodes": tree.lo.numel(), "visits": n_visits,
                       "distinct_nodes": n_nodes,
                       "backend": backend}}


# every C entry point of K1-K8 the kernel matrix must launch
AUDIT_ENTRIES = ("sbm_sweep_launch", "twopass_emit_launch",
                 "bfm_tile_counts_launch", "bfm_mask_launch",
                 "emit_stream_launch", "csr_decode_launch",
                 "sparse_attn_launch", "itm_walk_launch")


def run_audit(card: str) -> dict:
    """Phase 25: the auditor and its corpus on the card; returns the
    wall time and the number of findings."""
    from repro_torch.analysis import run_all
    from repro_torch.analysis.corpus import corpus_summary, run_corpus
    t0 = time.perf_counter()
    report = run_all(root=ROOT, device="cuda")
    results = run_corpus(ROOT / "tests" / "torch_analysis_corpus",
                         device="cuda")
    wall = time.perf_counter() - t0
    print(report.summary())
    print(corpus_summary(results))
    limit = report.limits["smem_optin"]
    largest: dict = {}       # (lib, kernel name fragment) -> bytes
    for rec, geo in report.launches:
        if geo is not None:
            key = (rec.lib, geo["kernel"])
            largest[key] = max(largest.get(key, 0), geo["smem"])
    for lib, funcs in sorted(report.resources.items()):
        for name, fn in sorted(funcs.items()):
            dyn = [v for (lib_, kernel), v in largest.items()
                   if lib_ == lib and kernel in name]
            print(f"[audit] {lib}:{name}: {resources(fn)}, static shared "
                  f"{fn.get('shared', 'not read')} B; largest dynamic "
                  f"shared memory captured "
                  + (f"{max(dyn)} B" if dyn else "none (not launched)")
                  + f" of the card's opt-in {limit} B")
    for name, entries in report.kernel_entries.items():
        print(f"[audit] matrix {name}: {', '.join(entries) or 'NOTHING'}")
    print(f"[audit] wall {wall!r} s (run_all {report.seconds!r} s, then the "
          f"corpus) on {card}")
    check(report.ok(), f"the audit found {len(report.errors())} error(s)")
    check(results and all(r.ran and r.ok for r in results),
          "a seeded defect was missed or not run on the card")
    captured = {e for entries in report.kernel_entries.values()
                for e in entries}
    check(set(AUDIT_ENTRIES) <= captured,
          f"kernels not captured: {sorted(set(AUDIT_ENTRIES) - captured)}")
    check(all(report.kernel_entries.values()),
          "a kernel-matrix entry launched nothing")
    return {"seconds": wall, "findings": len(report.findings)}


def lm_teacher_forced(model, cfg, tokens, n_pre: int, frames=None):
    """Float32 logits at positions ``n_pre − 1 ..`` of ``tokens``: a
    prefill of the first ``n_pre`` tokens (and the audio encoder over
    ``frames``), then one ``decode_step`` a token."""
    import torch
    from repro_torch.models import transformer as T
    B, S = tokens.shape
    cache = T.init_cache(cfg, B, S + 1, tokens.device)
    logits, cache = T.prefill(model, tokens[:, :n_pre], cfg, cache, frames)
    out = [logits]
    for i in range(n_pre, S):
        logits, cache = T.decode_step(model, tokens[:, i:i + 1], cfg, cache,
                                      i)
        out.append(logits)
    return torch.stack(out, dim=1)


def check_logits(got, want, tol: float, what: str) -> float:
    """``|got - want| <= tol + tol·|want|`` on finite logits; the max
    abs err."""
    import torch
    got, want = got.float().cpu(), want.float().cpu()
    check(got.shape == want.shape, f"{what}: shapes {tuple(got.shape)} and "
          f"{tuple(want.shape)}")
    check(bool(torch.isfinite(got).all() and torch.isfinite(want).all()),
          f"{what}: non-finite logits")
    diff = (got - want).abs()
    err = float(diff.max())
    check(bool((diff <= tol + tol * want.abs()).all()),
          f"{what}: max abs err {err} above {tol} + {tol}·|want|")
    return err


def dense_masked_attention(q, k, v, window: int, sink: int):
    """float64 softmax attention of one (1, S, H, 1, dh) query set under
    the token mask of ``models/attention.py`` (causal, and ``kv > q −
    window or kv < sink``), a head at a time; the output and the same
    weights applied to ``|v|``."""
    import torch
    S, H, dh = q.shape[1], q.shape[2], q.shape[-1]
    pos = torch.arange(S, device=q.device)
    ok = (pos[None, :] <= pos[:, None]) & (
        (pos[None, :] > pos[:, None] - window) | (pos[None, :] < sink))
    out = torch.empty((1, S, H, 1, dh), dtype=torch.float64, device=q.device)
    out_abs = torch.empty_like(out)
    for h in range(H):
        qh, kh, vh = (t[0, :, h].reshape(S, dh).double() for t in (q, k, v))
        s = (qh @ kh.T) * dh ** -0.5
        p = torch.softmax(s.masked_fill(~ok, float("-inf")), dim=-1)
        out[0, :, h, 0] = p @ vh
        out_abs[0, :, h, 0] = p @ vh.abs()
    return out, out_abs


def lm_step_times(model, cfg, prompts, gen: int, frames=None):
    """``launch.lm_serve.generate`` with a CUDA event at each of its
    marks; returns the prefill ms, the decode steps' ms (step and argmax),
    the host seconds of the decode loop and the last logits."""
    import torch
    from repro_torch.launch import lm_serve
    events = []

    def mark():
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
    _, logits, _, host = lm_serve.generate(model, cfg, prompts, gen,
                                           on_step=mark, frames=frames)
    ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return ms[0], ms[1:], host, logits


def lm_frames(event) -> list:
    """The Python frames above a profiled op: its recorded stack, or the
    names of its Python-function parents ("file.py(line): name")."""
    if event.stack:
        return list(event.stack)
    frames, e = [], event.cpu_parent
    while e is not None:
        frames.append(e.name)
        e = e.cpu_parent
    return frames


def lm_group(stack) -> str:
    """The layer of the LM path that launched a kernel, from the Python
    frames of the op that launched it: the ``linear`` products (matmul),
    ``models/moe.py`` outside them (moe: routing, the experts' products
    and SwiGLU, the combine), ``models/attention.py`` outside them
    (attention), ``models/ssm.py`` outside them (ssd/conv: the conv, the
    SSD or recurrence, the gated norm), the rest of ``models/``
    (elementwise: norms, RoPE, embedding, SwiGLU, residual adds), else
    other."""
    frames = [f for f in stack or () if "repro_torch/models/" in f]
    for group, test in (("matmul", lambda f: "layers.py" in f
                         and f.endswith(": linear")),
                        ("moe", lambda f: "moe.py" in f),
                        ("attention", lambda f: "attention.py" in f),
                        ("ssd/conv", lambda f: "ssm.py" in f),
                        ("elementwise", lambda f: True)):
        if any(test(f) for f in frames):
            return group
    return "other"


def lm_decode_split(model, cfg, prompts, card: str, what: str,
                    frames=None) -> dict:
    """One decode step after a prefill of ``prompts`` (and ``frames``)
    under ``torch.profiler``: device time by kernel, grouped by
    ``lm_group``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as T
    B, P = prompts.shape
    cache = T.init_cache(cfg, B, P + 2, prompts.device)
    logits, cache = T.prefill(model, prompts, cfg, cache, frames)
    tok = torch.argmax(logits, dim=-1)[:, None]
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    # torch 2.11 records an op's Python stack only in verbose mode
    verbose = torch._C._profiler._ExperimentalConfig(verbose=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts, with_stack=True,
                 experimental_config=verbose) as prof:
        logits, cache = T.decode_step(model, tok, cfg, cache, P)
        torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    groups: dict = {}
    kernels: dict = {}
    n = 0
    for e in prof.events():
        for k in e.kernels:
            g = lm_group(lm_frames(e))
            groups[g] = groups.get(g, 0.0) + k.duration
            kernels[(g, k.name)] = kernels.get((g, k.name), 0.0) + k.duration
            n += 1
    total = sum(groups.values())
    if not total:
        print(f"{what}: decode-step split not measured (the profiler "
              f"recorded no device time; step wall {wall_us!r} us under the "
              f"profiler)")
        return {}
    print(f"{what}: one decode step under torch.profiler, {n} kernels, "
          f"device time {total!r} us of {wall_us!r} us wall (busy "
          f"{total / wall_us!r}): " + ", ".join(
              f"{g} {t!r} us ({t / total:.4f})" for g, t in
              sorted(groups.items(), key=lambda x: -x[1])) + f" on {card}")
    top = sorted(kernels.items(), key=lambda x: -x[1])[:10]
    for (g, name), t in top:
        print(f"{what}: top-10 {t!r} us [{g}] {name[:110]} on {card}")
    return {"kernels": n, "device_us": total, "wall_us": wall_us, **groups}


def lm_cli(args, cfg, card: str, tag: str) -> float:
    """``python -m repro_torch.launch.lm_serve`` with ``args`` on the card
    in a fresh process: exit 0 and the launcher's five lines for ``cfg``
    (the config it runs); the wall seconds."""
    import os
    cmd = [sys.executable, "-m", "repro_torch.launch.lm_serve", "--arch",
           *args]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    run_out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=600, env=env, cwd=ROOT)
    wall = time.perf_counter() - t0
    lines = run_out.stdout.strip().splitlines()
    check(run_out.returncode == 0 and len(lines) == 5,
          f"{' '.join(cmd[1:])} exited {run_out.returncode}:\n"
          f"{run_out.stdout[-2000:]}\n{run_out.stderr[-2000:]}")
    check(lines[0] == f"arch={cfg.name} pattern={cfg.attn_pattern}"
          and re.fullmatch(r"prefill: \d+x\d+ tokens in .*", lines[1])
          and re.fullmatch(r"decode:  \d+x\d+ tokens in .*", lines[2])
          and lines[3].startswith("sample token ids: [")
          and lines[4] == "device=cuda last logits finite=True",
          f"the launcher printed:\n{run_out.stdout}")
    for line in lines:
        print(f"{tag} {line}" + (f" on {card}" if " in " in line else ""))
    print(f"{tag} {' '.join(cmd[1:])}: exit 0, wall {wall!r} s (the "
          f"interpreter, the init and the casts included) on {card}")
    return wall


def lm_timed_runs(model, cfg, runs, card: str, what: str,
                  on_prefill=None) -> dict:
    """Phase 26 (e)'s timing of ``generate`` for each (B, P, gen) of
    ``runs`` after a warm-up: prefill ms, median decode ms a token,
    tok/s, ``max_memory_allocated`` and a profiled decode step.
    ``on_prefill(B, P)``, if given, is called just before each timed
    run and its return value just after it (for the routing log)."""
    import torch
    from repro_torch.launch import lm_serve
    numbers: dict = {}
    for B, P, gen in runs:
        prompts = lm_serve.make_prompts(cfg, B, P, 0, "cuda")
        frames = lm_serve.make_frames(cfg, B, P, 0, "cuda")
        lm_step_times(model, cfg, prompts, 2, frames)      # warm-up
        torch.cuda.reset_peak_memory_stats()
        after = on_prefill(B, P) if on_prefill else None
        pre_ms, step_ms, host, logits = lm_step_times(model, cfg, prompts,
                                                      gen, frames)
        if after:
            after()
        check(bool(torch.isfinite(logits).all()), f"{what}: non-finite "
              f"logits")
        med = statistics.median(step_ms)
        mem = torch.cuda.max_memory_allocated()
        tag = f"B{B}_P{P}"
        numbers.update({f"e_{tag}_prefill_ms": pre_ms,
                        f"e_{tag}_decode_ms": med,
                        f"e_{tag}_decode_tok_s": B * 1e3 / med,
                        f"e_{tag}_max_memory_bytes": mem})
        print(f"{what}, B {B}, prompt {P}, {gen} generated: prefill "
              f"{pre_ms!r} ms ({B * P * 1e3 / pre_ms!r} tok/s); decode "
              f"{med!r} ms a token (median of {gen - 1} steps, min "
              f"{min(step_ms)!r}, max {max(step_ms)!r}; {B * 1e3 / med!r} "
              f"tok/s; the loop {host!r} s on the host clock); "
              f"max_memory_allocated {mem} on {card}")
        numbers.update({f"e_{tag}_split_{k}": val for k, val in
                        lm_decode_split(model, cfg, prompts, card,
                                        f"{what}, B {B} P {P}",
                                        frames).items()})
    return numbers


def run_lm(card: str) -> dict:
    """Phase 26: the LM serving path of Zamba2-2.7B (``LM_PHASE``),
    (a)-(e)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.sparse_attn import BF16_TOL
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    spec, dev = LM_PHASE, "cuda"
    base = get_config(spec["arch"])
    f32 = dataclasses.replace(base, dtype="float32")
    rng = np.random.default_rng(26)
    numbers: dict = {}

    # -- (a) the card against the CPU, reduced depth, float32 ---------------
    cfg = dataclasses.replace(f32, n_layers=spec["a_layers"])
    model = T.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    cpu = T.LM(cfg, None, "cpu")
    cpu.load_state_dict(model.state_dict())
    tok = torch.from_numpy(rng.integers(
        0, cfg.vocab, (spec["a_batch"], spec["a_prompt"] + spec["a_steps"])))
    got = lm_teacher_forced(model, cfg, tok.to(dev), spec["a_prompt"])
    want = lm_teacher_forced(cpu, cfg, tok, spec["a_prompt"])
    err = check_logits(got, want, LM_A_TOL, "(a) card against CPU")
    print(f"[lm] (a) {cfg.name} at {cfg.n_layers} layers, float32, B "
          f"{spec['a_batch']}, prefill {spec['a_prompt']} + "
          f"{spec['a_steps']} steps: logits {tuple(got.shape)} on the card "
          f"against the CPU, max abs err {err!r} (held to {LM_A_TOL} + "
          f"{LM_A_TOL}·|want|)")
    numbers["a_max_abs_err"] = err
    del model, cpu, got, want

    # -- (b) chunked_sdpa at the shared block's width past window + sink ----
    S, H, dh = spec["b_seq"], base.n_heads, base.d_head
    window, sink = base.window, base.n_sink_blocks * base.block_kv
    check(S > window + sink, "(b) must run past window + sink")
    g = torch.Generator(dev).manual_seed(1)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
               for shape in ((1, S, H, 1, dh), (1, S, H, dh), (1, S, H, dh)))
    pos = torch.arange(S, device=dev)

    def masked():
        return A.chunked_sdpa(q, k, v, pos, S, window=window, sink=sink,
                              q_chunk=base.q_chunk)
    out = masked()
    want, want_abs = dense_masked_attention(q, k, v, window, sink)
    err, rel = check_close(out, want, "(b) chunked_sdpa against float64",
                           want_abs_v=want_abs, **BF16_TOL)
    last = S - 1
    k_c, v_c, kv_pos, allowed = A.window_gather(k, v, last, window, sink)
    gath = A.chunked_sdpa(q[:, last:], k_c, v_c, pos[last:], S,
                          kv_pos=kv_pos, kv_allowed=allowed,
                          q_chunk=base.q_chunk)
    err_g, _ = check_close(gath, want[:, last:], "(b) gather against "
                           "float64", want_abs_v=want_abs[:, last:],
                           **BF16_TOL)
    err_gm, _ = check_close(gath, out[:, last:], "(b) gather against "
                            "masked", atol=1e-4, rtol=2 ** -7, rms=2 ** -8)
    print(f"[lm] (b) chunked_sdpa bf16 B 1 S {S} H {H} dh {dh} window "
          f"{window} sink {sink}: against a float64 dense softmax under the "
          f"token mask, max abs err {err!r}, relative RMS {rel!r} (held to "
          f"{BF16_TOL}); the gather read at position {last} ({k_c.shape[1]} "
          f"rows): {err_g!r} against float64, {err_gm!r} against the masked "
          f"read (1e-4 + 2^-7·|masked|)")
    numbers["b_chunked_sdpa_ms"] = time_ms(masked)
    print(f"[lm] (b) chunked_sdpa at that shape: "
          f"{numbers['b_chunked_sdpa_ms']!r} ms (median of {REPS}) on "
          f"{card}")
    del q, k, v, out, want, want_abs, gath

    # -- (c) full depth, float32: the cache path against the forward --------
    model = T.init_params(f32, torch.Generator(dev).manual_seed(0), dev)
    n_params = sum(t.numel() for t in model.parameters())
    n_pre, steps = spec["c_prompt"], spec["c_steps"]
    tok = torch.from_numpy(rng.integers(0, f32.vocab, (1, n_pre + steps))
                           ).to(dev)
    check(n_pre > window + sink, "(c) must prefill past window + sink")
    with torch.no_grad():
        fwd = T.forward(model, tok, f32)[0][:, n_pre - 1:]
    dec = lm_teacher_forced(model, f32, tok, n_pre)
    err = check_logits(dec, fwd, LM_C_TOL, "(c) prefill + decode against "
                       "forward")
    print(f"[lm] (c) {f32.name}, all {f32.n_layers} layers, {n_params} "
          f"parameters, float32, B 1: forward over {n_pre + steps} tokens "
          f"against a {n_pre}-token prefill and {steps} decode steps, "
          f"{steps + 1} positions, max abs err {err!r} (held to {LM_C_TOL} "
          f"+ {LM_C_TOL}·|want|; max |logit| {float(fwd.abs().max())!r})")
    numbers["c_max_abs_err"] = err
    del fwd, dec

    # -- (d) the launcher in a fresh process ---------------------------------
    numbers["d_wall_s"] = lm_cli((spec["arch"], *spec["cli"]), base, card,
                                 "[lm] (d)")

    # -- (e) bf16, full depth, timed: the weights stored in bf16 once -------
    cfg = dataclasses.replace(f32, dtype="bfloat16")
    T.to_compute(model, cfg)
    numbers.update(lm_timed_runs(model, cfg, spec["e_runs"], card,
                                 f"[lm] (e) {cfg.name} bf16, all "
                                 f"{cfg.n_layers} layers"))
    del model
    torch.cuda.empty_cache()
    return numbers


def route_logs(model, on: bool = True) -> list:
    """Switch the routing log of every MoE layer of ``model`` on (a fresh
    list each) or off; the logs, layer by layer."""
    logs = []
    for lp in getattr(model, "moe_layers", ()):
        lp.moe.route_log = [] if on else None
        logs.append(lp.moe.route_log)
    return logs


def expert_set_diff(card_logs, cpu_logs, what: str) -> int:
    """Print each token whose set of experts differs between two runs'
    routing logs (a float32 near-tie); their number."""
    n = 0
    for layer, (a_log, b_log) in enumerate(zip(card_logs, cpu_logs)):
        check(len(a_log) == len(b_log), f"{what}: MoE calls differ")
        for call, (a, b) in enumerate(zip(a_log, b_log)):
            ia = a["idx"].cpu().sort(dim=-1).values
            ib = b["idx"].cpu().sort(dim=-1).values
            for g, t in (ia != ib).any(dim=-1).nonzero().tolist():
                print(f"[lm27] {what}: MoE layer {layer}, call {call} (0 "
                      f"the prefill), group {g} token {t}: experts "
                      f"{ia[g, t].tolist()} on the card, {ib[g, t].tolist()} "
                      f"on the CPU")
                n += 1
    return n


def run_lm27(card: str) -> dict:
    """Phase 27: the LM serving path of the MoE, MLA and audio families
    at their published widths (``LM27``), (a)-(e)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    spec, dev = LM27, "cuda"
    rng = np.random.default_rng(27)
    numbers: dict = {}
    B, n_pre = spec["a_batch"], spec["a_prompt"]

    def count(model) -> int:
        return sum(t.numel() for t in model.parameters())

    # -- (a) the card against the CPU, reduced depth, float32; (b) MLA ------
    for arch, cut in spec["a"]:
        cfg = dataclasses.replace(get_config(arch), dtype="float32", **cut)
        model = T.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
        cpu = T.LM(cfg, None, "cpu")
        cpu.load_state_dict(model.state_dict())
        tok = torch.from_numpy(rng.integers(
            0, cfg.vocab, (B, n_pre + spec["a_steps"])))
        frames = None
        if cfg.family == "audio":
            frames = torch.from_numpy((0.1 * rng.standard_normal(
                (B, cfg.enc_frames, cfg.d_model))).astype(np.float32))
        logs = [route_logs(m) for m in (model, cpu)]
        got = lm_teacher_forced(model, cfg, tok.to(dev), n_pre,
                                None if frames is None else frames.to(dev))
        want = lm_teacher_forced(cpu, cfg, tok, n_pre, frames)
        moved = expert_set_diff(*logs, f"(a) {cfg.name}")
        route_logs(model, False)
        del cpu
        err = check_logits(got, want, LM_A_TOL,
                           f"(a) {cfg.name} card against CPU")
        depth = (f"{cfg.n_layers} layers" if cfg.family != "audio" else
                 f"{cfg.enc_layers} + {cfg.n_layers} layers over "
                 f"{cfg.enc_frames} frames")
        print(f"[lm27] (a) {cfg.name} at {depth}, {count(model)} "
              f"parameters, float32, B {B}, prefill {n_pre} + "
              f"{spec['a_steps']} steps: logits {tuple(got.shape)} on the "
              f"card against the CPU, max abs err {err!r} (held to "
              f"{LM_A_TOL} + {LM_A_TOL}·|want|); tokens whose experts differ "
              f"between the devices: {moved}")
        numbers[f"a_{arch}_max_abs_err"] = err
        if cfg.mla:
            expanded = dataclasses.replace(cfg, mla_absorb=False)
            exp = lm_teacher_forced(model, expanded, tok.to(dev), n_pre)
            err_b = check_logits(got, exp, LM_MLA_TOL, "(b) MLA absorbed "
                                 "against expanded")
            print(f"[lm27] (b) {cfg.name} at {cfg.n_layers} layers, float32, "
                  f"B {B}, prefill {n_pre} + {spec['a_steps']} steps: the "
                  f"absorbed decode (kv_lora {cfg.kv_lora}, rope "
                  f"{cfg.rope_head_dim}, {cfg.n_heads} heads) against the "
                  f"expanded read, max abs err {err_b!r} (held to "
                  f"{LM_MLA_TOL} + {LM_MLA_TOL}·|want|)")
            numbers["b_max_abs_err"] = err_b
        del model, got, want
        torch.cuda.empty_cache()

    # -- (c) DeepSeek-V2 at 4 layers, float32: the cache path against the
    # forward, no token dropped
    base = get_config("deepseek_v2_236b")
    cfg = dataclasses.replace(base, dtype="float32",
                              n_layers=spec["c_layers"], mla_absorb=False,
                              capacity_factor=float(base.n_experts))
    model = T.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    steps = spec["c_steps"]
    n_c = spec["c_prompt"]
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (1, n_c + steps))
                           ).to(dev)
    logs = route_logs(model)
    with torch.no_grad():
        fwd = T.forward(model, tok, cfg)[0][:, n_c - 1:]
    dec = lm_teacher_forced(model, cfg, tok, n_c)
    dropped = sum(int((~e["keep"]).sum()) for log in logs for e in log)
    route_logs(model, False)
    check(dropped == 0, f"(c) {dropped} assignments dropped at capacity "
          f"factor {cfg.capacity_factor}")
    err = check_logits(dec, fwd, LM_C_TOL, "(c) prefill + decode against "
                       "forward")
    gt = M.group_size(n_c + steps, 1024)
    print(f"[lm27] (c) {cfg.name} at {cfg.n_layers} layers (1 dense + "
          f"{cfg.n_layers - 1} MoE), {count(model)} parameters, float32, "
          f"mla_absorb=False, capacity_factor {cfg.capacity_factor} (no "
          f"assignment dropped), B 1: forward over {n_c + steps} tokens "
          f"(groups of {gt}) against a {n_c}-token prefill and {steps} "
          f"decode steps (groups of 1), {steps + 1} positions, max abs err "
          f"{err!r} (held to {LM_C_TOL} + {LM_C_TOL}·|want|; max |logit| "
          f"{float(fwd.abs().max())!r})")
    numbers["c_max_abs_err"] = err
    del fwd, dec

    # -- (d) the launcher in fresh processes ---------------------------------
    for args in spec["cli"]:
        cli_cfg = (get_smoke_config if "--smoke" in args else
                   get_config)(args[0])
        numbers[f"d_{args[0]}_wall_s"] = lm_cli(args, cli_cfg, card,
                                                "[lm27] (d)")

    # -- (e) bf16, timed; DeepSeek-V2 from (c) stored in bf16 ----------------
    for arch, depth, runs in spec["e"]:
        cut = {} if depth is None else {"n_layers": depth}
        cfg = dataclasses.replace(get_config(arch), **cut)
        if arch != "deepseek_v2_236b":
            model = T.init_params(cfg, torch.Generator(dev).manual_seed(0),
                                  dev)
        T.to_compute(model, cfg)
        torch.cuda.empty_cache()
        what = (f"[lm27] (e) {cfg.name} bf16, {cfg.n_layers} of "
                f"{get_config(arch).n_layers} layers, {count(model)} "
                f"parameters")

        def drops(Bp, P, model=model, cfg=cfg):
            logs = route_logs(model)

            def after():
                for layer, log in enumerate(logs):
                    keep = log[0]["keep"]               # the prefill
                    n = int((~keep).sum())
                    print(f"[lm27] (e) {cfg.name} B {Bp} P {P}: MoE layer "
                          f"{layer} dropped {n} of {keep.numel()} (token, "
                          f"slot) assignments in the prefill (share "
                          f"{n / keep.numel()!r}; groups of "
                          f"{keep.shape[1]} tokens, capacity factor "
                          f"{cfg.capacity_factor})")
                    numbers[f"e_{arch}_B{Bp}_P{P}_drop_share_{layer}"] = (
                        n / keep.numel())
                route_logs(model, False)
            return after
        numbers.update({f"{arch}_{k}": v for k, v in lm_timed_runs(
            model, cfg, runs, card, what,
            drops if arch == "deepseek_v2_236b" else None).items()})
        del model
        torch.cuda.empty_cache()
    return numbers


def train_step_split(step, params, opt, batch, ocfg, cfg, card: str,
                     what: str) -> dict:
    """One training step's forward and backward and its AdamW update,
    each timed with CUDA events, then one whole step under
    ``torch.profiler``: its kernels and the device's busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import steps as S
    from repro_torch.optim import adamw_update

    def event_ms(fn):
        """One warm call of ``fn`` between two CUDA events."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end), out

    t_grad, (_, _, grads) = event_ms(
        lambda: S.loss_and_grads(params, batch, cfg))
    t_opt, _ = event_ms(lambda: adamw_update(
        dict(params.named_parameters()), grads, opt, ocfg))
    del grads
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(params, opt, batch)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    # the raw device records: building ``prof.events()``' tree over a
    # step's ~3e5 records took 43 s on the card's host
    t0 = time.perf_counter()
    dev = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    n, dev_us = len(dev), sum(e.duration_ns() for e in dev) / 1e3
    print(f"{what}: reading the profile took "
          f"{time.perf_counter() - t0!r} s")
    print(f"{what}: forward + backward {t_grad!r} ms, AdamW update "
          f"{t_opt!r} ms (share {t_opt / (t_grad + t_opt)!r}) on {card}")
    if not dev_us:
        print(f"{what}: busy share not measured (the profiler recorded no "
              f"device time; step wall {wall_ms!r} ms under it)")
        return {"grad_ms": t_grad, "adamw_ms": t_opt}
    # the profiler's own host work stretches the step it records, so the
    # busy share is also given against the step timed without it
    print(f"{what}: one step under torch.profiler: {n} kernels, device "
          f"time {dev_us / 1e3!r} ms of {wall_ms!r} ms wall under the "
          f"profiler (busy {dev_us / 1e3 / wall_ms!r}); against the "
          f"unprofiled forward + backward + update "
          f"{dev_us / 1e3 / (t_grad + t_opt)!r} on {card}")
    return {"grad_ms": t_grad, "adamw_ms": t_opt, "kernels": n,
            "device_ms": dev_us / 1e3, "wall_ms": wall_ms}


def train_metrics(m) -> dict:
    vals = {k: float(m[k]) for k in ("loss", "ce", "grad_norm", "lr")}
    check(all(math.isfinite(v) for v in vals.values()),
          f"non-finite training metrics {vals}")
    return vals


def train_shared_attention(cfg, B: int, S: int, card: str) -> dict:
    """28 (f): one shared-attention call of ``cfg`` alone (its heads, head
    width, ``q_chunk``, window and sink), bf16, B × S, q, k and v drawn
    from a seeded ``torch.Generator``: its forward and backward through
    ``chunked_sdpa`` (a checkpoint a query chunk) and through the
    un-checkpointed loop of the same chunk function (``attention``'s
    ``remat_call`` replaced by a direct call for that pass).
    The gradients of q, k and v must be bit-equal; the peak of each
    (``max_memory_allocated`` over what was allocated before) and its
    CUDA-event time are printed."""
    import torch
    from repro_torch.models import attention as A
    from repro_torch.models.layers import remat_call
    from repro_torch.models.transformer import _sparse_kw
    dev = "cuda"
    gen = torch.Generator(dev).manual_seed(28)
    H, G, dh = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.d_head

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)
    q0, k0, v0 = draw(B, S, H, G, dh), draw(B, S, H, dh), draw(B, S, H, dh)
    cot = draw(B, S, H, G, dh)
    pos = torch.arange(S, device=dev)
    kw = dict(q_chunk=cfg.q_chunk, **_sparse_kw(cfg))

    def fwd_bwd(remat: bool):
        q, k, v = (t.clone().requires_grad_() for t in (q0, k0, v0))
        if not remat:
            A.remat_call = lambda fn, *args: fn(*args)
        try:
            out = A.chunked_sdpa(q, k, v, pos, S, **kw)
            return torch.autograd.grad(out, (q, k, v), grad_outputs=cot)
        finally:
            A.remat_call = remat_call

    grads, out = {}, {}
    for remat in (True, False):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grads[remat] = fwd_bwd(remat)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        ms = time_ms(lambda: fwd_bwd(remat))
        out[remat] = {"peak_gb": peak, "ms": ms}
    same = all(torch.equal(a, b) for a, b in zip(grads[True], grads[False]))
    finite = all(bool(torch.isfinite(g).all()) for g in grads[True])
    print(f"[train] (f) {cfg.name}'s shared attention alone, bf16, B {B} × "
          f"S {S}, {cfg.n_heads} heads, dh {dh}, q_chunk {cfg.q_chunk}, "
          f"{kw}: forward + backward through chunked_sdpa (a checkpoint a "
          f"query chunk) {out[True]['ms']!r} ms, peak "
          f"{out[True]['peak_gb']!r} GB; the un-checkpointed loop "
          f"{out[False]['ms']!r} ms, peak {out[False]['peak_gb']!r} GB; "
          f"grads of q, k, v bit-equal: {same} on {card}")
    check(finite, "(f) non-finite gradients")
    check(same, "(f) the checkpointed gradients differ from the loop's")
    return {"f_remat_ms": out[True]["ms"], "f_loop_ms": out[False]["ms"],
            "f_remat_peak_gb": out[True]["peak_gb"],
            "f_loop_peak_gb": out[False]["peak_gb"]}


def run_train(card: str) -> dict:
    """Phase 28: the LM training path of Zamba2-2.7B (``TRAIN``),
    (a)-(g)."""
    import dataclasses
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.checkpoint import sharded as ckpt
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_to_numpy, opt_state_to_numpy
    from repro_torch.core import make_regions
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import emit, ops, ref
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime.trainer import (SimulatedFailure, Trainer,
                                             TrainerConfig)

    torch.backends.cuda.matmul.allow_tf32 = False
    spec, dev = TRAIN, "cuda"
    base = get_config(spec["arch"])
    seq = spec["seq"]
    ocfg = AdamWConfig()                 # the reference's defaults
    numbers: dict = {}
    t_phase = time.perf_counter()

    def part(name, t0):
        print(f"[train] ({name}) wall {time.perf_counter() - t0!r} s")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    du = shutil.disk_usage(tmp)
    print(f"[train] checkpoints under {tmp}: {du.free / 1e9!r} GB free of "
          f"{du.total / 1e9!r}")

    def n_params(model):
        return sum(p.numel() for p in model.parameters())

    # -- (a) full width and depth through Trainer.run ------------------------
    t_part = time.perf_counter()
    B, n_a = spec["a_batch"], spec["a_steps"] + 1
    tr = Trainer(base, ocfg, TrainerConfig(ckpt_dir=str(tmp / "a"),
                                           ckpt_every=10 ** 9),
                 DataConfig(vocab=base.vocab, seq_len=seq, global_batch=B),
                 device=dev)
    marks, rows = [], []

    def on_step(step, m):
        rows.append(train_metrics(m))          # syncs on the loss
        marks.append(time.perf_counter())
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        tr.run(n_a + 1, failure_at=n_a, on_step=on_step)
        check(False, "(a) the injected failure did not stop the run")
    except SimulatedFailure:
        pass
    peak = torch.cuda.max_memory_allocated()
    del tr
    secs = [b - a for a, b in zip([t0] + marks[:-1], marks)]
    timed = secs[1:]
    step_s = statistics.median(timed)
    for i, (r, sec) in enumerate(zip(rows, secs)):
        print(f"[train] (a) {base.name} all {base.n_layers} layers, B {B} × "
              f"S {seq}, step {i}{' (warm)' if i == 0 else ''}: "
              f"{sec!r} s, loss {r['loss']!r}, grad_norm "
              f"{r['grad_norm']!r}, lr {r['lr']!r} on {card}")
    print(f"[train] (a) Trainer.run: {statistics.median(timed)!r} s a step "
          f"(median of {len(timed)}), {B * seq / step_s!r} tokens/s, "
          f"max_memory_allocated {peak / 1e9!r} GB on {card}")
    numbers.update(a_step_s=step_s, a_tok_s=B * seq / step_s,
                   a_peak_gb=peak / 1e9, a_loss=[r["loss"] for r in rows])
    part("a", t_part)
    t_part = time.perf_counter()

    # -- (b) make_train_step at grad_accum 4, then the step's split ---------
    check(base.grad_accum == 4, f"grad_accum is {base.grad_accum}")
    model = T.init_params(base, torch.Generator(dev).manual_seed(0), dev)
    named = dict(model.named_parameters())
    opt = adamw_init(named)
    rng = np.random.default_rng(28)

    def tokens(b, s):
        return torch.from_numpy(rng.integers(0, base.vocab, (b, s + 1)
                                             ).astype(np.int32)).to(dev)
    Bb = spec["b_batch"]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, opt, m = S.make_train_step(base, ocfg)(model, opt,
                                              {"tokens": tokens(Bb, seq)})
    r = train_metrics(m)
    sec = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    print(f"[train] (b) make_train_step, grad_accum {base.grad_accum}, B "
          f"{Bb} × S {seq} ({n_params(model)} parameters): {sec!r} s, "
          f"{Bb * seq / sec!r} tokens/s, loss {r['loss']!r}, grad_norm "
          f"{r['grad_norm']!r}, lr {r['lr']!r}, max_memory_allocated "
          f"{peak / 1e9!r} GB on {card}")
    numbers.update(b_step_s=sec, b_tok_s=Bb * seq / sec,
                   b_peak_gb=peak / 1e9)
    mono = dataclasses.replace(base, grad_accum=1)
    numbers.update(train_step_split(
        S.make_train_step(mono, ocfg), model, opt,
        {"tokens": tokens(B, seq)}, ocfg, mono, card,
        f"[train] (b) B {B} × S {seq}"))
    del model, named, opt
    torch.cuda.empty_cache()
    part("b", t_part)
    t_part = time.perf_counter()

    # -- (c) one group in float32: the card against the CPU -----------------
    cfg = dataclasses.replace(base, n_layers=spec["c_layers"],
                              dtype="float32", grad_accum=1)
    card_m = T.init_params(cfg, torch.Generator(dev).manual_seed(1), dev)
    cpu_m = T.LM(cfg, None, "cpu")
    cpu_m.load_state_dict(card_m.state_dict())
    before = {n: p.detach().cpu().clone() for n, p in
              cpu_m.named_parameters()}
    tok = tokens(1, spec["c_seq"])
    step = S.make_train_step(cfg, ocfg)
    outs = {}
    for name, model, t in (("card", card_m, tok), ("cpu", cpu_m, tok.cpu())):
        _, _, m = step(model, adamw_init(dict(model.named_parameters())),
                       {"tokens": t})
        outs[name] = train_metrics(m)
    rel = {k: abs(outs["card"][k] - outs["cpu"][k]) / abs(outs["cpu"][k])
           for k in ("loss", "grad_norm")}
    upd = 0.0
    for (n, pc), (_, pg) in zip(cpu_m.named_parameters(),
                                card_m.named_parameters()):
        d_cpu = pc.detach() - before[n]
        d_card = pg.detach().cpu() - before[n]
        upd = max(upd, float(torch.linalg.vector_norm(d_card - d_cpu)
                             / torch.linalg.vector_norm(d_cpu)))
    rel["update"] = upd
    print(f"[train] (c) {cfg.name} at {cfg.n_layers} layers, float32, "
          f"{n_params(cpu_m)} parameters, B 1 × S {spec['c_seq']}, one "
          f"make_train_step on the card against the CPU: loss "
          f"{outs['card']['loss']!r} / {outs['cpu']['loss']!r} (rel "
          f"{rel['loss']!r}), grad_norm {outs['card']['grad_norm']!r} / "
          f"{outs['cpu']['grad_norm']!r} (rel {rel['grad_norm']!r}), the "
          f"largest ||Δcard − Δcpu|| / ||Δcpu|| of a tensor {upd!r} (held "
          f"to {TRAIN_C_TOL})")
    for k, tol in TRAIN_C_TOL.items():
        check(rel[k] <= tol, f"(c) {k}: {rel[k]!r} > {tol}")
    numbers.update({f"c_rel_{k}": v for k, v in rel.items()})
    del card_m, cpu_m, before
    torch.cuda.empty_cache()
    part("c", t_part)
    t_part = time.perf_counter()

    # -- (d) the restart drill -----------------------------------------------
    cfg = dataclasses.replace(base, n_layers=spec["c_layers"])
    nd = spec["d_steps"]

    def trainer(d):
        return Trainer(cfg, ocfg, TrainerConfig(
            ckpt_dir=str(tmp / d), ckpt_every=spec["d_every"],
            n_ckpt_shards=spec["d_shards"]),
            DataConfig(vocab=cfg.vocab, seq_len=spec["d_seq"],
                       global_batch=1), device=dev)
    t0 = time.perf_counter()
    p1, o1, m1 = trainer("straight").run(nd)
    t_straight = time.perf_counter() - t0
    shutil.rmtree(tmp / "straight")
    t0 = time.perf_counter()
    p2, o2, m2 = trainer("restarted").run_resilient(
        nd, failures=(spec["d_fail"],))
    t_restart = time.perf_counter() - t0
    same = (all(torch.equal(a, b) for a, b in zip(p1.parameters(),
                                                  p2.parameters()))
            and all(torch.equal(o1[k][n], o2[k][n]) for k in ("m", "v")
                    for n in o1[k])
            and torch.equal(o1["step"], o2["step"])
            and all(torch.equal(m1[k], m2[k]) for k in m1))
    print(f"[train] (d) {cfg.name} at {cfg.n_layers} layers, bf16, B 1 × S "
          f"{spec['d_seq']}: {nd} steps, 2-shard checkpoints every "
          f"{spec['d_every']}, failure at step {spec['d_fail']}: params, m, "
          f"v, step and metrics of run_resilient bit for bit the "
          f"uninterrupted run's: {same}; wall {t_straight!r} s straight, "
          f"{t_restart!r} s with the restart, checkpoints and restore "
          f"included, on {card}")
    check(same, "(d) the restarted run differs from the uninterrupted one")
    del p1, o1
    numbers.update(d_straight_s=t_straight, d_restart_s=t_restart)

    # -- (e) the elastic restore through K2 ----------------------------------
    d_dir, last = tmp / "restarted", ckpt.latest_step(tmp / "restarted")
    check(last == nd, f"(e) latest step {last}")
    saved = {"params": lm_params_to_numpy(cfg, p2),
             "opt": opt_state_to_numpy(o2)}
    del p2, o2
    torch.cuda.empty_cache()
    manifest = json.loads((d_dir / f"step_{last:07d}" / "manifest.json"
                           ).read_text())
    n_leaves = len(manifest["leaves"])
    emit.twopass_emit.launches = 0
    t0 = time.perf_counter()
    got = ckpt.restore(d_dir, last, saved, n_shards_new=spec["e_shards"],
                       device=dev)
    t_restore = time.perf_counter() - t0
    launches = emit.twopass_emit.launches
    flat_g, flat_s = ckpt._leaf_paths(got), ckpt._leaf_paths(saved)
    equal = [a == b and x.dtype == y.dtype and x.tobytes() == y.tobytes()
             for (a, x), (b, y) in zip(flat_g, flat_s)]
    plans_equal = 0
    for rec in manifest["leaves"]:
        rows = rec["shape"][0] if rec["shape"] else 1
        old = [tuple(r) for r in rec["ranges"]]
        new = ckpt._split_ranges(rows, spec["e_shards"])
        plans_equal += (ckpt._reshard_plan(old, new, dev)
                        == ckpt._reshard_plan(old, new, "cpu"))
    print(f"[train] (e) the {spec['d_shards']}-shard checkpoint of step "
          f"{last} ({n_leaves} leaves) restored at {spec['e_shards']} "
          f"shards in {t_restore!r} s: {sum(equal)} of {len(equal)} leaves "
          f"bit for bit the saved tree; K2 launched {launches} times; "
          f"{plans_equal} of {n_leaves} plans equal to the plain pass 2's "
          f"on {card}")
    check(len(flat_g) == len(flat_s) == n_leaves and all(equal),
          "(e) the restored tree differs from the saved one")
    check(launches == n_leaves, f"(e) K2 launched "
          f"{launches} times for {n_leaves} leaves")
    check(plans_equal == n_leaves, "(e) a reshard plan differs from the "
          "plain pass 2's")
    del got, saved
    shutil.rmtree(tmp)
    numbers["e_restore_s"] = t_restore
    part("d, e", t_part)
    t_part = time.perf_counter()

    # K2 at the restore's plan of a leaf of >= 3 rows (3 new ranges, 2 old)
    old, new = ckpt._split_ranges(6, 2), ckpt._split_ranges(6, 3)
    Sr = make_regions(np.asarray([[lo] for lo, _ in new], np.float32),
                          np.asarray([[hi] for _, hi in new], np.float32),
                          dev)
    Ur = make_regions(np.asarray([[lo] for lo, _ in old], np.float32),
                          np.asarray([[hi] for _, hi in old], np.float32),
                          dev)
    cap = (len(new) + len(old)) * 2 + 8
    perm_s, perm_u, starts, counts, offs, _, _ = ops._phase1(Sr, Ur, cap)
    args = (offs, counts, starts, perm_s, perm_u)
    k2_err = exact_err(emit.twopass_emit(*args, max_pairs=cap),
                       ref.twopass_emit(*args, max_pairs=cap))
    check(k2_err == 0, "(e) K2 differs from its plain version")
    times = {"k2_restore": time_ms(lambda: emit.twopass_emit(
        *args, max_pairs=cap)),
        "k2_restore_plain": time_ms(lambda: ref.twopass_emit(
            *args, max_pairs=cap))}
    n, m = len(new), len(old)
    E = n + m
    steps = math.ceil(math.log2(E + 1))
    k2_bound = bound_ms(4 * ((E + 1) + 2 * E + n + m) + 8 * cap,
                        (6 * steps + 12) * cap)
    print(f"[train] (e) K2 at a leaf's plan (n {n}, m {m}, cap {cap}): "
          f"{times['k2_restore']!r} ms through its wrapper, plain "
          f"{times['k2_restore_plain']!r} ms, bound {k2_bound[0]!r} ms "
          f"({k2_bound[1]}) on {card}")

    # -- (f) one shared-attention call: per-chunk remat against the loop -----
    t_part = time.perf_counter()
    numbers.update(train_shared_attention(base, B, seq, card))
    torch.cuda.empty_cache()
    part("f", t_part)
    t_part = time.perf_counter()

    # -- (g) the launcher -----------------------------------------------------
    import os
    cli_dir = tempfile.mkdtemp(prefix="chip_smoke_train_cli_")
    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           *spec["cli"], "--device", dev, "--ckpt-dir", cli_dir]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=600, env=env, cwd=ROOT)
    finally:
        shutil.rmtree(cli_dir, ignore_errors=True)
    wall = time.perf_counter() - t0
    check(out.returncode == 0, f"{' '.join(cmd[1:])} exited "
          f"{out.returncode}:\n{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
    losses = [float(x) for x in re.findall(r"^step +\d+ loss ([\d.]+) ",
                                           out.stdout, re.M)]
    for line in out.stdout.strip().splitlines():
        print(f"[train] (g) {line}")
    print(f"[train] (g) {' '.join(cmd[1:])}: exit 0, wall {wall!r} s on "
          f"{card}")
    check(len(losses) >= 2 and losses[-1] < losses[0],
          f"(g) the launcher's loss did not fall: {losses}")
    numbers["g_wall_s"] = wall
    part("g", t_part)
    print(f"[train] phase 28 wall {time.perf_counter() - t_phase!r} s")

    key = "twopass_emit (checkpoint restore)"
    kernels = [{"name": key, "route": "cuda",
                "source": "src/repro_torch/csrc/emit.cu",
                "replaces": "src/repro/kernels/emit.py:185",
                "launches": launches, "max_abs_err": k2_err,
                "ms": times["k2_restore"],
                "plain_ms": times["k2_restore_plain"],
                "bound_ms": k2_bound[0], "bound_by": k2_bound[1],
                "library_ms": None, "match": True}]
    return {"launches": {key: launches}, "kernels": kernels,
            "times": times, "numbers": numbers}


_PG_DIRS: list = []


def _world1() -> None:
    """Start, once, a NCCL process group of world size 1 on a ``file://``
    store in a temporary directory; ``_end_world1`` destroys it and the
    directory."""
    import datetime
    import tempfile
    import torch
    import torch.distributed as dist
    if dist.is_initialized():
        return
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    _PG_DIRS.append(tmp)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=300))


def _end_world1() -> None:
    import shutil
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    while _PG_DIRS:
        shutil.rmtree(_PG_DIRS.pop(), ignore_errors=True)


def multi_quickstart(card: str) -> dict:
    """29 (a): the quickstart twin on the card and with --device cpu, in
    fresh processes side by side: the same lines but the last, which on
    the card counts K1, K2, K3 and K8's launches."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    script = str(ROOT / "examples" / "quickstart_torch.py")
    t0 = time.perf_counter()
    procs = {d: subprocess.Popen([sys.executable, script, "--device", d],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True, env=env,
                                 cwd=ROOT)
             for d in ("cuda", "cpu")}
    outs = {}
    for d, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        check(proc.returncode == 0, f"(a) quickstart_torch.py --device {d} "
              f"exited {proc.returncode}:\n{out[-2000:]}\n{err[-2000:]}")
        outs[d] = [line for line in out.splitlines() if line.strip()]
    wall = time.perf_counter() - t0
    card_lines, cpu_lines = outs["cuda"], outs["cpu"]
    last = card_lines.pop()
    check(cpu_lines.pop() == "no kernel ran: the kernels' plain versions "
          "stood in on cpu", f"(a) the CPU run ended {outs['cpu'][-1]!r}")
    check(card_lines == cpu_lines, "(a) the card's lines differ from the "
          f"CPU's:\n{card_lines}\n{cpu_lines}")
    m = re.fullmatch(r"kernel launches: K1=(\d+) K2=(\d+) K3=(\d+) "
                     r"K8=(\d+)", last)
    check(m is not None and all(int(n) > 0 for n in m.groups()),
          f"(a) the card run's kernels: {last!r}")
    for line in card_lines:
        print(f"[multi] (a) {line}")
    print(f"[multi] (a) quickstart_torch.py on the card: {last}; its lines "
          f"equal --device cpu's; both runs {wall!r} s wall on {card}")
    return {"a_wall_s": wall,
            "a_launches": dict(zip(("K1", "K2", "K3", "K8"),
                                   map(int, m.groups())))}


def _teacher_forced_on(model, cfg, tokens, n_pre: int, cache,
                       on_step=None):
    """``lm_teacher_forced`` on a given cache; ``on_step`` is called after
    the prefill and after every decode step.  DTensor logits come back
    whole."""
    import torch
    from repro_torch.models import transformer as T

    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t
    logits, cache = T.prefill(model, tokens[:, :n_pre], cfg, cache)
    out = [whole(logits)]
    on_step and on_step()
    for i in range(n_pre, tokens.shape[1]):
        logits, cache = T.decode_step(model, tokens[:, i:i + 1], cfg, cache,
                                      i)
        out.append(whole(logits))
        on_step and on_step()
    return torch.stack(out, dim=1)


def multi_partition(cfg, n_pre: int, steps: int, card: str,
                    tol: float = LM_C_TOL) -> dict:
    """29 (b): ``cfg`` with its parameters and cache placed by
    ``launch.partition`` on a (1, 1) mesh of the world-size-1 group, run
    under ``launch.mesh.sharded``, against the plain path on the same
    weights: logits, bit-equality, decode ms a token.  A size-1 mesh dim
    replicates, so every DTensor is replicated, each ``constrain`` returns
    its input and no op needs a repair (checked): this shows replicated
    DTensor dispatch bit for bit, not a redistribution."""
    import numpy as np
    import torch
    from repro_torch.launch import partition as pt
    from repro_torch.launch.mesh import make_mesh, sharded
    from repro_torch.models import transformer as T

    dev = "cuda"
    _world1()
    model = T.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    n_params = sum(t.numel() for t in model.parameters())
    rng = np.random.default_rng(29)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (1, n_pre + steps))
                           ).to(dev)
    marks: list = []

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    def decode_ms():
        return statistics.median(
            (b - a) * 1e3 for a, b in zip(marks[1:], marks[2:]))
    plain = _teacher_forced_on(model, cfg, tok, n_pre, T.init_cache(
        cfg, 1, n_pre + steps + 1, dev), mark)
    plain_ms = decode_ms()
    marks.clear()
    mesh = make_mesh((1, 1), ("data", "model"), device=dev)
    pt.distribute_params(model, mesh)
    cache = T.init_cache(cfg, 1, n_pre + steps + 1, dev)
    cspecs = pt.sanitize_tree(mesh, pt.cache_specs(
        mesh, cache, batch=1, seq_shard=True), cache)
    cache = pt.distribute_tree(cache, cspecs, mesh)
    with sharded(mesh) as reshard:
        placed = _teacher_forced_on(model, cfg, tok, n_pre, cache, mark)
    placed_ms = decode_ms()
    check(reshard.ops == {}, f"(b) ops repaired on a (1, 1) mesh: "
          f"{reshard.ops}")
    err = check_logits(placed, plain, tol, "(b) placed against plain")
    same = bool(torch.equal(placed, plain))
    print(f"[multi] (b) {cfg.name}, {cfg.n_layers} layers, {n_params} "
          f"parameters, {cfg.dtype}, B 1: parameters and cache as DTensors "
          f"on a (1, 1) mesh ({dist_backend()}), constrain active, a "
          f"{n_pre}-token prefill and {steps} decode steps against the "
          f"plain path on the same weights: max abs err {err!r} (held to "
          f"{tol} + {tol}·|want|), bit-equal {same}; ops repaired "
          f"{reshard.ops}")
    print(f"[multi] (b) decode {placed_ms!r} ms a token placed, "
          f"{plain_ms!r} ms plain (median of {steps - 1} steps, host "
          f"clock, synchronized) on {card}")
    del model, cache
    return {"b_max_abs_err": err, "b_bit_equal": same,
            "b_reshards": dict(reshard.ops),
            "b_decode_ms": placed_ms, "b_plain_decode_ms": plain_ms}


def dist_backend() -> str:
    import torch.distributed as dist
    return dist.get_backend() if dist.is_initialized() else "none"


def multi_pipeline(cfg, B: int, S: int, M: int, card: str) -> dict:
    """29 (c): ``cfg``'s layer stack through ``pipeline_forward`` at
    ``M`` microbatches on the world-size-1 group, against the serial
    stack microbatch by microbatch (bit for bit) and on the whole batch
    (``MULTI_C_TOL``); times beside the serial stack's."""
    import torch
    from torch import nn
    from repro_torch.models import transformer as T
    from repro_torch.runtime.pipeline import pipeline_forward

    dev = "cuda"
    _world1()
    model = T.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    T.to_compute(model, cfg)
    layers = list(model.layers)
    names = [n for n, _ in layers[0].named_parameters()]
    stacked = {n: torch.stack([dict(lp.named_parameters())[n].detach()
                               for lp in layers]) for n in names}

    class _Layer(nn.Module):
        def __init__(self, layer):
            super().__init__()
            self.layer = layer

        def forward(self, h):
            return T._mamba_layer_apply(self.layer, h, cfg)[0]
    one = _Layer(layers[0])

    def layer_apply(p, h):
        return torch.func.functional_call(
            one, {f"layer.{k}": v for k, v in p.items()}, (h,))

    def serial(h):
        for lp in layers:
            h = T._mamba_layer_apply(lp, h, cfg)[0]
        return h
    g = torch.Generator(dev).manual_seed(3)
    x = torch.randn((B, S, cfg.d_model), generator=g, device=dev).to(
        torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32)
    with torch.no_grad():
        def pipe():
            return pipeline_forward(stacked, x, layer_apply,
                                    n_microbatches=M)
        got = pipe()
        want_mb = torch.cat([serial(c) for c in x.chunk(M)])
        want = serial(x)
        same = bool(torch.equal(got, want_mb))
        check(same, "(c) the pipeline is not the microbatch stack's bits")
        err, rel = check_close(got, want, "(c) pipeline against the whole "
                               "batch", **MULTI_C_TOL)
        pipe_ms = time_ms(pipe)
        serial_ms = time_ms(lambda: serial(x))
        mb_ms = time_ms(lambda: [serial(c) for c in x.chunk(M)])
    print(f"[multi] (c) {cfg.name}, {len(layers)} layers, d "
          f"{cfg.d_model}, {cfg.dtype}, B {B} × S {S}: pipeline_forward at "
          f"{M} microbatches ({dist_backend()}, world size 1, {M} ticks) "
          f"bit-equal to the serial stack microbatch by microbatch; against "
          f"the whole-batch stack max abs err {err!r}, relative RMS {rel!r} "
          f"(held to {MULTI_C_TOL})")
    print(f"[multi] (c) pipeline {pipe_ms!r} ms, serial whole batch "
          f"{serial_ms!r} ms, serial by microbatch {mb_ms!r} ms (median of "
          f"{REPS}) on {card}")
    del model, stacked
    return {"c_pipe_ms": pipe_ms, "c_serial_ms": serial_ms,
            "c_serial_mb_ms": mb_ms, "c_max_abs_err": err}


def _env_src() -> dict:
    import os
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def one_card_trace(dev: str = "cuda") -> dict:
    """29 (d)'s one-card cell traced by the dry run: ``MULTI``'s Zamba2
    train step at B d_batch × S d_seq, grad_accum 1 (as ``Trainer.run``),
    on a (1, 1) fake mesh; the counts and the trace's wall seconds."""
    import dataclasses
    import torch
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import destroy_fake_world, make_mesh
    cfg = dataclasses.replace(get_config(MULTI["b_arch"]), grad_accum=1)
    spec = ShapeSpec("one_card", MULTI["d_seq"], MULTI["d_batch"], "train")
    t0 = time.perf_counter()
    mesh = make_mesh((1, 1), ("data", "model"), device=dev, fake=True)
    try:
        rec = dryrun.trace_cell(cfg, spec, mesh, torch.device(dev))
    finally:
        destroy_fake_world()
    rec.pop("largest")
    return {**rec, "colls": len(rec["colls"]),
            "trace_s": time.perf_counter() - t0}


def start_multi_background() -> dict:
    """29 (d)'s dry runs, started in fresh processes before phase 27 so
    that their host work (DTensor dispatch on fake tensors, one core
    each) overlaps phases 27 and 28: the smoke cells, the production cell and
    the one-card cell.  Each writes its output to files in its own
    temporary directory, and a thread notes when it exits.
    ``run_multi`` collects them."""
    import tempfile
    import threading
    arch, shape = MULTI["d_prod"]
    jobs = {"smoke": ["-m", "repro_torch.launch.dryrun", "--smoke",
                      "--arch", "mamba2-780m", "--shape", "long_500k",
                      "--mesh", "both"],
            "production": ["-m", "repro_torch.launch.dryrun", "--arch",
                           arch, "--shape", shape, "--mesh", "single",
                           "--override",
                           f"n_layers={MULTI['d_prod_layers']}"],
            "one_card": ["-c", "import chip_smoke as c, json; "
                         "print(json.dumps(c.one_card_trace()))"]}
    bg = {}
    for name, args in jobs.items():
        out = Path(tempfile.mkdtemp(prefix=f"chip_smoke_dryrun_{name}_"))
        if args[0] == "-m":
            args = [*args, "--out", str(out / "records")]
        with open(out / "stdout", "w") as so, open(out / "stderr", "w") as se:
            proc = subprocess.Popen([sys.executable, *args], stdout=so,
                                    stderr=se, text=True, env=_env_src(),
                                    cwd=ROOT)
        job = {"proc": proc, "out": out, "t0": time.perf_counter(),
               "args": args}
        threading.Thread(target=lambda j=job: j.update(
            rc=j["proc"].wait(), t1=time.perf_counter()), daemon=True
        ).start()
        bg[name] = job
    return bg


def _collect(bg: dict, name: str, timeout: float = 900):
    """(stdout, wall s from start to exit, records) of a background job;
    it must exit 0 (else its records' errors and its stderr are
    shown)."""
    import shutil
    job = bg.pop(name)
    proc, out = job["proc"], job["out"]
    try:
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    time.sleep(0.01)                    # the waiter thread's timestamp
    wall = job.get("t1", time.perf_counter()) - job["t0"]
    stdout = (out / "stdout").read_text()
    stderr = (out / "stderr").read_text()
    recs = [json.loads(p.read_text())
            for p in sorted((out / "records").glob("*.json"))]
    shutil.rmtree(out, ignore_errors=True)
    errors = [{k: r.get(k) for k in ("arch", "shape", "mesh", "error",
                                      "first_failing_op", "trace")}
              for r in recs if r.get("status") == "error"]
    check(proc.returncode == 0, f"(d) {name}: {' '.join(job['args'])} "
          f"exited {proc.returncode}:\n{stdout[-2000:]}\n"
          f"{json.dumps(errors)[-6000:]}\n{stderr[-2000:]}")
    return stdout, wall, recs


def stop_multi_background(bg: dict) -> None:
    import shutil
    for job in bg.values():
        if job["proc"].poll() is None:
            job["proc"].kill()
            job["proc"].wait()
        shutil.rmtree(job["out"], ignore_errors=True)
    bg.clear()


def print_dryrun_records(recs, tag: str, card: str) -> None:
    for rec in recs:
        check(rec["status"] == "ok" and rec["device"] == "cuda",
              f"{tag} {rec['arch']} {rec['shape']} {rec['mesh']}: {rec}")
        r, mem = rec["roofline"], rec["memory"]
        print(f"{tag} {rec['arch']} {rec['shape']} {rec['mesh']} "
              f"{rec['mesh_shape']}: peak_estimate {mem['peak_estimate']} "
              f"B, flops_per_device {rec['cost']['flops_per_device']!r}, "
              f"link bytes {rec['collectives']['link_bytes_per_device']!r}"
              f", {rec['collectives']['by_op']}, dominant {r['dominant']}, "
              f"trace {rec['trace_s']} s, reshards {rec['reshards']}")


def multi_dryrun(bg: dict, card: str,
                 measured_peak_gb: float | None) -> dict:
    """29 (d): the background dry runs' records, and the one-card cell
    against a ``FlopCounterMode`` count of the real step on the card and
    beside phase 28 (a)'s measured peak."""
    import dataclasses
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as S_
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamWConfig, adamw_init

    out = {}
    _, wall, recs = _collect(bg, "smoke")
    check(len(recs) == 2 and {r["mesh"] for r in recs} == {"single",
                                                          "multi"},
          f"(d) smoke records: {recs}")
    print_dryrun_records(recs, "[multi] (d) smoke", card)
    for rec in recs:
        check(rec["n_devices"] == 16 and rec["memory"]["peak_estimate"] > 0
              and rec["roofline"]["dominant"] in ("compute_s", "memory_s",
                                                  "collective_s"),
              f"(d) smoke criterion: {rec}")
    print(f"[multi] (d) smoke: exit 0, wall {wall!r} s on {card}")
    out["d_smoke_wall_s"] = wall
    _, wall, recs = _collect(bg, "production")
    print_dryrun_records(recs, "[multi] (d) production", card)
    check(len(recs) == 1 and recs[0]["n_devices"] == 256,
          f"(d) production records: {recs}")
    print(f"[multi] (d) production cell at {MULTI['d_prod_layers']} "
          f"layers: exit 0, wall {wall!r} s (its trace "
          f"{recs[0]['trace_s']} s, then the one-unit trace) on {card}")
    out.update(d_prod_wall_s=wall,
               d_prod_peak=recs[0]["memory"]["peak_estimate"])
    stdout, wall, _ = _collect(bg, "one_card")
    rec = json.loads(stdout.strip().splitlines()[-1])
    cfg = dataclasses.replace(get_config(MULTI["b_arch"]), grad_accum=1)
    B, S, dev = MULTI["d_batch"], MULTI["d_seq"], "cuda"
    model = T.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    opt = adamw_init(dict(model.named_parameters()))
    rng = np.random.default_rng(30)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (B, S + 1)).astype(np.int32)).to(dev)}
    counter = FlopCounterMode(display=False)
    with counter:
        S_.make_train_step(cfg, AdamWConfig())(model, opt, batch)
    real_flops = counter.get_total_flops()
    del model, opt, batch
    torch.cuda.empty_cache()
    peak_gb = rec["peak_estimate"] / 1e9
    print(f"[multi] (d) one-card cell {cfg.name} train B {B} × S {S}, "
          f"grad_accum {cfg.grad_accum}, (1, 1) mesh: flops_per_device "
          f"{rec['flops']!r}, FlopCounterMode on the real step "
          f"{real_flops!r}; peak_estimate {peak_gb!r} GB (args "
          f"{rec['argument_bytes'] / 1e9!r}, temp {rec['temp_bytes'] / 1e9!r}"
          f", out {rec['output_bytes'] / 1e9!r}, alias "
          f"{rec['alias_bytes'] / 1e9!r}); trace {rec['trace_s']!r} s, "
          f"process {wall!r} s on {card}")
    check(rec["flops"] == real_flops, f"(d) the dry run counts "
          f"{rec['flops']} FLOPs, the real step {real_flops}")
    out.update(d_one_flops=rec["flops"], d_one_peak_gb=peak_gb,
               d_one_trace_s=rec["trace_s"])
    if measured_peak_gb is not None:
        ratio = peak_gb / measured_peak_gb
        lo, hi = MULTI_PEAK_RATIO
        print(f"[multi] (d) peak_estimate / phase 28 (a)'s "
              f"max_memory_allocated {measured_peak_gb!r} GB = {ratio!r} "
              f"(held to [{lo}, {hi}]) on {card}")
        check(lo <= ratio <= hi, f"(d) peak ratio {ratio} outside "
              f"[{lo}, {hi}]")
        out["d_peak_ratio"] = ratio
    return out


def run_multi(card: str, measured_peak_gb: float | None,
              bg: dict) -> dict:
    """Phase 29: the multi-device modules and the quickstart twin on the
    card (``MULTI``), (a)-(d); ``bg``: ``start_multi_background``'s
    jobs."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config

    spec = MULTI
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    try:
        numbers = multi_quickstart(card)
        try:
            cfg = dataclasses.replace(get_config(spec["b_arch"]),
                                      dtype="float32")
            numbers.update(multi_partition(cfg, spec["b_prompt"],
                                           spec["b_steps"], card))
            torch.cuda.empty_cache()
            cfg = dataclasses.replace(get_config(spec["c_arch"]),
                                      dtype="bfloat16")
            numbers.update(multi_pipeline(cfg, spec["c_batch"],
                                          spec["c_seq"], spec["c_micro"],
                                          card))
        finally:
            _end_world1()
        torch.cuda.empty_cache()
        numbers.update(multi_dryrun(bg, card, measured_peak_gb))
    finally:
        stop_multi_background(bg)
    print(f"[multi] phase 29 wall {time.perf_counter() - t_phase!r} s "
          f"(after phase 28; its dry runs started before phase 27)")
    return numbers


def overlap_check(card: str) -> int:
    """``chip_smoke.py --overlap-check``: phases 27 and 28 four times in
    one process, alone, beside, beside, alone, where "beside" runs them
    as ``main`` does, with phase 29's dry runs started just before and
    stopped just after.  Prints each pass's times (the phases' ``_ms``
    and ``_s`` numbers and their wall) and, for each, the mean beside
    over the mean alone."""
    import torch
    rows = []
    for how in ("alone", "beside", "beside", "alone"):
        bg = start_multi_background() if how == "beside" else {}
        t0 = time.perf_counter()
        try:
            got = {f"27_{k}": v for k, v in run_lm27(card).items()}
            got.update({f"28_{k}": v for k, v in
                        run_train(card)["numbers"].items()})
        finally:
            stop_multi_background(bg)
        got = {k: v for k, v in got.items()
               if k.endswith(("_ms", "_s")) and isinstance(v, float)}
        got["wall_s"] = time.perf_counter() - t0
        print(f"[overlap] {how}: {json.dumps(got)} on {card}", flush=True)
        rows.append((how, got))
        torch.cuda.empty_cache()
    for key in rows[0][1]:
        alone, beside = (statistics.mean(t[key] for h, t in rows if h == w)
                         for w in ("alone", "beside"))
        print(f"[overlap] {key}: alone {alone!r}, beside {beside!r}, "
              f"beside / alone {beside / alone!r}")
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 2
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
    if sys.argv[1:] == ["--overlap-check"]:
        return overlap_check(card)

    expect = {"fig9": FIG9_K, "koln": KOLN_K, "fig9_d2": FIG9_D2_K}
    out = run("cuda", FIG9, 541_222, TRUNC, expect)
    out2 = run_slice2("cuda", FIG9, MASK, 541_222, WINDOW, KOLN_WINDOW,
                      expect)
    out3 = run_slice3("cuda", ZAMBA2)
    host_phase(card)
    out4 = run_slice4("cuda", FIG9, 541_222, DYN, expect)
    out5 = run_slice5("cuda", FIG9, 541_222, WINDOW, KOLN_WINDOW, expect)
    out6 = run_slice6("cuda", SERVE)
    out7 = run_slice7("cuda", FIG9, 541_222, DYN, expect)
    run_audit(card)
    run_lm(card)
    bg = start_multi_background()
    try:
        run_lm27(card)
        out8 = run_train(card)
    except BaseException:
        stop_multi_background(bg)
        raise
    run_multi(card, out8["numbers"]["a_peak_gb"], bg)
    for kname, count in {**out["launches"], **out2["launches"],
                         **out3["launches"], **out4["launches"],
                         **out5["launches"], **out6["launches"],
                         **out7["launches"], **out8["launches"]}.items():
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
    sh3 = out3["shapes"]
    for key, ms in out3["times"].items():
        print(f"[time] {key}: {ms!r} ms (median of {REPS}; {sh3}) on {card}")
    sh4 = out4["shapes"]
    for key, ms in out4["times"].items():
        print(f"[time] {key}: {ms!r} ms (median of {REPS}, ticks of "
              f"{DYN['ticks']} at d = 1, {DYN['d2_ticks']} at d = 2; "
              f"{sh4}) on {card}")
    sh5 = out5["shapes"]
    for key, ms in out5["times"].items():
        bound = out5["bounds"].get(key)
        print(f"[time] {key}: {ms!r} ms (median of {REPS}; "
              + (f"bound {bound!r} ms; " if bound is not None else "")
              + f"{sh5}) on {card}")
    for key, us in out6["times"].items():
        print(f"[time] {key}: {us!r} us (serving at {SERVE}: percentiles "
              f"over the steady ticks, batch_* medians of {REPS}) on {card}")
    for key, ms in out7["times"].items():
        print(f"[time] {key}: {ms!r} ms (median of {REPS}; "
              f"{out7['shapes']}) on {card}")
    for key, ms in out8["times"].items():
        print(f"[time] {key}: {ms!r} ms (median of {REPS}) on {card}")
    print(json.dumps({"kernels": out["kernels"] + out2["kernels"]
                      + out3["kernels"] + out4["kernels"]
                      + out7["kernels"] + out8["kernels"]}))
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
