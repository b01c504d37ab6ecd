"""The port's auditor — plans, launches and kernels, checked.

``python -m repro_torch.analysis [--device cuda|cpu]`` runs four passes
over the port, as ``python -m repro.analysis`` does over the reference:

1. **trace** — every engine matrix row's plan methods run at the probe
   under a ``TorchDispatchMode`` (``capture.capture_dispatch``); int32
   index widths at the row's target scale, float64 ops, output types
   and host syncs against their written budgets.
2. **kernel** — ``_build.SIGNATURES`` against the ``extern "C"``
   prototypes of ``csrc/*.cu``, the emit-route byte model against the
   routes' tensors, and, on the card, K1–K8 launched at production
   shapes under the launch capture (int32 arguments, shared memory, grid
   and block limits, each launch checked before it runs) and every
   compiled function's registers, shared memory and spills.
3. **steady** — ``steady_state`` (the guard), the grow resolvers'
   O(lg K) bound and the live steady-state probes.
4. **lint** — the removed-shim ban, the ``max_pairs == 0`` guard before
   ``_build.launch`` and the module docstrings of ``serve``/``analysis``.

The seeded-defect corpus under ``tests/torch_analysis_corpus/`` keeps
the auditor honest: every entry must be flagged.  A check that needs
the card is listed as not run on a ``--device cpu`` run.
"""
from .capture import (DispatchRecord, LaunchBlocked, LaunchRecord,
                      capture_dispatch, capture_launches)
from .corpus import run_corpus
from .kernel_audit import (audit_emit_route_parity, audit_launch,
                           check_signatures, kernel_code, launch_gate,
                           parse_prototypes, pick, resources)
from .lint import lint_paths, lint_source
from .matrix import (OUT_DTYPES, PROBE, SYNC_BUDGETS, TARGETS,
                     audit_kernel_matrix, audit_plan_matrix,
                     audit_steady_matrix, run_all)
from .report import Finding, Report
from .steady import (SteadyStateError, adversarial_k_stream,
                     audit_grow_bound, grow_bound, steady_state)
from .trace_audit import (audit_outputs, audit_records, dim_expressions,
                          scale_dims)

__all__ = [
    "DispatchRecord", "Finding", "LaunchBlocked", "LaunchRecord",
    "OUT_DTYPES", "PROBE", "Report", "SYNC_BUDGETS", "SteadyStateError",
    "TARGETS", "adversarial_k_stream", "audit_emit_route_parity",
    "audit_grow_bound", "audit_kernel_matrix", "audit_launch",
    "audit_outputs", "audit_plan_matrix", "audit_records",
    "audit_steady_matrix", "capture_dispatch", "capture_launches",
    "check_signatures", "dim_expressions", "grow_bound", "kernel_code",
    "launch_gate", "lint_paths", "lint_source", "parse_prototypes", "pick",
    "resources", "run_all", "run_corpus", "scale_dims", "steady_state",
]
