"""Findings and the JSON report shared by every pass of the port's auditor.

The port's counterpart of the JAX package's ``analysis/report.py``.  A
*finding* is one defect: the pass that found it, a stable code (the
tests and the seeded-defect corpus key on these), the audited target and
a message.  The *report* holds the findings, a per-pass log of every
target audited (so "no findings" is told apart from "nothing ran"), and
the checks that were not run, each with its reason: a check that needs
the card is listed there on a ``--device cpu`` run, never counted as
clean.

Codes, beside the reference's (stable API):

=======================  ====================  ===========================
reference                port                  what the port checks
=======================  ====================  ===========================
``J_INT32_INDEX``        ``T_INT32_INDEX``     an int32 tensor with a dim,
                                               or an int32 ``arange`` whose
                                               end, past INT32_MAX once the
                                               probe's dims are scaled to
                                               the row's target
``J_F64``                ``T_F64``             a float64 tensor made by an
                                               op on a plan method's torch
                                               path, unless ``F64_ALLOWED``
                                               names it with a reason
``J_DTYPE_CONTRACT``     ``T_DTYPE_CONTRACT``  a plan method's outputs
                                               against ``OUT_DTYPES``
``J_CALLBACK``           ``T_HOST_SYNC``       more host syncs in a plan
                                               method than its budget
—                        ``T_SYNC_COUNT``      on the card, the audit's sync
                                               count of a cuda-backend row
                                               against ``torch.cuda.
                                               set_sync_debug_mode``: a
                                               fault of the audit itself
``J_WEAK_OUT``,          none                  torch has no weak types and
``J_RANK_PROMOTION``                           no switch that forbids
                                               broadcasting
``K_VMEM_BUDGET``        ``K_SMEM_BUDGET``     a launch's shared memory
                                               (static + dynamic) above the
                                               card's opt-in limit a block
``K_OOB_INDEX_MAP``      ``K_INT32_ARG``,      a launch argument typed
                         ``K_LAUNCH_LIMIT``    ``c_int`` outside int32
                                               (ctypes would wrap it); a
                                               grid or block past the
                                               card's limits
``K_WRITE_HAZARD``       none                  CUDA writes are placed by
                                               thread index inside the
                                               kernel, out of a static
                                               audit's sight; chip_smoke's
                                               bit-equality with the plain
                                               versions covers them
—                        ``K_SIGNATURE``       ``_build.SIGNATURES`` against
                                               each ``csrc/*.cu`` ``extern
                                               "C"`` prototype (argument
                                               count, each type's width and
                                               kind, the return type)
``K_ROUTE_DRIFT``        ``K_ROUTE_DRIFT``     ``ops.emit_route_bytes``
                                               against the bytes the
                                               resident and streaming
                                               routes hand their kernels
                                               for random access
``K_NO_CAPTURE``         ``K_NO_CAPTURE``      a kernel-matrix entry that
                                               ran and captured no launch
—                        ``K_SPILL``           a kernel function with local
                                               (spill) bytes: a warning
``R_GROW_BOUND``         ``S_GROW_BOUND``      a grow resolver past the
                                               O(lg K) distinct-capacity
                                               bound
``R_STEADY_STATE``       ``S_STEADY_STATE``    a second identical call broke
                                               ``steady_state``
``L_DEPRECATED``,        the same              as the reference, with
``L_EMPTY_GUARD``,                             ``_build.launch`` in place of
``L_MODULE_DOCSTRING``                         ``pallas_call``
=======================  ====================  ===========================

The passes run in the order of ``PASSES``: ``trace`` (the plan matrix
under the dispatch capture), ``kernel`` (prototypes, the route model,
the launch capture and the compiled functions), ``steady`` (grow bounds
and the live steady-state probes) and ``lint`` (the AST rules).
"""
from __future__ import annotations

import dataclasses

PASSES = ("trace", "kernel", "steady", "lint")


@dataclasses.dataclass(frozen=True)
class Finding:
    pass_name: str     # one of PASSES
    code: str          # stable machine-readable defect code (above)
    target: str        # what was audited (matrix row, kernel, file:line)
    message: str       # human-readable detail
    severity: str = "error"   # "error" fails the audit; "warning" does not

    def __str__(self) -> str:
        return (f"[{self.pass_name}/{self.code}] {self.target}: "
                f"{self.message}")


class Report:
    """Findings, audit coverage and the checks not run, as JSON."""

    def __init__(self, device: str = "cpu") -> None:
        self.device = device
        self.findings: list[Finding] = []
        self.audited: dict[str, list[str]] = {p: [] for p in PASSES}
        self.not_run: dict[str, str] = {}
        # what run_all read on the way, beside the findings: each plan
        # method's counts, the audited launches with their geometry, the
        # launches of each kernel-matrix entry, the compiled functions'
        # resources, the card's limits and the wall time
        self.plan_counts: dict = {}
        self.launches: list = []
        self.kernel_entries: dict = {}
        self.resources: dict = {}
        self.limits: dict | None = None
        self.seconds: float | None = None

    def add(self, pass_name: str, code: str, target: str, message: str,
            severity: str = "error") -> Finding:
        f = Finding(pass_name, code, target, message, severity)
        self.findings.append(f)
        return f

    def note_audit(self, pass_name: str, target: str) -> None:
        self.audited.setdefault(pass_name, []).append(target)

    def note_not_run(self, check: str, reason: str) -> None:
        self.not_run[check] = reason

    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    def ok(self) -> bool:
        return not self.errors()

    def findings_for(self, pass_name: str | None = None,
                     target_substr: str | None = None) -> list[Finding]:
        out = self.findings
        if pass_name is not None:
            out = [f for f in out if f.pass_name == pass_name]
        if target_substr is not None:
            out = [f for f in out if target_substr in f.target]
        return out

    def codes(self) -> set[str]:
        return {f.code for f in self.findings}

    def to_dict(self) -> dict:
        return {
            "ok": self.ok(),
            "n_findings": len(self.findings),
            "n_errors": len(self.errors()),
            "audited": {p: sorted(t) for p, t in self.audited.items()},
            "findings": [dataclasses.asdict(f) for f in self.findings],
            "device": self.device,
            "not_run": dict(sorted(self.not_run.items())),
        }

    def summary(self) -> str:
        lines = [f"static analysis summary (device {self.device}):"]
        for p in PASSES:
            n_aud = len(self.audited.get(p, []))
            n_find = len(self.findings_for(p))
            lines.append(f"  {p:8s} audited {n_aud:4d} target(s), "
                         f"{n_find} finding(s)")
        for f in self.findings:
            lines.append(f"  {f}")
        for check, reason in sorted(self.not_run.items()):
            lines.append(f"  not run: {check} ({reason})")
        lines.append("RESULT: " + ("OK" if self.ok() else "FINDINGS"))
        return "\n".join(lines)
