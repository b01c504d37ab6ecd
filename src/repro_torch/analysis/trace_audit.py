"""Trace pass — the ``T_*`` checks on the dispatch records of a plan method.

The port's counterpart of the JAX package's ``analysis/jaxpr_audit.py``.
Where the reference re-traced each executable abstractly, the port runs
each plan method once at the probe sizes under
``capture.capture_dispatch`` and reads the records:

``T_INT32_INDEX``
    An int32 output with a dimension longer than INT32_MAX, or an int32
    ``arange`` whose end passes it, once the probe's dims are mapped to
    the row's target scale (``scale_dims``): an index space that aliases
    silently at scale.  A record with a dim that maps to nothing above
    the largest probe size (a K-sized buffer, a tree of a power of two)
    is checked at probe scale and counted as such, never mis-scaled.

``T_F64``
    A float64 output of an op on the torch path, unless ``allowed``
    names the op with its reason.  The repo's contract is float32 and
    int32/int64; host NumPy is out of sight (see ``capture``).

``T_DTYPE_CONTRACT``
    A plan method's outputs against its declared types (``matrix.OUT_DTYPES``).

``T_HOST_SYNC``
    More records that sync on the card (``DispatchRecord.sync``) than
    the method's budget: what it does today, measured once and written
    down (``matrix.SYNC_BUDGETS``).  A regression above it is a finding.

The probe sizes are distinct primes (``matrix.PROBE``), so every derived
dim (n, m, n+m, n+m+1, 2(n+m), n·m, caps) has one meaning;
``dim_expressions`` and ``scale_dims`` are the reference's, copied.
"""
from __future__ import annotations

import torch

from .report import Report

INT32_MAX = 2 ** 31 - 1


def dim_expressions(n: int, m: int, cap: int) -> dict:
    """Candidate symbolic meanings of a probe dimension size."""
    return {
        "n": lambda s: s["n"],
        "m": lambda s: s["m"],
        "n+m": lambda s: s["n"] + s["m"],
        "n+m+1": lambda s: s["n"] + s["m"] + 1,
        "2n": lambda s: 2 * s["n"],
        "2m": lambda s: 2 * s["m"],
        "2(n+m)": lambda s: 2 * (s["n"] + s["m"]),
        "n*m": lambda s: s["n"] * s["m"],
        "cap": lambda s: s["cap"],
        "2cap": lambda s: 2 * s["cap"],
    }


def scale_dims(probe: dict, target: dict):
    """``dim_map`` rewriting probe dims to the target scale.

    Every derived dim has exactly one candidate meaning; unmatched dims
    (small constants like 1, 2, d) pass through unchanged.  Returns
    ``(dim_map, unresolved)``, where ``unresolved`` collects the dims
    above the largest probe size that matched nothing.
    """
    exprs = dim_expressions(**probe)
    table: dict = {}
    ambiguous: set = set()
    for name, fn in exprs.items():
        pv, tv = fn(probe), fn(target)
        if pv in table and table[pv] != tv:
            ambiguous.add(pv)
        table[pv] = tv
    floor = max(probe.values())
    unresolved: set = set()

    def dim_map(d: int) -> int:
        if d in ambiguous:
            unresolved.add(d)
            return d
        if d in table:
            return table[d]
        if d > floor:
            unresolved.add(d)
        return d

    return dim_map, unresolved


def _scaled(rec, dim_map, unresolved):
    """``(shapes, arange_end, scaled)`` of one record under ``dim_map``."""
    n0 = len(unresolved)
    shapes = [tuple(dim_map(d) for d in s) for s in rec.shapes]
    end = None if rec.arange_end is None else dim_map(rec.arange_end)
    if len(unresolved) > n0:
        return rec.shapes, rec.arange_end, False
    return shapes, end, True


def audit_records(records, *, target: str, report: Report,
                  probe: dict | None = None,
                  target_scale: dict | None = None,
                  allowed: dict | None = None,
                  sync_budget: int | None = None) -> dict:
    """``T_INT32_INDEX``, ``T_F64`` and ``T_HOST_SYNC`` on one method's
    records; returns counts: ops, scaled, probe_scale, syncs."""
    allowed = allowed or {}
    dim_map = unresolved = None
    if probe is not None and target_scale is not None:
        dim_map, unresolved = scale_dims(probe, target_scale)
    n_scaled = n_probe = 0
    syncs = []
    f64_ops: set = set()
    for rec in records:
        if rec.sync:
            syncs.append(f"{rec.op} ({rec.sync})")
        if torch.float64 in rec.dtypes and rec.op not in allowed:
            f64_ops.add(rec.op)
        shapes, end = rec.shapes, rec.arange_end
        if dim_map is not None:
            shapes, end, ok = _scaled(rec, dim_map, unresolved)
            n_scaled += ok
            n_probe += not ok
        for dt, shape in zip(rec.dtypes, shapes):
            if dt != torch.int32:
                continue
            if max(shape, default=0) > INT32_MAX or (
                    end is not None and end > INT32_MAX):
                report.add(
                    "trace", "T_INT32_INDEX", target,
                    f"{rec.op} makes an int32 tensor of shape {shape}"
                    + (f" (arange end {end})" if end is not None else "")
                    + f" at the target scale {target_scale}: past "
                    f"INT32_MAX = {INT32_MAX}, an int32 index space "
                    "aliases silently; widen to int64")
                break
    for op in sorted(f64_ops):
        report.add(
            "trace", "T_F64", target,
            f"'{op}' makes a float64 tensor on the torch path: the "
            "repo's contract is float32/int32/int64 — check for a Python "
            "float promotion, or allow it with a reason")
    if sync_budget is not None and len(syncs) > sync_budget:
        report.add(
            "trace", "T_HOST_SYNC", target,
            f"{len(syncs)} host sync(s) on the card, budget "
            f"{sync_budget}: " + "; ".join(syncs[:12])
            + (f"; … {len(syncs) - 12} more" if len(syncs) > 12 else ""))
    return {"ops": len(records), "scaled": n_scaled, "probe_scale": n_probe,
            "syncs": len(syncs)}


def _matches(value, want) -> bool:
    if want is int:
        return isinstance(value, int) and not isinstance(value, bool)
    if want == "pairs":
        from ..core.pairs import PairsResult
        if not isinstance(value, PairsResult):
            return False
        return value.decode(0, min(value.cap, 1)).dtype == torch.int32
    return isinstance(value, torch.Tensor) and value.dtype == want


def _name(want) -> str:
    return ("int" if want is int else "PairsResult of int32" if want ==
            "pairs" else str(want))


def audit_outputs(outputs, declared, *, target: str,
                  report: Report) -> None:
    """``T_DTYPE_CONTRACT``: each output against its declared type
    (``int``, ``"pairs"`` or a ``torch.dtype``; ``None`` takes any)."""
    outs = outputs if isinstance(outputs, tuple) else (outputs,)
    if len(outs) != len(declared):
        report.add("trace", "T_DTYPE_CONTRACT", target,
                   f"{len(outs)} output(s), the contract declares "
                   f"{len(declared)}")
        return
    for k, (value, want) in enumerate(zip(outs, declared)):
        if want is not None and not _matches(value, want):
            got = (value.dtype if isinstance(value, torch.Tensor)
                   else type(value).__name__)
            report.add("trace", "T_DTYPE_CONTRACT", target,
                       f"output {k} is {got} but the declared contract "
                       f"is {_name(want)}")
