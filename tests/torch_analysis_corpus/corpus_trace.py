"""Seeded trace-pass defects — small torch functions run under the
dispatch capture at the probe sizes, each with one hazard the trace
checks must flag at the target scale.
"""
import torch

from repro_torch.analysis import (PROBE, TARGETS, audit_outputs,
                                  audit_records, capture_dispatch)

N, M = PROBE["n"], PROBE["m"]


def _records(fn):
    records = []
    with capture_dispatch(records, "cpu"):
        out = fn()
    return records, out


def _int32_flat_pair_index(report, target):
    # the (n, m) pair space raveled to one int32 index: n·m = 1e12 at the
    # paper's regime
    records, _ = _records(lambda: torch.arange(N * M, dtype=torch.int32))
    audit_records(records, target=target, report=report, probe=PROBE,
                  target_scale=TARGETS["sbm"])


def _f64_promotion(report, target):
    lo = torch.rand(N)
    records, _ = _records(lambda: (lo.double() + 0.5).float())
    audit_records(records, target=target, report=report)


def _int64_query_ids(report, target):
    # a query() that forgot to cast its ids back to int32
    ids = torch.full((M, 4), -1, dtype=torch.int64)
    counts = torch.zeros(M, dtype=torch.int32)
    audit_outputs((ids, counts), (torch.int32, torch.int32), target=target,
                  report=report)


def _count_reads_k_twice(report, target):
    # a count() that reads K to the host twice, against its budget of one
    c = torch.arange(N, dtype=torch.int32)

    def count():
        k = int(c.sum())
        return k if k == int(c.sum(dtype=torch.int64)) else -1
    records, _ = _records(count)
    audit_records(records, target=target, report=report, sync_budget=1)


CASES = [
    dict(name="int32_flat_pair_index", pass_name="trace",
         code="T_INT32_INDEX", audit=_int32_flat_pair_index),
    dict(name="float64_promotion", pass_name="trace", code="T_F64",
         audit=_f64_promotion),
    dict(name="int64_query_ids", pass_name="trace",
         code="T_DTYPE_CONTRACT", audit=_int64_query_ids),
    dict(name="count_reads_k_twice", pass_name="trace",
         code="T_HOST_SYNC", audit=_count_reads_k_twice),
]
