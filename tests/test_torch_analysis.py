"""The port's auditor (``repro_torch.analysis``) on the CPU.

Parity: the pure-Python parts the port keeps its own copies of
(``grow_bound``, ``adversarial_k_stream``, ``scale_dims``,
``dim_expressions``, ``lint_source``, the report's JSON keys) and the
engine's grow resolvers are held to ``repro.analysis`` and
``repro.core.engine``.  Behaviour: the seeded-defect corpus, the capture
hooks, the repo audit and the CLI with ``--device cpu``, and the two
repairs the audit led to (the resident route's byte model, K7's C int
arguments).  The card half is in ``tests/test_torch_cuda.py``.
"""
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import jaxpr_audit as ref_jaxpr  # noqa: E402
from repro.analysis import lint as ref_lint  # noqa: E402
from repro.analysis import report as ref_report  # noqa: E402
from repro.analysis import retrace as ref_retrace  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402

from repro_torch.analysis import (LaunchBlocked, Report,  # noqa: E402
                                  adversarial_k_stream,
                                  audit_emit_route_parity, audit_launch,
                                  audit_records, capture_dispatch,
                                  capture_launches, dim_expressions,
                                  grow_bound, lint_source, parse_prototypes,
                                  scale_dims)
from repro_torch.analysis import matrix, steady  # noqa: E402
from repro_torch.analysis.capture import lookup_entry  # noqa: E402
from repro_torch.analysis.corpus import run_corpus  # noqa: E402
from repro_torch.analysis.__main__ import main  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import bfm as tbfm  # noqa: E402
from repro_torch.kernels import emit as temit  # noqa: E402
from repro_torch.kernels import sparse_attn as tsa  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CORPUS = REPO / "tests" / "torch_analysis_corpus"
REF_DEFECTS = REPO / "tests" / "analysis_corpus" / "lint_defects"
# the codes of the port's table (``repro_torch/analysis/report.py``)
PORT_CODES = ("T_INT32_INDEX", "T_F64", "T_DTYPE_CONTRACT", "T_HOST_SYNC",
              "K_SMEM_BUDGET", "K_INT32_ARG", "K_LAUNCH_LIMIT",
              "K_SIGNATURE", "K_ROUTE_DRIFT", "K_NO_CAPTURE", "S_GROW_BOUND",
              "S_STEADY_STATE", "L_DEPRECATED", "L_EMPTY_GUARD",
              "L_MODULE_DOCSTRING")


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_k", [1, 2, 257, 1 << 20])
def test_grow_bound_and_k_stream_equal_the_reference(max_k):
    assert grow_bound(max_k) == ref_retrace.grow_bound(max_k)
    assert adversarial_k_stream(max_k) == ref_retrace.adversarial_k_stream(
        max_k)


def _ref_plan(**kw):
    return ref_engine.MatchPlan(ref_engine.MatchSpec(capacity="grow", **kw),
                                64, 64, 1)


REF_RESOLVERS = {
    "MatchPlan._resolve_cap[grow]": lambda: _ref_plan()._resolve_cap,
    "MatchPlan._resolve_query_cap[grow]":
        lambda: _ref_plan()._resolve_query_cap,
    "MatchPlan._resolve_cap_dev[grow]":
        lambda: _ref_plan(backend="distributed")._resolve_cap_dev,
}


@pytest.mark.parametrize("target,factory", steady.RESOLVERS,
                         ids=[t for t, _ in steady.RESOLVERS])
def test_resolver_capacities_equal_the_reference(target, factory):
    max_k = 1 << 20
    got = steady.distinct_capacities(factory(), max_k)
    want = steady.distinct_capacities(REF_RESOLVERS[target](), max_k)
    assert got == want
    assert len(got) <= grow_bound(max_k)
    report = Report()
    steady.audit_grow_bound(factory, max_k=max_k, target=target,
                            report=report)
    assert not report.findings


@pytest.mark.parametrize("algo", ["bfm", "sbm"])
def test_scale_dims_and_dim_expressions_equal_the_reference(algo):
    probe, target = matrix.PROBE, matrix.TARGETS[algo]
    ours, theirs = dim_expressions(**probe), ref_jaxpr.dim_expressions(
        **probe)
    assert list(ours) == list(theirs)
    for name in ours:
        assert ours[name](probe) == theirs[name](probe)
        assert ours[name](target) == theirs[name](target)
    (f, un), (g, ref_un) = (scale_dims(probe, target),
                            ref_jaxpr.scale_dims(probe, target))
    dims = range(0, 2 * probe["n"] * probe["m"] + 3)
    assert [f(d) for d in dims] == [g(d) for d in dims]
    assert un == ref_un and un


@pytest.mark.parametrize("name", ["uses_deprecated.py",
                                  "bare_serve_module.py"])
def test_lint_source_yields_the_reference_code_line_pairs(name):
    src = (REF_DEFECTS / name).read_text()
    ours, theirs = Report(), ref_report.Report()
    lint_source(src, path=f"src/repro_torch/serve/{name}", report=ours)
    ref_lint.lint_source(src, path=f"src/repro/serve/{name}",
                         report=theirs)
    pairs = sorted((f.code, f.target.rsplit(":", 1)[1])
                   for f in ours.findings)
    assert pairs and pairs == sorted((f.code, f.target.rsplit(":", 1)[1])
                                     for f in theirs.findings)


def test_report_json_has_the_reference_keys():
    ours, theirs = Report(), ref_report.Report()
    for r in (ours, theirs):
        r.add("lint", "L_DEPRECATED", "x.py:1", "m")
        r.note_audit("lint", "x.py")
    d = ours.to_dict()
    assert set(theirs.to_dict()) <= set(d)
    assert {k: d[k] for k in ("ok", "n_findings", "n_errors")} == {
        k: theirs.to_dict()[k] for k in ("ok", "n_findings", "n_errors")}
    assert d["findings"] == theirs.to_dict()["findings"]
    lines = ours.summary().splitlines()
    assert lines[-1] == "RESULT: FINDINGS" and "lint" in lines[4]


# ---------------------------------------------------------------------------
# behaviour
# ---------------------------------------------------------------------------

def test_corpus_every_seeded_defect_is_flagged_with_its_code():
    results = run_corpus(CORPUS, device="cpu")
    ran = [r for r in results if r.ran]
    assert ran and all(r.detected and r.error is None for r in ran), [
        (r.name, r.got_codes, r.error) for r in ran if not r.ok]
    assert set(PORT_CODES) <= {r.code for r in ran}
    not_run = [r.name for r in results if not r.ran]
    assert not_run == ["over_budget_wrapper_on_the_card"]


def test_launch_capture_records_and_gates_before_the_launch():
    def twopass_emit_launch(*args):          # a stand-in entry point
        raise AssertionError("the gated launch must not run")

    def gate(rec):
        raise LaunchBlocked(rec.target)

    records = []
    real = _build.launch
    with pytest.raises(LaunchBlocked, match="emit.twopass_emit_launch"):
        with capture_launches(records, gate):
            _build.launch(None, twopass_emit_launch, 1, 2, 3, 4, 5, 6, 7,
                          1 << 20, 9)
    assert _build.launch is real
    (rec,) = records
    assert (rec.lib, rec.entry, rec.args[7]) == ("emit",
                                                 "twopass_emit_launch",
                                                 1 << 20)
    assert rec.argtypes[5:8] == (ctypes.c_int, ctypes.c_int,
                                 ctypes.c_longlong)


def test_capture_hooks_are_restored_after_an_exception():
    from torch.utils._python_dispatch import _get_current_dispatch_mode
    real = (_build.launch, torch.Tensor.tolist, torch.Tensor.cpu)
    with pytest.raises(RuntimeError, match="inside"):
        with capture_launches([]):
            with capture_dispatch([]):
                assert torch.Tensor.tolist is not real[1]
                raise RuntimeError("inside")
    assert (_build.launch, torch.Tensor.tolist, torch.Tensor.cpu) == real
    assert _get_current_dispatch_mode() is None


def test_dispatch_capture_marks_the_ops_that_sync_on_the_card():
    x = torch.arange(10, dtype=torch.int32)
    records = []
    with capture_dispatch(records, "cpu"):
        y = (x * 2 + 1).sum()                 # no sync
        int(y)                                # host read
        x.tolist()                            # host read (no aten op)
        torch.nonzero(x > 3)                  # data-dependent shape
        x[x > 5]                              # boolean mask index
        torch.arange(7, dtype=torch.int32)
    syncs = [(r.op, r.sync) for r in records if r.sync]
    assert [op.split(".")[1] for op, _ in syncs] == [
        "_local_scalar_dense", "tolist", "nonzero", "index"]
    assert records[-1].arange_end == 7
    report = Report()
    counts = audit_records(records, target="t", report=report,
                           sync_budget=3)
    assert counts["syncs"] == 4 and report.codes() == {"T_HOST_SYNC"}


def test_int32_check_scales_resolved_dims_and_keeps_unresolved_at_probe():
    n, m = matrix.PROBE["n"], matrix.PROBE["m"]
    records = []
    with capture_dispatch(records, "cpu"):
        torch.zeros(n + m, dtype=torch.int32)        # n+m: scaled, fine
        torch.zeros(4 * n * m, dtype=torch.int32)    # unresolved: probe
    report = Report()
    counts = audit_records(records, target="t", report=report,
                           probe=matrix.PROBE,
                           target_scale=matrix.TARGETS["sbm"])
    assert (counts["scaled"], counts["probe_scale"]) == (1, 1)
    assert not report.findings


def test_prototype_parser_reads_kinds_widths_and_returns():
    src = """
    int helper(int x) { return x; }
    extern "C" {
    // a comment with int f(long long) {
    const char* f_strerror(int code) { return ""; }
    int f_tile() { return 4; }
    /* block */ long long f_smem(int a, unsigned b) { return 0; }
    int f_launch(const float* __restrict__ a, long long n, float k,
                 unsigned char* out, void* stream) {
      if (n) { return 1; }
      return 0;
    }
    }  // extern "C"
    """
    p = parse_prototypes(src)
    assert set(p) == {"f_strerror", "f_tile", "f_smem", "f_launch"}
    assert p["f_strerror"] == ((("int", 4),), ("pointer", 8))
    assert p["f_tile"] == ((), ("int", 4))
    assert p["f_smem"] == ((("int", 4), ("uint", 4)), ("int", 8))
    assert p["f_launch"][0] == (("pointer", 8), ("int", 8), ("float", 4),
                                ("pointer", 8), ("pointer", 8))


def test_launch_models_at_the_production_shapes_are_in_budget():
    def rec(entry, *args):
        lib, types = lookup_entry(entry)
        return type("R", (), dict(lib=lib, entry=entry, args=args,
                                  argtypes=types,
                                  target=f"{lib}.{entry}"))()

    report = Report()
    k5 = audit_launch(rec("emit_stream_launch", 0, 1 << 16, 0, 0, 10 ** 6,
                          10 ** 6, 1 << 21, 4096, 0), report=report)
    assert k5["smem"] == 4 * 4096 + 4112 and k5["grid"][0] == 512
    k2 = audit_launch(rec("twopass_emit_launch", 0, 0, 0, 0, 0, 10 ** 5,
                          10 ** 5, 1 << 20, 0), report=report)
    assert k2["smem"] == 4 * 1024 + 3084   # 2^20 slots: 1024-slot tiles
    k7 = audit_launch(rec("sparse_attn_launch", 0, 0, 0, 0, 0, 0, 1, 8,
                          2048, 2048, 128, 128, 128, 256, 0.088),
                      report=report)
    assert k7 == {"grid": (32, 8, 1), "block": 128, "smem": 87_040,
                  "kernel": "sparse_attn_tc_kernelILi128E"}
    k8 = audit_launch(rec("itm_walk_launch", *[0] * 10, 64, 8192, 0, 0, 1),
                      report=report)
    assert k8 == {"grid": (64, 1, 1), "block": 512, "smem": 159_812,
                  "kernel": "walk_per_ctaILb0E"}
    assert not report.findings


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    out = tmp_path_factory.mktemp("audit") / "report.json"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--device", "cpu",
         "--json", str(out)], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    return proc, out


def test_cli_on_the_cpu_exits_0_and_lists_the_card_checks_as_not_run(cli):
    proc, out = cli
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    report = json.loads(out.read_text())
    assert report["device"] == "cpu"
    assert set(report["not_run"]) == set(matrix.CARD_ONLY)
    assert "not run: sync cross-check" in proc.stdout
    corpus = report["corpus"]
    assert corpus["n_missed"] == 0 and corpus["n_not_run"] == 1
    assert corpus["n_cases"] >= len(PORT_CODES)


def test_repo_audit_on_the_cpu_is_clean_and_every_pass_ran(cli):
    _, out = cli
    report = json.loads(out.read_text())
    assert report["ok"] and report["n_errors"] == 0, report["findings"]
    assert all(report["audited"][p] for p in ("trace", "kernel", "steady",
                                              "lint"))
    rows = [t for t in report["audited"]["trace"] if t.endswith("sync(s)")]
    assert len(rows) == len(matrix.SYNC_BUDGETS["cpu"])


def test_cli_without_a_card_raises():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        main(["--corpus", ""])


# ---------------------------------------------------------------------------
# the repairs the audit led to
# ---------------------------------------------------------------------------

def test_resident_route_model_equals_the_tensors_the_route_hands_k2():
    report = Report()
    audit_emit_route_parity(report)
    assert not report.findings, report.summary()
    assert report.audited["kernel"] == ["emit_route_parity:resident",
                                        "emit_route_parity:streaming"]


@pytest.mark.parametrize("arg", ["bq", "bkv", "sink_end"])
def test_sparse_attn_refuses_c_int_arguments_past_int32(arg):
    # the kernel takes bq, bkv and sink_end as a C int: 2^32 would arrive
    # as 0, so the wrapper refuses it on every device
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 128, 8)).astype(
        np.float32))      # checked only: a 2^32-key block is never built
    starts = torch.zeros(1, dtype=torch.int32)
    ends = torch.full((1,), 128, dtype=torch.int32)
    kw = dict(bq=128, bkv=128, sink_end=0)
    kw[arg] = 2 ** 32 + (128 if arg != "sink_end" else 0)
    with pytest.raises(ValueError, match="2147483647"):
        tsa._check(q, q, q, starts, ends, **kw)
    kw[arg] -= 2 ** 32                  # what a C int would have received
    tsa._check(q, q, q, starts, ends, **kw)


def _past_int32(dtype):
    # 2^31 entries of stride 0: the argument's size without its memory
    return torch.zeros(1, dtype=dtype).expand(2 ** 31)


def _emit_call(wrapper, arg):
    i32 = torch.int32
    perm = torch.zeros(2, dtype=i32)
    perm_s = _past_int32(i32) if arg == "n" else perm
    perm_u = _past_int32(i32) if arg == "m" else perm
    tab = torch.zeros((4, 512), dtype=i32)
    if wrapper == "twopass_emit":
        z = torch.zeros(5, dtype=i32)
        return lambda: temit.twopass_emit(z, z[:4], z[:4], perm_s, perm_u,
                                          max_pairs=4)
    if wrapper == "twopass_emit_streaming":
        block = 2 ** 31 if arg == "bl" else 128
        return lambda: temit.twopass_emit_streaming(
            tab, perm_s, perm_u, max_pairs=4, block=block)
    return lambda: temit.csr_decode_window(tab, perm_s, perm_u, 0, 4)


@pytest.mark.parametrize("wrapper,arg", [
    ("twopass_emit", "n"), ("twopass_emit", "m"),
    ("twopass_emit_streaming", "n"), ("twopass_emit_streaming", "m"),
    ("twopass_emit_streaming", "bl"),
    ("csr_decode_window", "n"), ("csr_decode_window", "m")])
def test_emit_wrappers_refuse_c_int_arguments_past_int32(wrapper, arg):
    # K2, K5 and K6 take n, m (and K5 its tile bl) as a C int: the wrapper
    # refuses 2^31 before its device branch, so on the CPU too
    with pytest.raises(ValueError, match=f"{wrapper}: {arg} = 2147483648 "
                       "must be <= 2147483647"):
        _emit_call(wrapper, arg)()


@pytest.mark.parametrize("wrapper", ["bfm_tile_counts", "bfm_mask"])
def test_bfm_wrappers_refuse_d_past_int32(wrapper):
    # K3 and K4 take d as a C int (n and m as long long)
    wide = torch.zeros((1, 1), dtype=torch.float32).expand(256, 2 ** 31)
    fn = getattr(tbfm, wrapper)
    with pytest.raises(ValueError, match=f"{wrapper}: d = 2147483648 must "
                       "be <= 2147483647"):
        fn(wide, wide, wide, wide)
    narrow = torch.zeros((256, 1), dtype=torch.float32)
    assert fn(narrow, narrow + 1, narrow, narrow + 1).sum() > 0
