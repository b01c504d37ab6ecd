"""Seeded kernel-pass defects — stub signature tables, synthetic launch
records, a drifted route model, a wrapper that launches nothing and, on
the card, a real launch through an over-budget wrapper.
"""
import ctypes

import torch

from repro_torch.analysis import (LaunchBlocked, LaunchRecord,
                                  audit_emit_route_parity, audit_launch,
                                  capture_launches, check_signatures,
                                  launch_gate)
from repro_torch.analysis.capture import lookup_entry
from repro_torch.analysis.kernel_audit import device_limits
from repro_torch.analysis.matrix import audit_kernel_entry
from repro_torch.kernels import _build, emit

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _record(entry, args):
    lib, argtypes = lookup_entry(entry)
    return LaunchRecord(lib, entry, tuple(args), argtypes)


def _signature_one_argument_short(report, target):
    # twopass_emit_launch without its int m: every argument after n lands
    # in the wrong register
    stub = {"emit": {"twopass_emit_launch": (
        (_P, _P, _P, _P, _P, _I, _L, _P, _P), _I)}}
    check_signatures(report, signatures=stub)


def _signature_narrow_window_start(report, target):
    # csr_decode_launch's long long w0 bound as a c_int
    stub = {"csr_decode": {"csr_decode_launch": (
        (_P, _L, _P, _P, _I, _I, _I, _L, _P, _P), _I)}}
    check_signatures(report, signatures=stub)


def _c_int_given_2_31(report, target):
    # K2's n as 2^31 emitters: ctypes passes -2^31
    audit_launch(_record("twopass_emit_launch",
                         (0, 0, 0, 0, 0, 2 ** 31, 5, 1 << 20, 0)),
                 report=report)


def _dynamic_smem_240_kb(report, target):
    # K5 at a tile of 59,008 slots: 4·59,008 + 4112 = 240,144 B a block
    audit_launch(_record("emit_stream_launch",
                         (0, 1 << 16, 0, 0, 5, 5, 1 << 21, 59_008, 0)),
                 report=report)


def _grid_y_past_65535(report, target):
    # K7 with 70,000 batch·heads on gridDim.y
    audit_launch(_record("sparse_attn_launch",
                         (0, 0, 0, 0, 0, 0, 1, 70_000, 2048, 2048, 128,
                          128, 128, 0, 0.088)),
                 report=report)


def _route_model_off_by_two_words(report, target):
    # the resident model counting counts and starts as n + m + 1 entries
    # each (the port's model before this audit found it)
    def drifted(n, m):
        e = n + m
        return {"resident": 4 * (3 * (e + 1) + e), "streaming": 4 * e}

    audit_emit_route_parity(report, model=drifted)


def _entry_short_circuits(report, target):
    # a kernel-matrix entry whose wrapper returns before the launch
    t = torch.zeros(8, dtype=torch.int32)
    audit_kernel_entry(report, target, lambda: emit.twopass_emit(
        t[:7], t[:6], t[:6], t[:3], t[:3], max_pairs=0))


def _over_budget_wrapper_on_the_card(report, target):
    # a copy of K5's wrapper without its tile bound, at a tile of 59,008
    # slots (240,144 B of shared memory): the gate must refuse the launch
    # before it runs
    dev = torch.device("cuda")
    bl = 59_008
    tab = torch.zeros((4, emit.stream_window(bl)), dtype=torch.int32,
                      device=dev)
    tab[0] = emit.PAD_OFF
    perm = torch.zeros(5, dtype=torch.int32, device=dev)
    out = torch.full((1 << 20, 2), 7, dtype=torch.int32, device=dev)
    lib = _build.load("emit_stream")
    records = []
    gate = launch_gate(report, limits=device_limits(dev))
    try:
        with capture_launches(records, gate):
            _build.launch(dev, lib.emit_stream_launch, tab.data_ptr(),
                          tab.shape[1], perm.data_ptr(), perm.data_ptr(), 5,
                          5, out.shape[0], bl, out.data_ptr())
    except LaunchBlocked:
        pass
    torch.cuda.synchronize()
    if not bool((out == 7).all()):
        raise AssertionError("the refused launch wrote its buffer")


CASES = [
    dict(name="signature_one_argument_short", pass_name="kernel",
         code="K_SIGNATURE", audit=_signature_one_argument_short),
    dict(name="signature_narrow_window_start", pass_name="kernel",
         code="K_SIGNATURE", audit=_signature_narrow_window_start),
    dict(name="c_int_given_2_31", pass_name="kernel", code="K_INT32_ARG",
         audit=_c_int_given_2_31),
    dict(name="dynamic_smem_240_kb", pass_name="kernel",
         code="K_SMEM_BUDGET", audit=_dynamic_smem_240_kb),
    dict(name="grid_y_past_65535", pass_name="kernel",
         code="K_LAUNCH_LIMIT", audit=_grid_y_past_65535),
    dict(name="route_model_off_by_two_words", pass_name="kernel",
         code="K_ROUTE_DRIFT", audit=_route_model_off_by_two_words),
    dict(name="entry_short_circuits", pass_name="kernel",
         code="K_NO_CAPTURE", audit=_entry_short_circuits),
    dict(name="over_budget_wrapper_on_the_card", pass_name="kernel",
         code="K_SMEM_BUDGET", audit=_over_budget_wrapper_on_the_card,
         device="cuda"),
]
