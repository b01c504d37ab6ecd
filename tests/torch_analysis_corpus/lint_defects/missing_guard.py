"""Seeded lint defect: a kernel wrapper taking ``max_pairs`` that
launches through ``_build.launch`` with no ``max_pairs == 0``
short-circuit (an empty buffer launches nothing).  Scanned as text by
the corpus lint cases; never imported."""
import torch

from repro_torch.kernels import _build


def emit_pairs(offs, counts, starts, perm_s, perm_u, *, max_pairs: int):
    out = torch.empty((max_pairs, 2), dtype=torch.int32, device=offs.device)
    lib = _build.load("emit")
    rc = _build.launch(offs.device, lib.twopass_emit_launch, offs.data_ptr(),
                       counts.data_ptr(), starts.data_ptr(),
                       perm_s.data_ptr(), perm_u.data_ptr(),
                       perm_s.shape[0], perm_u.shape[0], max_pairs,
                       out.data_ptr())
    _build.check(lib, "twopass_emit", rc)
    return out
