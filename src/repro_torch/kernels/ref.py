"""Plain torch versions of the port's CUDA kernels.

Each function computes exactly what its kernel computes, with ordinary
tensor operations on any device.  The kernel wrappers take them for
tensors on the CPU, the CPU tests hold them against the JAX package's
Pallas kernels (interpret mode), and ``chip_smoke.py`` holds each CUDA
kernel against them on the card.  They are the very code the
``backend="torch"`` path runs (``core.sbm``), named after the kernels:

* ``sbm_sweep``    — K1's function, ``core.sbm._stream_contribs``
  (the JAX package's ``kernels/ref.py:sbm_sweep``);
* ``twopass_emit`` — K2's function, ``core.sbm._twopass_slots``
  (the slot loop of the JAX package's ``core/sbm.py:_twopass_emit``).
"""
from __future__ import annotations

from ..core.sbm import _stream_contribs as sbm_sweep
from ..core.sbm import _twopass_slots as twopass_emit

__all__ = ["sbm_sweep", "twopass_emit"]
