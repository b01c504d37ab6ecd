"""Hand-written CUDA kernels for Hopper (``csrc/``), their ``ctypes``
bindings, plain torch versions (``ref``) and main-path wrappers (``ops``).

Kernels build with ``nvcc`` at first use, never at import, so every
module here imports on a host with no card.
"""
from . import ref, sbm_sweep, emit, bfm, itm, ops, sparse_attn
