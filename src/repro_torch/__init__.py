"""repro_torch: the DDM system (Marzolla & D'Angelo, 2019) ported to
PyTorch and hand-written CUDA kernels for one NVIDIA H100.

The JAX package ``repro`` beside it is the reference; this package
imports neither it nor JAX.  Entry points run on the card unless the
caller passes ``device="cpu"``.
"""
__version__ = "0.1.0"
