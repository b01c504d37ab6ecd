"""Warm start of the serving layer: its kernel libraries built and
loaded before the first query.

The JAX package's serving layer enables JAX's persistent compilation
cache so that a restarted process does not compile its executables
again.  The port runs eagerly and has no compiled executables to cache.
What a cold process pays instead is the build of its CUDA kernels: the
first call of a kernel runs ``nvcc`` unless its library, named by the
hash of its source and flags, is already in ``build/repro_torch/``, and
then loads it (``kernels._build``).  ``enable`` does both up front for
the kernels the serving path launches, so the first query pays neither,
and a restarted process finds the libraries built.
"""
from __future__ import annotations

from ..core.regions import resolve_device
from ..kernels import _build

# the kernels a serving query batch launches: K8, the tree walk
SERVE_KERNELS = ("itm_walk",)


def enable(device="cuda") -> tuple[str, ...]:
    """Build and load the serving kernels for ``device`` (idempotent).

    Returns the names of the libraries loaded: none for ``cpu``, where
    the wrappers run their plain versions.  ``cuda`` on a host without a
    card raises ``RuntimeError``, as do a missing ``nvcc`` and a failed
    build.
    """
    if resolve_device(device).type != "cuda":
        return ()
    return tuple(_build.build_all(SERVE_KERNELS))
