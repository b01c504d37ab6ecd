"""Deprecated module path: the LM demo lives at
``repro_torch.launch.lm_serve`` (the port of the JAX package's
``launch/serve.py`` forwarder).

``repro_torch.serve`` is the DDM serving subsystem (``DDMServer``); the
LM prefill/decode launcher is ``repro_torch.launch.lm_serve``, so the two
cannot be confused.  This stub forwards (one ``DeprecationWarning``,
attributed to the importer) and keeps ``python -m
repro_torch.launch.serve`` working.
"""
from __future__ import annotations

import warnings

from .lm_serve import main

__all__ = ["main"]

warnings.warn(
    "repro_torch.launch.serve has moved to repro_torch.launch.lm_serve "
    "(repro_torch.serve is the DDM serving layer); update the import",
    DeprecationWarning, stacklevel=2)

if __name__ == "__main__":
    main()
