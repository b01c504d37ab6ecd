"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of the DDM
matching service: closed-loop RTI ticks on one card (see ``README.md``).

Importing this package loads neither torch nor the port; ``run.py`` does,
once it has set the cache directories.
"""
