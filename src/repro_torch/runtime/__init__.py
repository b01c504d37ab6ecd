"""Training runtime of the port (the JAX package's ``runtime/``): the
fault-tolerant ``trainer`` and the GPipe ``pipeline``."""
