"""Training runtime of the port (the JAX package's ``runtime/``)."""
