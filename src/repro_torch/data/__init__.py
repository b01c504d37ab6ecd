"""Data pipeline of the port (the JAX package's ``data/``)."""
