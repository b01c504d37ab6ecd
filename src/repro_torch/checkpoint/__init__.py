"""Checkpointing of the port (the JAX package's ``checkpoint/``)."""
