"""DDM-planned block-sparse attention layout, on the port's engine.

The port's counterpart of the JAX package's ``sparse/``: the planner
(``planner``) turns a causal sliding window with a sink prefix into
per-query-block kv windows by DDM interval matching, and the kernel
wrappers in ``repro_torch.kernels.sparse_attn`` (K7) attend over them.
"""
from .planner import (BlockPlan, block_bitmask, block_windows,
                      decode_window)

__all__ = ["BlockPlan", "block_bitmask", "block_windows", "decode_window"]
