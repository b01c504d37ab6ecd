"""Optimizer substrate of the port (the JAX package's ``optim/``):
AdamW + schedule + clipping, and the int8 gradient compression."""
from .adamw import (AdamWConfig, adamw_init, adamw_update,
                    cosine_schedule, global_norm, clip_by_global_norm)
from .compress import compress_int8, decompress_int8

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "clip_by_global_norm", "compress_int8",
           "decompress_int8"]
