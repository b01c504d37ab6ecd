"""Model library: the port of the JAX package's ``models/`` for all six
families (dense, vlm, moe with MLA, ssm, hybrid, audio), for serving
and for training (``transformer.loss_fn``)."""
from .config import ModelConfig
from . import layers, attention, mlp, moe, ssm, transformer
