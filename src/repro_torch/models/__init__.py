"""Model library: the port of the JAX package's ``models/`` for all six
families (dense, vlm, moe with MLA, ssm, hybrid, audio); training's
``loss_fn`` waits for the training slice (ROADMAP Queue 1 item 13)."""
from .config import ModelConfig
from . import layers, attention, mlp, moe, ssm, transformer
