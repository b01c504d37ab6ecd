"""Model library: the port of the JAX package's ``models/`` for the
dense, vlm, ssm and hybrid families (MoE, MLA and the audio stack are
not ported yet: ROADMAP Queue 1 item 13)."""
from .config import ModelConfig
from . import layers, attention, mlp, ssm, transformer
