"""Mamba2-780M — attention-free SSD  [arXiv:2405.21060; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name='mamba2-780m',
    family='ssm',
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name='mamba2-780m-smoke',
    family='ssm',
    n_layers=2,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=256,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=16,
    ssd_chunk=16,
    tie_embeddings=True,
)
