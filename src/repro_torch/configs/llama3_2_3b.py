"""Llama-3.2-3B — small llama3, GQA kv=8  [hf:meta-llama/Llama-3.2-1B; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name='llama3.2-3b',
    family='dense',
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab=128256,
    rope_theta=500000.0,
)

SMOKE = ModelConfig(
    name='llama3.2-3b-smoke',
    family='dense',
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=160,
    vocab=256,
)
