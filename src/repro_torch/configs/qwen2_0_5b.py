"""Qwen2-0.5B — GQA (kv=2), QKV bias, tied embeddings  [arXiv:2407.10671; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name='qwen2-0.5b',
    family='dense',
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_head=64,
    d_ff=4864,
    vocab=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1000000.0,
)

SMOKE = ModelConfig(
    name='qwen2-0.5b-smoke',
    family='dense',
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=256,
    qkv_bias=True,
    tie_embeddings=True,
)
