"""Qwen3-14B — qk_norm, GQA kv=8  [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name='qwen3-14b',
    family='dense',
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=17408,
    vocab=151936,
    qk_norm=True,
    rope_theta=1000000.0,
)

SMOKE = ModelConfig(
    name='qwen3-14b-smoke',
    family='dense',
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=192,
    vocab=256,
    qk_norm=True,
)
