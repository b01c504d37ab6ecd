"""Phi-3.5-MoE (42B, 6.6B active) — 16 experts top-2, GQA kv=8  [hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name='phi3.5-moe-42b-a6.6b',
    family='moe',
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=6400,
    vocab=32064,
    n_experts=16,
    top_k=2,
    n_shared_experts=0,
    moe_d_ff=6400,
    first_dense_layers=0,
    grad_accum=2,
)

SMOKE = ModelConfig(
    name='phi3.5-moe-smoke',
    family='moe',
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=256,
    n_experts=4,
    top_k=2,
    n_shared_experts=0,
    moe_d_ff=128,
    first_dense_layers=0,
    capacity_factor=16.0,
)
