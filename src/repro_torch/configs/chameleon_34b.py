"""Chameleon-34B — early-fusion VLM: VQ image tokens share the text vocab (frontend stub supplies the fused token stream); qk-norm per the paper  [arXiv:2405.09818; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name='chameleon-34b',
    family='vlm',
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=22016,
    vocab=65536,
    qk_norm=True,
    grad_accum=2,
)

SMOKE = ModelConfig(
    name='chameleon-34b-smoke',
    family='vlm',
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=192,
    vocab=512,
    qk_norm=True,
)
