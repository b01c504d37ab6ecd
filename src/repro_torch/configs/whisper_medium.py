"""Whisper-medium — enc-dec; conv frontend stubbed (precomputed 1500-frame embeddings); assigned seq shapes apply to the decoder stream  [arXiv:2212.04356; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name='whisper-medium',
    family='audio',
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=4096,
    vocab=51865,
    enc_layers=24,
    enc_frames=1500,
    cross_attn=True,
)

SMOKE = ModelConfig(
    name='whisper-medium-smoke',
    family='audio',
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab=256,
    enc_layers=2,
    enc_frames=32,
    cross_attn=True,
)
