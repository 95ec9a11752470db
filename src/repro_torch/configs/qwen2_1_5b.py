"""Qwen2-1.5B [arXiv:2407.10671] — dense, GQA (2 kv heads), QKV bias,
tied embeddings. Exact assigned shape: 28L, d_model=1536, 12H (kv=2),
d_ff=8960, vocab=151936."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    rope="standard",
    rope_theta=1e6,
    attn_bias=True,
    tie_embeddings=True,
    mlp="swiglu",
    source="arXiv:2407.10671",
)
