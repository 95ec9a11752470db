"""ChatGLM3-6B [arXiv:2406.12793 (GLM-4 report lineage)] — dense, GQA
(2 kv heads), 2D/partial RoPE (rotates half the head dim), QKV bias.
Exact assigned shape: 28L, d_model=4096, 32H (kv=2), d_ff=13696,
vocab=65024."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    rope="partial",
    rope_fraction=0.5,
    attn_bias=True,
    mlp="swiglu",
    source="arXiv:2406.12793",
)
