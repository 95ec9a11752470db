"""Qwen3-8B — the paper's own Code-RL policy model (DAS §5.2). Dense,
GQA (8 kv heads): 36L, d_model=4096, 32H (kv=8), d_ff=12288,
vocab=151936 [Qwen3 technical report]."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    rope="standard",
    rope_theta=1e6,
    mlp="swiglu",
    source="paper §5.2 (Qwen3-8B)",
)
