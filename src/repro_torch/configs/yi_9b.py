"""Yi-9B [arXiv:2403.04652] — llama-architecture dense, GQA (4 kv
heads). Exact assigned shape: 48L, d_model=4096, 32H (kv=4),
d_ff=11008, vocab=64000."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    rope="standard",
    rope_theta=5e6,
    mlp="swiglu",
    source="arXiv:2403.04652",
)
