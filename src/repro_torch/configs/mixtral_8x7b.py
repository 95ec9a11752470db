"""Mixtral 8x7B [arXiv:2401.04088] — MoE, 8 experts top-2, GQA (8 kv
heads), sliding-window attention (4096). Exact assigned shape:
32L, d_model=4096, 32H (kv=8), d_ff=14336, vocab=32000."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    rope="standard",
    rope_theta=1e6,
    sliding_window=4096,
    num_experts=8,
    experts_per_token=2,
    capacity_factor=1.25,
    block_pattern=("attn",),
    mlp="swiglu",
    source="arXiv:2401.04088",
)
