"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base] — dense-MoE
hybrid: 128-expert top-2 MoE with a *dense residual* MLP branch in every
layer. Exact assigned shape: 35L, d_model=7168, 56H (kv=8), expert
d_ff=4864, vocab=32000."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    rope="standard",
    num_experts=128,
    experts_per_token=2,
    capacity_factor=1.25,
    moe_dense_residual=True,
    mlp="swiglu",
    source="hf:Snowflake/snowflake-arctic-base",
)
