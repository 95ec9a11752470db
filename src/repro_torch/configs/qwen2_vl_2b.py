"""Qwen2-VL-2B [arXiv:2409.12191] — VLM language backbone with M-RoPE
(temporal/height/width rotary sections) and dynamic-resolution vision
input. The ViT encoder + projector is STUBBED per the assignment:
``input_specs`` provides precomputed patch embeddings and 3-stream
M-RoPE position ids. Exact assigned shape: 28L, d_model=1536,
12H (kv=2), d_ff=8960, vocab=151936."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    rope="mrope",
    rope_theta=1e6,
    mrope_sections=(16, 24, 24),
    attn_bias=True,
    tie_embeddings=True,
    modality="vision",
    mlp="swiglu",
    source="arXiv:2409.12191",
)
