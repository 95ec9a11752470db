"""RecurrentGemma 9B [arXiv:2402.19427] — hybrid Griffin: RG-LRU
recurrent blocks and local attention at 2:1 ratio (pattern r,r,a),
MQA (kv=1), local window 2048. Exact assigned shape: 38L,
d_model=4096, 16H (kv=1), d_ff=12288, vocab=256000.

38 = 12 full (rglru, rglru, local_attn) triples + 2 trailing recurrent
layers (handled as an un-scanned remainder stage, see
ModelConfig.scan_stages)."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    rope="standard",
    rope_theta=10_000.0,
    block_pattern=("rglru", "rglru", "local_attn"),
    local_window=2048,
    rnn_width=4096,
    conv_width=4,
    mlp="swiglu",
    tie_embeddings=True,
    source="arXiv:2402.19427",
)
