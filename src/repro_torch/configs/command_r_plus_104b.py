"""Command R+ 104B [hf:CohereForAI/c4ai-command-r-v01 family] — dense,
GQA (8 kv), no attention bias, *parallel* attention+FFN blocks with
LayerNorm, tied embeddings. Exact assigned shape: 64L, d_model=12288,
96H (kv=8), d_ff=33792, vocab=256000."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab_size=256000,
    rope="standard",
    rope_theta=8e6,
    parallel_block=True,
    norm="layer",
    tie_embeddings=True,
    mlp="swiglu",
    source="hf:CohereForAI/c4ai-command-r-v01",
)
