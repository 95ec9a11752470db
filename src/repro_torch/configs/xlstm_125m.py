"""xLSTM 125M [arXiv:2405.04517] — attention-free SSM-class stack of
alternating mLSTM (matrix memory) and sLSTM (scalar memory, head-wise
recurrence) blocks, 4 heads, no FFN (d_ff=0). Exact assigned shape:
12L, d_model=768, 4H, vocab=50304."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50304,
    rope="none",
    block_pattern=("mlstm", "slstm"),
    rnn_width=768,
    mlp="none",
    tie_embeddings=True,
    source="arXiv:2405.04517",
)
