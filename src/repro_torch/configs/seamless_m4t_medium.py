"""SeamlessM4T-medium [arXiv:2308.11596] — encoder-decoder multimodal
(speech/text) backbone. The mel-spectrogram/conformer frontend is
STUBBED per the assignment: ``input_specs`` provides precomputed frame
embeddings; this config is the transformer encoder-decoder that
consumes them. Exact assigned shape: 12L (decoder) + 12L encoder,
d_model=1024, 16H (kv=16), d_ff=4096, vocab=256206."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    rope="standard",  # TPU-idiomatic stand-in for learned positions
    is_encoder_decoder=True,
    num_encoder_layers=12,
    modality="audio",
    mlp="gelu",
    source="arXiv:2308.11596",
)
