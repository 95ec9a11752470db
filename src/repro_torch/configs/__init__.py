"""Architecture registry of the port: every config of the reference (the
paper's own Qwen3-8B, the dense Qwen2-1.5B, Yi-9B, ChatGLM3-6B and
Command R+ (parallel blocks), the Qwen2-VL-2B backbone (M-RoPE), the MoE
Mixtral-8x7B and Arctic-480B, the hybrid RecurrentGemma-9B, the
attention-free xLSTM-125M and the SeamlessM4T-medium encoder-decoder),
and reduced smoke variants for CPU tests."""

from __future__ import annotations

from typing import Dict, List

from . import (
    arctic_480b,
    chatglm3_6b,
    command_r_plus_104b,
    mixtral_8x7b,
    qwen2_1_5b,
    qwen2_vl_2b,
    qwen3_8b,
    recurrentgemma_9b,
    seamless_m4t_medium,
    xlstm_125m,
    yi_9b,
)
from .base import ModelConfig, active_params, count_params

_MODULES = (
    mixtral_8x7b,
    command_r_plus_104b,
    recurrentgemma_9b,
    chatglm3_6b,
    arctic_480b,
    xlstm_125m,
    seamless_m4t_medium,
    qwen2_1_5b,
    yi_9b,
    qwen2_vl_2b,
    qwen3_8b,
)

REGISTRY: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}

# The 10 assigned architectures (qwen3-8b is the paper's own, extra): the
# dry run's ``--all`` sweep.
ASSIGNED: List[str] = [
    "mixtral-8x7b",
    "command-r-plus-104b",
    "recurrentgemma-9b",
    "chatglm3-6b",
    "arctic-480b",
    "xlstm-125m",
    "seamless-m4t-medium",
    "qwen2-1.5b",
    "yi-9b",
    "qwen2-vl-2b",
]


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(REGISTRY)}"
        )
    return REGISTRY[name]


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant: one block-pattern unit (>= 2 layers),
    d_model <= 512, <= 4 experts — runs a CPU forward/train step fast."""
    d_model = min(cfg.d_model, 256)
    heads = min(cfg.num_heads, 4)
    kv = max(1, min(cfg.num_kv_heads, heads))
    while heads % kv:
        kv -= 1
    head_dim = max(32, d_model // heads)
    unit = cfg.block_pattern
    layers = max(2, len(unit))
    changes = dict(
        num_layers=layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=head_dim,
        d_ff=0 if cfg.d_ff == 0 else min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 1024),
        vocab_pad_multiple=128,
        rnn_width=min(cfg.rnn_width, d_model),
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        local_window=min(cfg.local_window, 64),
        dtype="float32",
    )
    if cfg.num_experts > 0:
        changes["num_experts"] = min(cfg.num_experts, 4)
        changes["experts_per_token"] = min(cfg.experts_per_token, 2)
    if cfg.is_encoder_decoder:
        changes["num_encoder_layers"] = 2
    if cfg.rope == "mrope":
        n = head_dim // 4  # keep sections summing to the rotary half
        changes["mrope_sections"] = (head_dim // 2 - 2 * n, n, n)
    return cfg.replace(name=cfg.name + "-smoke", **changes)


__all__ = [
    "ModelConfig",
    "REGISTRY",
    "ASSIGNED",
    "get_config",
    "smoke_variant",
    "count_params",
    "active_params",
]
