"""Model configuration system.

One immutable dataclass describes every architecture in the assigned
pool (dense / MoE / hybrid / SSM / enc-dec audio / VLM). Each
`src/repro/configs/<arch>.py` instantiates it with the exact published
numbers (source cited in the module docstring) and provides a reduced
`smoke()` variant for CPU tests.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 → d_model // num_heads

    # --- attention ---
    rope: str = "standard"  # standard | partial | mrope | none
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0  # fraction of head_dim rotated ("partial")
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # qwen2-vl
    sliding_window: int = 0  # 0 = full attention
    attn_bias: bool = False  # qwen2: bias on QKV projections
    logit_softcap: float = 0.0

    # --- block structure ---
    block_pattern: Tuple[str, ...] = ("attn",)
    # repeating unit of layer kinds; kinds: attn | local_attn | rglru |
    # mlstm | slstm. The pattern tiles to num_layers (remainder layers are
    # taken from the unit's prefix and run un-scanned).
    parallel_block: bool = False  # command-r: attn and MLP in parallel
    norm: str = "rms"  # rms | layer
    norm_eps: float = 1e-6
    mlp: str = "swiglu"  # swiglu | gelu | none
    local_window: int = 2048  # window for local_attn layers

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    moe_dense_residual: bool = False  # arctic: dense MLP residual branch
    router_aux_weight: float = 0.01

    # --- recurrent (rglru / xlstm) ---
    rnn_width: int = 0  # 0 → d_model
    conv_width: int = 4  # temporal conv in the recurrent block

    # --- encoder-decoder (audio) ---
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0

    # --- modality frontends (stubbed per assignment) ---
    modality: str = "text"  # text | audio | vision

    # --- misc ---
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    vocab_pad_multiple: int = 512
    source: str = ""  # citation
    # analysis-only: unroll every layer into its own stage (no lax.scan)
    # so compiled cost_analysis counts each layer (scan bodies are
    # counted ONCE by XLA's analysis; the dry-run extrapolates from two
    # small unrolled variants instead of unrolling 64 layers)
    force_unroll: bool = False

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.rnn_width == 0:
            object.__setattr__(self, "rnn_width", self.d_model)
        assert self.num_heads % max(self.num_kv_heads, 1) == 0, (
            "GQA requires num_heads % num_kv_heads == 0"
        )

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kind list, the block pattern tiled to num_layers."""
        unit = self.block_pattern
        reps = (self.num_layers + len(unit) - 1) // len(unit)
        return tuple((unit * reps)[: self.num_layers])

    @property
    def scan_stages(self) -> Tuple[Tuple[Tuple[str, ...], int], ...]:
        """Partition layers into (unit, repeats) scan stages.

        Full repeats of `block_pattern` form one lax.scan stage; remainder
        layers form a trailing stage with repeats=1 each (un-scanned).
        """
        if self.force_unroll:
            return tuple(((k,), 1) for k in self.layer_kinds)
        unit = self.block_pattern
        full = self.num_layers // len(unit)
        rem = self.num_layers - full * len(unit)
        stages = []
        if full > 0:
            stages.append((tuple(unit), full))
        for k in unit[:rem]:
            stages.append(((k,), 1))
        return tuple(stages)

    @property
    def has_attention(self) -> bool:
        return any(k in ("attn", "local_attn") for k in self.layer_kinds)

    @property
    def is_subquadratic(self) -> bool:
        """True iff decode-time state is O(1) or O(window) per token —
        the gate for the long_500k shape."""
        for k in self.layer_kinds:
            if k == "attn" and self.sliding_window == 0:
                return False
        return not self.is_encoder_decoder

    @property
    def effective_window(self) -> int:
        """Max KV retention needed at decode time (0 = unbounded)."""
        w = 0
        for k in self.layer_kinds:
            if k == "attn":
                if self.sliding_window == 0:
                    return 0
                w = max(w, self.sliding_window)
            elif k == "local_attn":
                w = max(w, self.local_window)
        return w

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def count_params(cfg: ModelConfig) -> int:
    """Analytic parameter count (embedding + blocks + head)."""
    d, hd = cfg.d_model, cfg.head_dim
    n = cfg.padded_vocab * d  # embedding
    if not cfg.tie_embeddings:
        n += d * cfg.padded_vocab
    for kind in cfg.layer_kinds:
        n += d  # pre-norm scale
        if kind in ("attn", "local_attn"):
            n += d * (cfg.num_heads * hd) + 2 * d * (cfg.num_kv_heads * hd)
            n += cfg.num_heads * hd * d
        elif kind == "rglru":
            w = cfg.rnn_width
            n += 2 * d * w + w * d + cfg.conv_width * w + 2 * w * w // 8 + 3 * w
        elif kind == "mlstm":
            w = cfg.rnn_width
            n += 3 * d * w + w * d + 3 * w
        elif kind == "slstm":
            w = cfg.rnn_width
            h = max(cfg.num_heads, 1)
            n += 4 * d * w + 4 * (w // h) * w + w * d
        if cfg.num_experts > 0 and kind in ("attn", "local_attn"):
            n += d * cfg.num_experts
            n += cfg.num_experts * 3 * d * cfg.d_ff
            if cfg.moe_dense_residual:
                n += 3 * d * cfg.d_ff
        elif cfg.d_ff > 0:
            mult = 3 if cfg.mlp == "swiglu" else 2
            n += mult * d * cfg.d_ff
            n += d  # post-attn norm
    if cfg.is_encoder_decoder:
        enc = cfg.num_encoder_layers * (
            d * (cfg.num_heads * hd) * 2 + 2 * d * (cfg.num_kv_heads * hd)
            + (3 if cfg.mlp == "swiglu" else 2) * d * cfg.d_ff + 2 * d
        )
        n += enc
        # decoder cross-attention
        n += cfg.num_layers * (2 * d * (cfg.num_heads * hd) + 2 * d * (cfg.num_kv_heads * hd) + d)
    return n


def active_params(cfg: ModelConfig) -> int:
    """Active-per-token parameter count (MoE: top-k experts only)."""
    if cfg.num_experts == 0:
        return count_params(cfg)
    full = count_params(cfg)
    expert_p = cfg.num_experts * 3 * cfg.d_model * cfg.d_ff * len(
        [k for k in cfg.layer_kinds if k in ("attn", "local_attn")]
    )
    active_expert_p = expert_p * cfg.experts_per_token // cfg.num_experts
    return full - expert_p + active_expert_p
