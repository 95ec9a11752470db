"""Workload definitions of the dry run (counterpart of
``repro.launch.workloads``): the assigned input shapes against every
architecture.

  train_4k     → GRPO train step (forward + backward + AdamW)
  prefill_32k  → prompt prefill (full-sequence compute + cache build)
  decode_32k   → serve step: ONE token against a 32k cache
  long_500k    → the same at a 524,288-token context (sub-quadratic archs)
  verify_8     → DAS verify step: an 8-token draft block (the paper's
                 workload; decode and verify share the cache layout)

``input_specs`` / ``param_specs`` / ``opt_specs`` / ``cache_specs``
return meta tensors (shapes and dtypes, no storage) and their logical
axes. The step functions are real PyTorch steps: on meta tensors the dry
run counts them (``launch.analysis.count_cost``), on the CPU the tests
hold them to the reference's, on the card ``chip_smoke.py`` times them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.verify import verify_block
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.rl import grpo

S_ENC = 1024  # stub audio-frame count (encoder input length)
SLOT_MULTIPLE = 256  # cache slot rounding for kv_seq sharding


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode | verify


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
    "verify_8": InputShape("verify_8", 32_768, 128, "verify"),
}

VERIFY_K = 8  # draft tokens per verify block (verify_8)


def meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def skip_reason(cfg: ModelConfig, shape: InputShape) -> Optional[str]:
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return (
            "full-attention arch: long_500k requires sub-quadratic "
            "attention (DESIGN.md §4)"
        )
    return None


def with_batch(shape: InputShape, batch: int) -> InputShape:
    """The shape at another batch (a device's share: ``chip_smoke.py``
    runs the per-device batch of the 16-way data axis on one card)."""
    return dataclasses.replace(shape, global_batch=batch)


# ---------------------------------------------------------------------------
# input specs (meta tensors + logical axes)
# ---------------------------------------------------------------------------

def input_specs(
    cfg: ModelConfig, shape: InputShape
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Returns (meta inputs dict, logical-axes dict). Caches are handled
    separately (``cache_specs``)."""
    B, S = shape.global_batch, shape.seq_len
    d = cfg.d_model
    dt = L.torch_dtype(cfg.dtype)
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    specs: Dict[str, Any] = {}
    axes: Dict[str, Any] = {}

    def add(name, shp, dtype, ax):
        specs[name] = meta(shp, dtype)
        axes[name] = ax

    if shape.kind == "train":
        add("tokens", (B, S), i32, ("batch", None))
        add("resp_mask", (B, S), b8, ("batch", None))
        add("advantages", (B,), f32, ("batch",))
        add("old_logprobs", (B, S), f32, ("batch", None))
        T = S
    elif shape.kind == "prefill":
        add("tokens", (B, S), i32, ("batch", None))
        add("pad_mask", (B, S), b8, ("batch", None))
        T = S
    else:  # decode / verify
        T = 1 if shape.kind == "decode" else VERIFY_K + 1
        add("block", (B, T), i32, ("batch", None))
        if shape.kind == "verify":
            add("budgets", (B,), i32, ("batch",))
    if cfg.modality == "vision":
        if shape.kind in ("train", "prefill"):
            add("embeds", (B, S, d), dt, ("batch", None, None))
        add("mrope_positions", (3, B, T), i32, (None, "batch", None))
    if cfg.is_encoder_decoder:
        enc = "enc_embeds" if shape.kind == "train" else "enc_out"
        add(enc, (B, S_ENC, d), dt, ("batch", None, None))
        add("enc_mask", (B, S_ENC), b8, ("batch", None))
    return specs, axes


def cache_specs(cfg: ModelConfig, shape: InputShape, mesh):
    """(meta Cache, axes Cache) for decode/verify workloads."""
    B, S = shape.global_batch, shape.seq_len
    cache = M.init_cache(cfg, B, S + VERIFY_K + 2, headroom=VERIFY_K + 8,
                         device="meta", slot_multiple=SLOT_MULTIPLE)
    model_size = mesh.shape.get("model", 1)
    return cache, M.cache_logical_axes(cfg, model_size)


def param_specs(cfg: ModelConfig):
    """(meta parameter tree, logical axes): the reference's tree layout
    (``models.model.params_tree``), no allocation."""
    return M.param_shapes(cfg), M.param_logical_axes(cfg)


def opt_specs(cfg: ModelConfig):
    """Meta AdamW state + axes (mirrors the parameter tree twice, in
    float32)."""
    mu = M.params_tree(M.init_params(cfg, device="meta"), cfg,
                       lambda t, ax: meta(t.shape, torch.float32),
                       torch.stack)
    paxes = M.param_logical_axes(cfg)
    return (adamw.AdamWState(meta((), torch.int32), mu, mu),
            adamw.AdamWState((), paxes, paxes))


# ---------------------------------------------------------------------------
# step functions (what the dry run counts)
# ---------------------------------------------------------------------------

# the train step's GRPO and AdamW settings, as the reference's
GRPO = grpo.GRPOConfig(group_size=8, remat=True)
ADAMW = adamw.AdamWConfig(lr=3e-4, weight_decay=0.0)


def make_train_fn(cfg: ModelConfig) -> Callable:
    """train_step(params, opt_state, batch) → (params, opt_state, loss):
    GRPO (group size 8, per-block activation recompute) then AdamW at lr
    3e-4, as the reference's. ``params`` must be trainable
    (``M.set_trainable``) and is updated in place."""
    step = grpo.make_train_step(cfg, GRPO, ADAMW)

    def train_step(params, opt_state, batch):
        params, opt_state, metrics = step(params, opt_state, batch)
        return params, opt_state, metrics["loss"]

    return train_step


def make_prefill_fn(cfg: ModelConfig, shape: InputShape) -> Callable:
    max_len = shape.seq_len + VERIFY_K + 2

    @torch.no_grad()
    def prefill_step(params, batch):
        return M.prefill(
            params, cfg, batch.get("tokens"), batch["pad_mask"],
            max_len=max_len, headroom=VERIFY_K + 8,
            embeds=batch.get("embeds"),
            mrope_positions=batch.get("mrope_positions"),
            enc_out=batch.get("enc_out"), enc_mask=batch.get("enc_mask"),
        )

    return prefill_step


def make_decode_fn(
    cfg: ModelConfig, shape: InputShape, use_cross_cache: bool = False
) -> Callable:
    """serve_step(params, cache, batch) → (next tokens (B,), Cache): one
    forward of the block over the cache, written in place. The verify
    kind accepts the block's drafts (``verify_block``) and, for a
    recurrent arch, gathers the staged states at the acceptance count
    (``commit_staged_cache``: the reference's single pass, no second
    forward); the lengths advance by 1 + accepted (1 for decode)."""
    is_verify = shape.kind == "verify"

    @torch.no_grad()
    def serve_step(params, cache, batch):
        block = batch["block"]
        B, T = block.shape
        valid = torch.ones((B, T), dtype=torch.bool, device=block.device)
        cross = batch.get("cross_cache") if use_cross_cache else None
        recurrent = M.has_recurrent(cfg)
        logits, cache1 = M.forward(
            params, cfg, block, cache=cache, valid=valid,
            commit_upto=(
                None if (not is_verify or recurrent)
                else torch.zeros((B,), dtype=torch.int32,
                                 device=block.device)
            ),
            mrope_positions=batch.get("mrope_positions"),
            enc_out=None if use_cross_cache else batch.get("enc_out"),
            enc_mask=batch.get("enc_mask"),
            cross_cache=cross,
            collect_states=is_verify and recurrent,
        )
        if is_verify:
            res = verify_block(logits[:, :, : cfg.vocab_size], block,
                               batch["budgets"])
            n = (1 + res.accepted).to(torch.int32)
            if recurrent:
                M.commit_staged_cache(cfg, cache, cache1, n)
            return res.next_token, M.Cache(cache.layers, cache.lengths + n)
        next_tok = torch.argmax(logits[:, -1, : cfg.vocab_size], dim=-1)
        return next_tok, M.Cache(cache.layers, cache.lengths + 1)

    return serve_step
