"""GRPO (Group Relative Policy Optimization) of the port, the counterpart
of ``repro.rl.grpo``.

The learner side of the paper's pipeline (kept *unchanged* by DAS — the
paper accelerates only the rollout phase): group-normalized advantages
(DeepSeek-R1 style), clipped surrogate, optional KL-to-old penalty and
sampled-token entropy bonus, then an AdamW update. Gradients come from
autograd through the model, with the memory-bounded flash attention's
hand-written backward at 2048+ tokens and per-chunk recompute of the
logits tile here, so the (B, S, V) float32 logits never exist.

The port's models carry no MoE auxiliary loss and no modality inputs
(``models.model.check_supported``): a batch with ``embeds``,
``mrope_positions`` or ``enc_embeds`` raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.optim import adamw

_UNSUPPORTED_KEYS = ("embeds", "mrope_positions", "enc_embeds", "enc_mask")


@dataclass(frozen=True)
class GRPOConfig:
    clip_eps: float = 0.2
    kl_coef: float = 0.0
    entropy_coef: float = 0.0
    group_size: int = 8
    adv_eps: float = 1e-4
    remat: bool = False  # activation checkpointing per block


def group_advantages(
    rewards: np.ndarray, group_size: int, eps: float = 1e-4
) -> np.ndarray:
    """(N,) rewards, rows grouped consecutively per problem → normalized
    advantages A = (r - mean_g) / (std_g + eps)."""
    r = rewards.reshape(-1, group_size)
    mean = r.mean(axis=1, keepdims=True)
    std = r.std(axis=1, keepdims=True)
    return ((r - mean) / (std + eps)).reshape(-1)


def _chunk_logprobs(hc: torch.Tensor, tc: torch.Tensor, head: torch.Tensor,
                    tied: bool) -> torch.Tensor:
    if tied:
        lg = torch.einsum("bcd,vd->bcv", hc, head).float()
    else:
        lg = torch.einsum("bcd,dv->bcv", hc, head).float()
    lse = torch.logsumexp(lg, dim=-1)
    tgt = lg.gather(-1, tc[..., None].long())[..., 0]
    return tgt - lse


def chunked_token_logprobs(
    params: M.Transformer, cfg: ModelConfig, hidden: torch.Tensor,
    tokens: torch.Tensor, chunk: int = 512,
) -> torch.Tensor:
    """Memory-efficient lp[:, t] = log p(tokens[:, t] | ...) from final
    hidden states, never materializing the (B, S, V) logits: a loop over
    sequence chunks, each checkpointed so the backward recomputes its
    logits tile."""
    B, S, D = hidden.shape
    V = cfg.vocab_size
    h = hidden[:, :-1]  # positions predicting tokens[:, 1:]
    t = tokens[:, 1:]
    Sm = S - 1
    C = min(chunk, Sm)
    tied = cfg.tie_embeddings
    head = params.embed[:V] if tied else params.lm_head[:, :V]
    parts = []
    for c0 in range(0, Sm, C):
        hc, tc = h[:, c0:c0 + C], t[:, c0:c0 + C]
        if torch.is_grad_enabled():
            parts.append(checkpoint(_chunk_logprobs, hc, tc, head, tied,
                                    use_reentrant=False))
        else:
            parts.append(_chunk_logprobs(hc, tc, head, tied))
    lp = torch.cat(parts, dim=1)
    return torch.nn.functional.pad(lp, (1, 0))  # lp[:, t] for token t


def token_logprobs(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """logits (B, S, V) f32; tokens (B, S). Returns lp (B, S) where
    lp[:, t] is log p(tokens[:, t] | tokens[:, :t]) (position t-1's
    logits)."""
    lp_all = torch.log_softmax(logits, dim=-1)
    lp = lp_all[:, :-1].gather(-1, tokens[:, 1:, None].long())[..., 0]
    return torch.nn.functional.pad(lp, (1, 0))


def _check_batch(batch: Mapping[str, torch.Tensor]) -> None:
    bad = [k for k in _UNSUPPORTED_KEYS if k in batch]
    if bad:
        raise NotImplementedError(
            f"GRPO batch keys {bad} belong to model families the port does "
            "not support yet (models.model.check_supported)"
        )


def grpo_loss(
    params: M.Transformer,
    cfg: ModelConfig,
    gcfg: GRPOConfig,
    batch: Mapping[str, torch.Tensor],
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: tokens (B, S), resp_mask (B, S) bool, advantages (B,),
    old_logprobs (B, S) — ratio = 1 when old == new (single on-policy
    update). Returns (loss, metrics), both differentiable 0-d tensors."""
    _check_batch(batch)
    tokens = batch["tokens"]
    hidden, _ = M.forward(params, cfg, tokens, remat=gcfg.remat,
                          return_hidden=True)
    lp = chunked_token_logprobs(params, cfg, hidden, tokens)
    mask = batch["resp_mask"].float()
    adv = batch["advantages"][:, None]
    ratio = torch.exp(lp - batch["old_logprobs"])
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1.0 - gcfg.clip_eps,
                          1.0 + gcfg.clip_eps) * adv
    pg = -torch.minimum(unclipped, clipped)
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (pg * mask).sum() / denom
    aux = torch.zeros((), device=loss.device)  # no MoE in the port
    metrics = {"pg_loss": loss, "aux_loss": aux}
    if gcfg.kl_coef > 0:
        # k3 estimator of KL(new || old)
        logr = lp - batch["old_logprobs"]
        kl = (torch.exp(-logr) - 1.0 + logr) * mask
        kl = kl.sum() / denom
        loss = loss + gcfg.kl_coef * kl
        metrics["kl"] = kl
    if gcfg.entropy_coef > 0:
        # sampled-token entropy estimator: maximize -E[log p(sampled)]
        ent = -(lp * mask).sum() / denom
        loss = loss - gcfg.entropy_coef * ent
        metrics["entropy"] = ent
    loss = loss + aux
    metrics["loss"] = loss
    return loss, metrics


def param_grads(params: M.Transformer,
                loss: torch.Tensor) -> Dict[str, torch.Tensor]:
    """d loss / d every parameter, by name (zeros for one the loss does
    not reach, as ``jax.grad`` gives)."""
    named = dict(params.named_parameters())
    gs = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(named.items(), gs)}


def make_train_step(cfg: ModelConfig, gcfg: GRPOConfig,
                    ocfg: adamw.AdamWConfig):
    """Returns train_step(params, opt_state, batch) → (params, opt_state,
    metrics); the parameters must be trainable (``M.set_trainable``) and
    are updated in place."""

    def train_step(params, opt_state, batch):
        loss, metrics = grpo_loss(params, cfg, gcfg, batch)
        grads = param_grads(params, loss)
        del loss
        params, opt_state, om = adamw.apply_updates(ocfg, params, grads,
                                                    opt_state)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(om)
        return params, opt_state, metrics

    return train_step


@torch.no_grad()
def compute_old_logprobs(params: M.Transformer, cfg: ModelConfig,
                         tokens: torch.Tensor) -> torch.Tensor:
    hidden, _ = M.forward(params, cfg, tokens, return_hidden=True)
    return chunked_token_logprobs(params, cfg, hidden, tokens)


def make_sft_step(cfg: ModelConfig, ocfg: adamw.AdamWConfig):
    """Supervised warmup step (cross-entropy on the response span): the
    stand-in for the pretrained checkpoint the paper post-trains."""

    def sft_step(params, opt_state, batch):
        _check_batch(batch)
        tokens = batch["tokens"]
        hidden, _ = M.forward(params, cfg, tokens, return_hidden=True)
        lp = chunked_token_logprobs(params, cfg, hidden, tokens)
        mask = batch["resp_mask"].float()
        ce = -(lp * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        grads = param_grads(params, ce)
        params, opt_state, om = adamw.apply_updates(ocfg, params, grads,
                                                    opt_state)
        metrics = {"sft_loss": ce.detach()}
        metrics.update(om)
        return params, opt_state, metrics

    return sft_step
