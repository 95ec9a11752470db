"""AdamW of the port (counterpart of ``repro.optim.adamw``), with
global-norm clipping and a warmup + cosine (or constant) schedule.

The semantics are the reference's, which ``torch.optim.AdamW`` does not
give: float32 moments ``mu``/``nu`` and no master copy — each update is
computed in float32 from the parameter and cast back to its own dtype —
plus the metrics the trainer reads (``grad_norm``, ``lr`` and
``update_norm = lr * clip_scale * grad_norm``, which sizes the drafter's
window, paper §4.1.2).

Parameters are a ``Transformer`` (or any mapping of name -> tensor);
the state's ``mu``/``nu`` are dicts keyed by the same names. The update
writes the parameters in place under ``torch.no_grad()``, so every
holder of the model (the rollout engine) sees the new weights.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, NamedTuple, Tuple, Union

import torch
from torch import nn


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    warmup_steps: int = 0
    total_steps: int = 0  # 0 = constant lr after warmup
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32, on the host
    mu: Dict[str, torch.Tensor]  # float32, like each parameter
    nu: Dict[str, torch.Tensor]


Params = Union[nn.Module, Mapping[str, torch.Tensor]]


def _named(params: Params) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init_state(params: Params) -> AdamWState:
    zeros = {k: torch.zeros_like(p, dtype=torch.float32)
             for k, p in _named(params).items()}
    return AdamWState(
        torch.zeros((), dtype=torch.int32), zeros,
        {k: torch.zeros_like(z) for k, z in zeros.items()},
    )


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Learning rate at ``step`` (float32, on the host)."""
    s = torch.as_tensor(step).float()
    lr = torch.tensor(cfg.lr, dtype=torch.float32)
    if cfg.warmup_steps > 0:
        lr = lr * torch.clamp((s + 1.0) / cfg.warmup_steps, max=1.0)
    if cfg.total_steps > 0:
        t = torch.clamp(
            (s - cfg.warmup_steps)
            / max(cfg.total_steps - cfg.warmup_steps, 1),
            0.0, 1.0,
        )
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        lr = lr * (cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos)
    return lr


def global_norm(tensors: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the float32 sum of squares of every tensor (0-d, on the
    tensors' device)."""
    return torch.sqrt(sum(t.float().square().sum()
                          for t in tensors.values()))


@torch.no_grad()
def apply_updates(
    cfg: AdamWConfig, params: Params, grads: Mapping[str, torch.Tensor],
    state: AdamWState,
) -> Tuple[Params, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place. Returns (params, new_state, metrics);
    the metrics are 0-d float32 tensors."""
    named = _named(params)
    gnorm = global_norm(grads)
    dev = gnorm.device
    if cfg.grad_clip > 0:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    else:
        scale = torch.ones((), device=dev)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.float()
    bc1 = (1.0 - torch.tensor(b1) ** stepf).to(dev)
    bc2 = (1.0 - torch.tensor(b2) ** stepf).to(dev)
    lr_d = lr.to(dev)
    for name, p in named.items():
        g = grads[name].float() * scale
        mu = state.mu[name].mul_(b1).add_(g, alpha=1 - b1)
        nu = state.nu[name].mul_(b2).add_(g.square(), alpha=1 - b2)
        delta = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        if cfg.weight_decay > 0:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr_d * delta).to(p.dtype))
    # the update norm drives the drafter's adaptive window (paper §4.1.2)
    unorm = lr_d * scale * gnorm
    return params, AdamWState(step, state.mu, state.nu), {
        "grad_norm": gnorm, "lr": lr, "update_norm": unorm,
    }
