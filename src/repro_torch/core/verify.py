"""Lossless speculative verification (Leviathan et al. 2023) — PyTorch
counterpart of ``repro.core.verify``.

The nonparametric drafter proposes a deterministic token sequence, so the
draft distribution is a point mass q = δ(d_j) and rejection sampling
reduces to: accept d_j with prob p(d_j) (u_j < p(d_j)); on the first
rejection at offset a, resample from the residual (p with p(d_a) zeroed,
renormalised); on full acceptance, sample the bonus token from p at
offset K. Greedy (T=0) is accept-while-argmax-matches: token-identical to
plain autoregressive decoding.

Block convention: ``block = [head, d_1, ..., d_K]`` and ``logits[:, j]``
is the target distribution for the token after block position j. Per-row
budgets are ragged: positions >= budget are padding, never accepted.

At T > 0 the random numbers can be passed in (``uniforms`` (B, K) in
[0, 1) and ``gumbel`` (B, V) noise); when absent they are drawn from
``generator``. Sampling a category is ``argmax(log p + gumbel)``, the
same rule as ``jax.random.categorical``, so feeding both packages the
same draws gives the same tokens.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class VerifyResult(NamedTuple):
    accepted: torch.Tensor  # (B,) number of accepted draft tokens (0..K)
    next_token: torch.Tensor  # (B,) bonus (full accept) or corrected token
    out_tokens: torch.Tensor  # (B, K+1) accepted drafts then next_token
    n_emitted: torch.Tensor  # (B,) accepted + 1


def gumbel_noise(shape, generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def verify_block(
    logits: torch.Tensor,  # (B, K+1, V) f32 target logits over the block
    block: torch.Tensor,  # (B, K+1) int: [head, d_1..d_K]
    budgets: torch.Tensor,  # (B,) int valid draft count per row (<= K)
    *,
    temperature: float = 0.0,
    active: Optional[torch.Tensor] = None,  # (B,) bool
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[torch.Tensor] = None,  # (B, K)
    gumbel: Optional[torch.Tensor] = None,  # (B, V)
) -> VerifyResult:
    B, K1, V = logits.shape
    K = K1 - 1
    dev = logits.device
    drafts = block[:, 1:].long()
    in_budget = torch.arange(K, device=dev)[None, :] < budgets[:, None]

    if temperature <= 0.0:
        preds = torch.argmax(logits, dim=-1)  # (B, K+1)
        match = (preds[:, :-1] == drafts) & in_budget
        acc_mask = torch.cumprod(match.to(torch.int32), dim=-1).bool()
        accepted = acc_mask.sum(-1)
        next_token = preds.gather(1, accepted[:, None])[:, 0]
    else:
        probs = torch.softmax(logits / temperature, dim=-1)  # (B,K+1,V)
        p_draft = probs[:, :-1].gather(2, drafts[..., None])[..., 0]
        if uniforms is None:
            uniforms = torch.rand((B, K), generator=generator, device=dev)
        ok = (uniforms < p_draft) & in_budget
        acc_mask = torch.cumprod(ok.to(torch.int32), dim=-1).bool()
        accepted = acc_mask.sum(-1)
        # Residual / bonus distribution at offset = accepted.
        p_at = probs.gather(
            1, accepted[:, None, None].expand(B, 1, V)
        )[:, 0]  # (B, V)
        if K > 0:
            rejected_tok = drafts.gather(
                1, accepted.clamp(max=K - 1)[:, None]
            )[:, 0]
        else:
            rejected_tok = torch.zeros(B, dtype=torch.long, device=dev)
        full_accept = accepted >= budgets  # no rejection happened
        zap = torch.nn.functional.one_hot(rejected_tok, V).to(probs.dtype)
        p_resid = torch.where(full_accept[:, None], p_at, p_at * (1.0 - zap))
        p_resid = p_resid / p_resid.sum(-1, keepdim=True).clamp(min=1e-20)
        if gumbel is None:
            gumbel = gumbel_noise((B, V), generator, dev)
        next_token = torch.argmax(
            torch.log(p_resid.clamp(min=1e-20)) + gumbel, dim=-1
        )

    if active is not None:
        accepted = torch.where(active, accepted, 0)
        n_emitted = torch.where(active, accepted + 1, 0)
    else:
        n_emitted = accepted + 1
    # out_tokens: accepted drafts then next_token then junk (masked later)
    idx = torch.arange(K1, device=dev)[None, :]
    padded = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
    out = torch.where(
        idx < accepted[:, None], padded,
        torch.where(idx == accepted[:, None], next_token[:, None], 0),
    )
    i32 = torch.int32
    return VerifyResult(accepted.to(i32), next_token.to(i32), out.to(i32),
                        n_emitted.to(i32))


def sample_token(
    logits: torch.Tensor,  # (B, V)
    *,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    gumbel: Optional[torch.Tensor] = None,  # (B, V)
) -> torch.Tensor:
    """First-token sampling after prefill (greedy or temperature)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if gumbel is None:
        gumbel = gumbel_noise(logits.shape, generator, logits.device)
    return torch.argmax(logits / temperature + gumbel, dim=-1).to(torch.int32)


def sample_token_rows(
    logits: torch.Tensor,  # (B, V)
    *,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    gumbel: Optional[torch.Tensor] = None,  # (B, V)
) -> torch.Tensor:
    """First-token sampling for a coalesced admission chunk: each row is
    an independent categorical draw ``argmax(logits / T + gumbel)``. The
    reference gives each row its own PRNG key so a request's draw does not
    depend on how admissions were grouped; here the noise comes from the
    serve's ``generator`` (or is passed in, as the tests do)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if gumbel is None:
        gumbel = gumbel_noise(logits.shape, generator, logits.device)
    return torch.argmax(logits / temperature + gumbel, dim=-1).to(torch.int32)
