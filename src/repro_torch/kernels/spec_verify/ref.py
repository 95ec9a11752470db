"""Plain PyTorch version of the spec-verify attention kernel (the port's
twin of ``repro.kernels.spec_verify.ref``).

Semantics (shared with ``csrc/spec_verify.cu``): GQA attention of a
T-token draft block against a position-tagged ring KV cache.

  q:         (B, T, Hq, hd)   draft-block queries (rope already applied)
  k, v:      (B, S, Hkv, hd)  cache (S includes the trash slot)
  cache_pos: (B, S) int32     absolute position per slot, -1 = empty
  positions: (B, T) int32     absolute positions of the block tokens

mask: slot s visible to query t iff 0 <= cache_pos[s] <= positions[t]
and (window == 0 or cache_pos[s] > positions[t] - window).

The CPU tests run this; ``chip_smoke.py`` holds the kernel against it.
Nothing on the card path calls it.
"""

from __future__ import annotations

import math

import torch


def spec_verify_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cache_pos: torch.Tensor,
    positions: torch.Tensor,
    *,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    B, T, Hq, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, T, Hkv, Hq // Hkv, hd)
    scores = torch.einsum(
        "btkgh,bskh->bkgts", qg.float(), k.to(q.dtype).float()
    ) / math.sqrt(hd)
    if softcap > 0:
        scores = torch.tanh(scores / softcap) * softcap
    qpos = positions[:, :, None]  # (B,T,1)
    kpos = cache_pos[:, None, :]  # (B,1,S)
    mask = (kpos >= 0) & (kpos <= qpos)
    if window > 0:
        mask = mask & (kpos > qpos - window)
    scores = torch.where(mask[:, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum(
        "bkgts,bskh->btkgh", probs.to(q.dtype), v.to(q.dtype)
    )
    return out.reshape(B, T, Hq, hd)
