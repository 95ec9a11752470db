"""Plain PyTorch version of the spec-verify attention kernel (the port's
twin of ``repro.kernels.spec_verify.ref``).

Semantics (shared with ``csrc/spec_verify.cu``): GQA attention of a
T-token draft block against a position-tagged ring KV cache.

  q:         (B, T, Hq, hd)   draft-block queries (rope already applied)
  k, v:      (B, S, Hkv, hd)  cache (S includes the trash slot)
  cache_pos: (B, S) int32     absolute position per slot, -1 = empty
  positions: (B, T) int32     absolute positions of the block tokens

mask: slot s visible to query t iff 0 <= cache_pos[s] <= positions[t]
and (window == 0 or cache_pos[s] > positions[t] - window). A query that
sees no slot gets 0, as the kernel's guard ``acc / max(l, 1e-20)`` gives
it (and the TPU kernel's).

``combine_partials_ref`` is the plain version of the bfloat16 kernel's
split-KV combine: the merge of per-split (m, l, acc) partials.

The CPU tests run this; ``chip_smoke.py`` holds the kernel against it.
Nothing on the card path calls it.
"""

from __future__ import annotations

import math

import torch

NEG = -1e30  # the masked score, and the m of an empty partial


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
    scores = torch.where(mask[:, None, None], scores, NEG)
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(mask.any(-1)[:, None, None, :, None], probs, 0.0)
    out = torch.einsum(
        "bkgts,bskh->btkgh", probs.to(q.dtype), v.to(q.dtype)
    )
    return out.reshape(B, T, Hq, hd)


def combine_partials_ref(m: torch.Tensor, l: torch.Tensor,
                         acc: torch.Tensor) -> torch.Tensor:
    """Merge split-KV partials in split order, as the combine kernel
    does: m, l (n_split, ...) and acc (n_split, ..., hd) float32 of the
    same rows; a partial with ``m <= NEG`` is empty (weight 0, its acc
    not read). Returns sum_i w_i acc_i / max(sum_i w_i l_i, 1e-20), w_i =
    exp(m_i - max_j m_j): 0 for a row every partial of which is empty."""
    M = m.max(dim=0).values
    num = torch.zeros_like(acc[0])
    den = torch.zeros_like(l[0])
    for mi, li, ai in zip(m, l, acc):
        w = torch.where(mi > NEG, torch.exp(mi - M), 0.0)
        den = den + w * li
        num = num + torch.where((mi > NEG)[..., None], w[..., None] * ai, 0.0)
    return num / torch.clamp(den, min=1e-20)[..., None]
