"""Plain PyTorch version of the RG-LRU scan kernel (the port's twin of
``repro.kernels.rglru.ref`` and, with an update mask, of the model's
``repro.models.layers._rglru_scan`` with committed = updated).

Recurrence (RecurrentGemma, arXiv:2402.19427), per width lane:

  log a_t = c · r_t · log(sigmoid(Λ))        (c = 8)
  h_t     = a_t · h_{t-1} + sqrt(clip(1 - a_t², 1e-9, 1)) · (i_t · x_t)

x, r, i: (B, T, W) float32 (post-conv branch and the two gates); Λ:
(W,); h0: (B, W). With ``mask`` (B, T) bool, a step where the mask is
False leaves h unchanged (and writes it to ``hs``): pads of a left-padded
prefill and frozen rows of a verify block. Returns (hs (B, T, W), h_final
(B, W)).

The CPU tests run this; ``chip_smoke.py`` holds the kernel against it.
Nothing on the card path calls it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

RGLRU_C = 8.0


def rglru_scan_ref(
    x: torch.Tensor,
    r: torch.Tensor,
    i: torch.Tensor,
    lam: torch.Tensor,
    h0: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    a_base = torch.log(torch.sigmoid(lam))  # (W,), negative
    log_a = RGLRU_C * r * a_base
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 1e-9, 1.0))
    gx = mult * (i * x)
    hs = torch.empty_like(x)
    h = h0
    for t in range(x.shape[1]):
        new = a[:, t] * h + gx[:, t]
        h = new if mask is None else torch.where(mask[:, t, None], new, h)
        hs[:, t] = h
    return hs, h.clone()
