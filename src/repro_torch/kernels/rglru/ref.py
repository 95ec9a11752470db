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

``rglru_scan_bwd_ref`` is the reverse-time adjoint of the same
recurrence, written out as a loop (the reference differentiates its
``lax.scan``; the port's kernel has a backward of its own, and this is
its plain version).

The CPU tests run these; ``chip_smoke.py`` holds the kernels against
them. Nothing on the card path calls them.
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


def _where(upd, v, other):
    return v if upd is None else torch.where(upd, v, other)


def rglru_scan_bwd_ref(
    x: torch.Tensor,
    r: torch.Tensor,
    i: torch.Tensor,
    lam: torch.Tensor,
    h0: torch.Tensor,
    hs: torch.Tensor,
    dhs: torch.Tensor,
    dh_final: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """Cotangents (dx, dr, di, dlam, dh0) of ``rglru_scan_ref``'s inputs
    from those of its outputs: ``dhs`` (B, T, W) and ``dh_final`` (B, W).
    ``hs`` is the forward's output (h_{t-1} is ``hs[:, t-1]``, ``h0`` at
    t = 0).

    Per lane, t from T-1 down to 0, λ the adjoint of h_t carried from
    step t+1 (``dh_final`` at t = T-1):

      δ = dhs_t + λ
      updated step:  dx_t = (δ·mult)·i_t,  di_t = (δ·mult)·x_t,
                     d log a_t = (δ·h_{t-1})·a_t + (δ·(i_t·x_t))·q_t,
                     dr_t = (d log a_t · c)·log σ(Λ),  λ ← a_t·δ
      masked step:   λ ← δ; dx_t = dr_t = di_t = 0

    with q = ∂mult/∂log a = -(exp(2 log a)/mult) where the clip leaves
    1 - exp(2 log a) unchanged, 0 where it binds. dΛ = Σ_b (Σ_t d log a
    · c · r, t descending) · (1 - σ(Λ)), the rows summed in order;
    dh0 = λ after step 0. Every product and sum is one rounded float32
    operation in this order (the kernel repeats it)."""
    # the gates as the forward forms them, op for op
    a_base = torch.log(torch.sigmoid(lam))
    log_a = RGLRU_C * r * a_base
    a = torch.exp(log_a)
    e2 = torch.exp(2.0 * log_a)
    u = 1.0 - e2
    mult = torch.sqrt(torch.clamp(u, 1e-9, 1.0))
    q = torch.where(torch.clamp(u, 1e-9, 1.0) == u, -(e2 / mult), 0.0)
    ix = i * x
    dx = torch.zeros_like(x)
    dr = torch.zeros_like(x)
    di = torch.zeros_like(x)
    dab = torch.zeros_like(h0)  # Σ_t d log a · c · r, per (b, lane)
    lam_t = dh_final.clone()
    for t in range(x.shape[1] - 1, -1, -1):
        d = dhs[:, t] + lam_t
        hp = h0 if t == 0 else hs[:, t - 1]
        dg = d * mult[:, t]
        dla = (d * hp) * a[:, t] + (d * ix[:, t]) * q[:, t]
        dlc = dla * RGLRU_C
        upd = None if mask is None else mask[:, t, None]
        dx[:, t] = _where(upd, dg * i[:, t], 0.0)
        di[:, t] = _where(upd, dg * x[:, t], 0.0)
        dr[:, t] = _where(upd, dlc * a_base, 0.0)
        dab = _where(upd, dab + dlc * r[:, t], dab)
        lam_t = _where(upd, a[:, t] * d, d)
    tot = dab[0]
    for b in range(1, dab.shape[0]):
        tot = tot + dab[b]
    dlam = tot * (1.0 - torch.sigmoid(lam))
    return dx, dr, di, dlam, lam_t
