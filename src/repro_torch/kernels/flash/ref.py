"""Plain PyTorch versions of the flash attention kernels
(``csrc/flash_attn.cu``): the tiled online softmax and its backward that
``models.layers`` ran before the kernels, moved here with their
arithmetic unchanged (the counterpart of the reference's ``custom_vjp``
``_flash``, ``src/repro/models/layers.py:201``).

Layouts: q (B, Sq, Hkv, G, hd), k and v (B, Sk, Hkv, hd), float
positions qpos (B, Sq), kpos and kval (B, Sk); out like q and lse (B,
Hkv, G, Sq) float32. ``qc`` and ``kc`` are the tiles' query and key
chunks, which must divide Sq and Sk.

The CPU tests run these; ``chip_smoke.py`` holds the kernels against
them. Nothing on the card path calls them.
"""

from __future__ import annotations

import math

import torch

NEG = -1e30


def flash_mask(qp, kp, kval, window: int) -> torch.Tensor:
    """(B, qc, kc) bool from float position chunks."""
    m = (kp[:, None, :] <= qp[:, :, None]) & (kval[:, None, :] > 0)
    if window > 0:
        m &= kp[:, None, :] > (qp[:, :, None] - window)
    return m


def _f32(t: torch.Tensor) -> torch.Tensor:
    # bf16 x bf16 products are exact in float32, so an upcast before the
    # product is the reference's preferred_element_type=float32
    return t.float()


def flash_fwd_ref(q, k, v, qpos, kpos, kval, window: int, qc: int,
                  kc: int):
    """Tiled online softmax; returns out (B, Sq, Hkv, G, hd) in q.dtype
    and lse (B, Hkv, G, Sq) float32."""
    B, Sq, Hkv, G, hd = q.shape
    Sk = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    lse = torch.empty((B, Hkv, G, Sq), dtype=torch.float32, device=q.device)
    for q0 in range(0, Sq, qc):
        q_blk = _f32(q[:, q0:q0 + qc])
        qp = qpos[:, q0:q0 + qc]
        m = torch.full((B, Hkv, G, qc), NEG, device=q.device)
        l = torch.zeros((B, Hkv, G, qc), device=q.device)
        acc = torch.zeros((B, Hkv, G, qc, hd), device=q.device)
        for k0 in range(0, Sk, kc):
            s = torch.einsum("bqkgh,bckh->bkgqc", q_blk,
                             _f32(k[:, k0:k0 + kc])) * scale
            msk = flash_mask(qp, kpos[:, k0:k0 + kc], kval[:, k0:k0 + kc],
                             window)[:, None, None]
            s = torch.where(msk, s, NEG)
            m_new = torch.maximum(m, s.amax(-1))
            m_safe = torch.where(m_new <= NEG, 0.0, m_new)
            p = torch.exp(s - m_safe[..., None])
            alpha = torch.where(m <= NEG, 0.0, torch.exp(m - m_safe))
            l = alpha * l + p.sum(-1)
            v_blk = v[:, k0:k0 + kc]
            acc = alpha[..., None] * acc + torch.einsum(
                "bkgqc,bckh->bkgqh", _f32(p.to(v_blk.dtype)), _f32(v_blk))
            m = m_new
        o = acc / torch.clamp(l[..., None], min=1e-20)
        out[:, q0:q0 + qc] = o.permute(0, 3, 1, 2, 4).to(q.dtype)
        lse[..., q0:q0 + qc] = m + torch.log(torch.clamp(l, min=1e-20))
    return out, lse


def flash_bwd_ref(q, k, v, qpos, kpos, kval, out, lse, dout, window: int,
                  qc: int, kc: int):
    """Recomputes P per (q-chunk, kv-chunk) tile from ``lse``; returns
    (dq, dk, dv) in the inputs' dtypes."""
    B, Sq, Hkv, G, hd = q.shape
    Sk = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    # D = rowsum(dO * O)  (B, Hkv, G, Sq)
    Drow = torch.einsum("bskgh,bskgh->bkgs", _f32(dout), _f32(out))
    dq = torch.empty((B, Sq, Hkv, G, hd), dtype=torch.float32,
                     device=q.device)
    dk = torch.zeros((B, Sk, Hkv, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for q0 in range(0, Sq, qc):
        q_blk = _f32(q[:, q0:q0 + qc])
        do_blk = _f32(dout[:, q0:q0 + qc])
        qp = qpos[:, q0:q0 + qc]
        lse_q = lse[..., q0:q0 + qc]
        D_q = Drow[..., q0:q0 + qc]
        dq_acc = torch.zeros((B, qc, Hkv, G, hd), device=q.device)
        for k0 in range(0, Sk, kc):
            k_blk = _f32(k[:, k0:k0 + kc])
            v_blk = _f32(v[:, k0:k0 + kc])
            s = torch.einsum("bqkgh,bckh->bkgqc", q_blk, k_blk) * scale
            msk = flash_mask(qp, kpos[:, k0:k0 + kc], kval[:, k0:k0 + kc],
                             window)[:, None, None]
            p = torch.where(msk, torch.exp(s - lse_q[..., None]), 0.0)
            dv[:, k0:k0 + kc] += torch.einsum("bkgqc,bqkgh->bckh", p, do_blk)
            dp = torch.einsum("bqkgh,bckh->bkgqc", do_blk, v_blk)
            ds = p * (dp - D_q[..., None]) * scale
            dq_acc += torch.einsum("bkgqc,bckh->bqkgh", ds, k_blk)
            dk[:, k0:k0 + kc] += torch.einsum("bkgqc,bqkgh->bckh", ds, q_blk)
        dq[:, q0:q0 + qc] = dq_acc
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
