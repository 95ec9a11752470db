"""Decoder layers of the port (PyTorch counterpart of
``repro.models.layers``): attention, MLP and the RG-LRU recurrent block.

Parameters are plain mappings of tensors (``nn.ParameterDict`` inside the
model) in the JAX package's layouts — ``wq`` is ``(d, Hq, hd)``, ``wo``
is ``(Hq, hd, d)`` — so the weight bridge copies arrays unchanged and
every einsum below reads like its JAX twin.

Attention has two modes, as in the reference:
  * full sequence (prefill, training): causal (+window) mask from
    absolute positions, plain PyTorch attention (``_attn_core``) below
    ``_FLASH_THRESHOLD`` tokens and the memory-bounded flash attention
    with a hand-written backward (``_flash_attn_train``) at or past it;
  * cached verify block: the block's K/V are written to ring slots
    ``pos % S`` of the position-tagged cache (trash slot ``S`` for
    invalid tokens) *before* the read, so rejected drafts are overwritten
    by the next block and rollback is free. The read always goes through
    ``kernels.spec_verify.ops.spec_verify_attention`` — the CUDA kernel
    for CUDA tensors, its plain version for CPU tensors.

The RG-LRU block's recurrence always goes through
``kernels.rglru.ops.rglru_scan`` in the same way, prefill, verify and
training alike; under autograd its backward is the scan's backward
kernel (its plain version on the CPU).
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.kernels.spec_verify.ops import spec_verify_attention


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _dense_init(shape, dtype, gen: torch.Generator, device,
                scale: Optional[float] = None) -> torch.Tensor:
    """N(0, 1)·scale with scale = 1/sqrt(fan_in) (fan_in = shape[0], as
    ``repro.models.layers._dense_init`` takes it for every dense kernel
    here), drawn in float32 on ``device`` and cast to ``dtype``."""
    fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return w.mul_(s).to(dtype)


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, device) -> nn.ParameterDict:
    p = {"scale": _param(torch.ones(cfg.d_model, device=device))}
    if cfg.norm == "layer":
        p["bias"] = _param(torch.zeros(cfg.d_model, device=device))
    return nn.ParameterDict(p)


def apply_norm(p: Mapping, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layer":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, unbiased=False, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"] + p["bias"]
    else:
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps) * p["scale"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings: standard / partial (M-RoPE is not ported yet)
# ---------------------------------------------------------------------------

def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """x: (B, T, H, hd); positions: (B, T) int32 absolute positions.
    cos/sin are cast to ``x.dtype`` before the rotation, as in JAX."""
    if cfg.rope == "none":
        return x
    if cfg.rope == "mrope":
        raise NotImplementedError("M-RoPE is not ported yet")
    hd = x.shape[-1]
    rot = int(hd * (cfg.rope_fraction if cfg.rope == "partial" else 1.0))
    rot -= rot % 2
    freqs = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, rot, 2, dtype=torch.float32, device=x.device) / rot
    ))
    ang = positions.float()[..., None] * freqs  # (B, T, rot/2)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)  # (B, T, 1, rot/2)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., : rot // 2], x_rot[..., rot // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out, x_pass], dim=-1)


# ---------------------------------------------------------------------------
# attention (GQA, sliding window, cached verify blocks)
# ---------------------------------------------------------------------------

def init_attention(cfg: ModelConfig, gen: torch.Generator,
                   device) -> nn.ParameterDict:
    hd, Hq, Hkv, d = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads, cfg.d_model
    dt = torch_dtype(cfg.dtype)
    p = {
        "wq": _dense_init((d, Hq, hd), dt, gen, device),
        "wk": _dense_init((d, Hkv, hd), dt, gen, device),
        "wv": _dense_init((d, Hkv, hd), dt, gen, device),
        "wo": _dense_init((Hq, hd, d), dt, gen, device),
    }
    if cfg.attn_bias:
        p["bq"] = torch.zeros((Hq, hd), dtype=dt, device=device)
        p["bk"] = torch.zeros((Hkv, hd), dtype=dt, device=device)
        p["bv"] = torch.zeros((Hkv, hd), dtype=dt, device=device)
    return nn.ParameterDict({k: _param(v) for k, v in p.items()})


_NEG = -1e30


def _flash_mask(qp, kp, kval, window: int) -> torch.Tensor:
    """(B, qc, kc) bool from float position chunks."""
    m = (kp[:, None, :] <= qp[:, :, None]) & (kval[:, None, :] > 0)
    if window > 0:
        m &= kp[:, None, :] > (qp[:, :, None] - window)
    return m


def _f32(t: torch.Tensor) -> torch.Tensor:
    # bf16 x bf16 products are exact in float32, so an upcast before the
    # product is the reference's preferred_element_type=float32
    return t.float()


def _flash_fwd_impl(q, k, v, qpos, kpos, kval, window: int, qc: int,
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
        m = torch.full((B, Hkv, G, qc), _NEG, device=q.device)
        l = torch.zeros((B, Hkv, G, qc), device=q.device)
        acc = torch.zeros((B, Hkv, G, qc, hd), device=q.device)
        for k0 in range(0, Sk, kc):
            s = torch.einsum("bqkgh,bckh->bkgqc", q_blk,
                             _f32(k[:, k0:k0 + kc])) * scale
            msk = _flash_mask(qp, kpos[:, k0:k0 + kc], kval[:, k0:k0 + kc],
                              window)[:, None, None]
            s = torch.where(msk, s, _NEG)
            m_new = torch.maximum(m, s.amax(-1))
            m_safe = torch.where(m_new <= _NEG, 0.0, m_new)
            p = torch.exp(s - m_safe[..., None])
            alpha = torch.where(m <= _NEG, 0.0, torch.exp(m - m_safe))
            l = alpha * l + p.sum(-1)
            v_blk = v[:, k0:k0 + kc]
            acc = alpha[..., None] * acc + torch.einsum(
                "bkgqc,bckh->bkgqh", _f32(p.to(v_blk.dtype)), _f32(v_blk))
            m = m_new
        o = acc / torch.clamp(l[..., None], min=1e-20)
        out[:, q0:q0 + qc] = o.permute(0, 3, 1, 2, 4).to(q.dtype)
        lse[..., q0:q0 + qc] = m + torch.log(torch.clamp(l, min=1e-20))
    return out, lse


def _flash_bwd_impl(q, k, v, qpos, kpos, kval, out, lse, dout, window: int,
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
            msk = _flash_mask(qp, kpos[:, k0:k0 + kc], kval[:, k0:k0 + kc],
                              window)[:, None, None]
            p = torch.where(msk, torch.exp(s - lse_q[..., None]), 0.0)
            dv[:, k0:k0 + kc] += torch.einsum("bkgqc,bqkgh->bckh", p, do_blk)
            dp = torch.einsum("bqkgh,bckh->bkgqc", do_blk, v_blk)
            ds = p * (dp - D_q[..., None]) * scale
            dq_acc += torch.einsum("bkgqc,bckh->bqkgh", ds, k_blk)
            dk[:, k0:k0 + kc] += torch.einsum("bkgqc,bqkgh->bckh", ds, q_blk)
        dq[:, q0:q0 + qc] = dq_acc
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Flash(torch.autograd.Function):
    """Flash attention with a hand-written backward (O(S) memory forward
    AND backward), the counterpart of the reference's ``custom_vjp``
    ``_flash``. q: (B, Sq, Hkv, G, hd); k/v: (B, Sk, Hkv, hd);
    qpos/kpos/kval are float tensors. Saved residuals: the inputs plus
    ``out`` and ``lse`` only — the backward recomputes P per tile, so no
    (Sq, Sk) tensor outlives a tile."""

    @staticmethod
    def forward(ctx, q, k, v, qpos, kpos, kval, window, qc, kc):
        out, lse = _flash_fwd_impl(q, k, v, qpos, kpos, kval, window, qc, kc)
        ctx.save_for_backward(q, k, v, qpos, kpos, kval, out, lse)
        ctx.cfg = (window, qc, kc)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, qpos, kpos, kval, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_impl(q, k, v, qpos, kpos, kval, out, lse,
                                     dout, *ctx.cfg)
        return dq, dk, dv, None, None, None, None, None, None


def _flash(q, k, v, qpos, kpos, kval, window: int, qc: int, kc: int):
    return _Flash.apply(q, k, v, qpos, kpos, kval, window, qc, kc)


def _flash_attn_train(q, k, v, positions, cfg: ModelConfig, *, window: int,
                      valid, q_chunk: int = 512, kv_chunk: int = 1024):
    """Memory-bounded causal attention for long full-sequence forwards
    (training / prefill): O(S·hd) residuals instead of O(S²) scores.
    positions: (B, S) absolute (left-pad aware); valid: (B, S) key
    validity or None. A query row that sees no key gets output 0.
    softcap unsupported here, as in the reference."""
    assert cfg.logit_softcap == 0.0, "flash train path: softcap unsupported"
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qc = min(q_chunk, S)
    kc = min(kv_chunk, S)
    Sq = ((S + qc - 1) // qc) * qc
    Sk = ((S + kc - 1) // kc) * kc
    qq = F.pad(q, (0, 0, 0, 0, 0, Sq - S))
    kk = F.pad(k, (0, 0, 0, 0, 0, Sk - S))
    vv = F.pad(v, (0, 0, 0, 0, 0, Sk - S))
    posf = positions.float()
    qpos = F.pad(posf, (0, Sq - S), value=-1e30)
    kpos = F.pad(posf, (0, Sk - S), value=-1e30)
    kval = (valid.float() if valid is not None
            else torch.ones((B, S), device=q.device))
    kval = F.pad(kval, (0, Sk - S))
    out = _flash(qq.reshape(B, Sq, Hkv, G, hd), kk, vv, qpos, kpos, kval,
                 window, qc, kc)
    return out[:, :S].reshape(B, S, Hq, hd)


# Full-sequence causal forwards at or past this length take
# ``_flash_attn_train``, as in the reference.
_FLASH_THRESHOLD = 2048


def _attn_core(q, k, v, mask, cfg: ModelConfig) -> torch.Tensor:
    """q: (B,T,Hq,hd), k/v: (B,S,Hkv,hd), mask: (B,1,T,S). Scores in
    float32; probabilities cast to ``q.dtype`` before the value product."""
    B, T, Hq, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, T, Hkv, Hq // Hkv, hd)
    scores = torch.einsum("btkgh,bskh->bkgts", qg.float(), k.float())
    scores = scores / math.sqrt(hd)
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        scores = torch.tanh(scores / c) * c
    scores = torch.where(mask[:, :, None], scores, _NEG)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgts,bskh->btkgh", probs, v)
    return out.reshape(B, T, Hq, hd)


def attention_forward(
    p: Mapping,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,  # (B, T) int32 absolute positions
    window: int = 0,  # 0 = full
    kv_cache: Optional[Tuple] = None,  # (k, v, cache_pos) or None
    valid: Optional[torch.Tensor] = None,  # (B, T) bool
):
    """Returns (y, kv). Cached path: ``kv_cache = (k, v, cache_pos)`` with
    k/v ``(B, S+1, Hkv, hd)`` and cache_pos ``(B, S+1)`` int32 (-1 =
    empty); slot S is the trash slot. The cache tensors are updated in
    place (the JAX round donates them) and returned."""
    B, T, _ = x.shape
    q = torch.einsum("btd,dhk->bthk", x, p["wq"])
    k = torch.einsum("btd,dhk->bthk", x, p["wk"])
    v = torch.einsum("btd,dhk->bthk", x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = apply_rope(q, positions, cfg)
    k = apply_rope(k, positions, cfg)

    if kv_cache is None:
        if T >= _FLASH_THRESHOLD:
            out = _flash_attn_train(q, k, v, positions, cfg, window=window,
                                    valid=valid)
            y = torch.einsum("bthk,hkd->btd", out, p["wo"])
            return y, (k, v, positions)
        qpos = positions[:, :, None]
        kpos = positions[:, None, :]
        mask = kpos <= qpos
        if window > 0:
            mask &= kpos > qpos - window
        if valid is not None:
            mask &= valid[:, None, :]
        out = _attn_core(q, k, v, mask[:, None], cfg)
        y = torch.einsum("bthk,hkd->btd", out, p["wo"])
        return y, (k, v, positions)

    ck, cv, cpos = kv_cache
    S = ck.shape[1] - 1  # last slot is the trash slot
    if valid is None:
        slots = positions % S
        pos_write = positions
    else:
        slots = torch.where(valid, positions % S, S)
        pos_write = torch.where(valid, positions, -1)
    bidx = torch.arange(B, device=x.device)[:, None]
    ck[bidx, slots] = k.to(ck.dtype)
    cv[bidx, slots] = v.to(cv.dtype)
    cpos[bidx, slots] = pos_write.to(cpos.dtype)
    out = spec_verify_attention(
        q, ck, cv, cpos, positions, window=window,
        softcap=cfg.logit_softcap,
    )
    y = torch.einsum("bthk,hkd->btd", out, p["wo"])
    return y, (ck, cv, cpos)


def init_kv_cache(
    cfg: ModelConfig, batch: int, max_len: int, window: int = 0,
    headroom: int = 64, device=None,
):
    """Zero cache for one attention layer (+1 trash slot); ring-sized
    (window + headroom) when windowed."""
    S = min(max_len, window + headroom) if window > 0 else max_len
    hd, Hkv = cfg.head_dim, cfg.num_kv_heads
    dt = torch_dtype(cfg.dtype)
    return (
        torch.zeros((batch, S + 1, Hkv, hd), dtype=dt, device=device),
        torch.zeros((batch, S + 1, Hkv, hd), dtype=dt, device=device),
        torch.full((batch, S + 1), -1, dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(cfg: ModelConfig, gen: torch.Generator,
             device) -> nn.ParameterDict:
    dt = torch_dtype(cfg.dtype)
    d, f = cfg.d_model, cfg.d_ff
    p = {"wi": _dense_init((d, f), dt, gen, device)}
    if cfg.mlp == "swiglu":
        p["wg"] = _dense_init((d, f), dt, gen, device)
    p["wo"] = _dense_init((f, d), dt, gen, device)
    return nn.ParameterDict({k: _param(v) for k, v in p.items()})


def apply_mlp(p: Mapping, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = torch.einsum("btd,df->btf", x, p["wi"])
    if cfg.mlp == "swiglu":
        g = torch.einsum("btd,df->btf", x, p["wg"])
        h = F.silu(g) * h
    else:
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    return torch.einsum("btf,fd->btd", h, p["wo"])


# ---------------------------------------------------------------------------
# RG-LRU recurrent block (RecurrentGemma, arXiv:2402.19427)
# ---------------------------------------------------------------------------

def init_rglru(cfg: ModelConfig, gen: torch.Generator,
               device) -> nn.ParameterDict:
    dt = torch_dtype(cfg.dtype)
    d, w, f32 = cfg.d_model, cfg.rnn_width, torch.float32
    # Λ so that a = sigmoid(Λ)^(c·r) starts near 0.9..0.999
    lam = torch.log(torch.expm1(
        torch.linspace(0.9, 0.999, w, dtype=f32, device=device) ** (1 / 8)))
    p = {
        "wx": _dense_init((d, w), dt, gen, device),  # branch in
        "wy": _dense_init((d, w), dt, gen, device),  # gate branch
        "wo": _dense_init((w, d), dt, gen, device),
        "conv": _dense_init((cfg.conv_width, w), dt, gen, device, scale=0.5),
        "w_a": _dense_init((w,), f32, gen, device, scale=1.0),
        "w_i": _dense_init((w,), f32, gen, device, scale=1.0),
        "lam": lam,
    }
    return nn.ParameterDict({k: _param(v) for k, v in p.items()})


def apply_rglru(
    p: Mapping,
    x: torch.Tensor,
    cfg: ModelConfig,
    state: Optional[torch.Tensor] = None,  # (B, W) float32
    conv_state: Optional[torch.Tensor] = None,  # (B, cw-1, W)
    update_mask: Optional[torch.Tensor] = None,  # (B, T) bool
    commit_upto: Optional[torch.Tensor] = None,
    collect: bool = False,
):
    """RecurrentGemma recurrent block. Returns (y, new_state,
    new_conv_state), the state after every updated step (pads and frozen
    rows, ``update_mask`` False, change nothing).

    ``collect=True`` (single-pass speculative verify) returns STAGED
    per-step candidates instead: new_state (B, T+1, W) and new_conv_state
    (B, T+1, cw-1, W), index t = the state after t steps; the engine
    gathers them at the acceptance count (``model.commit_staged_cache``).
    The reference's dual-carry ``commit_upto`` branch is not ported:
    nothing on the serving path reaches it for recurrent models."""
    if commit_upto is not None:
        raise NotImplementedError(
            "apply_rglru's commit_upto (dual-carry) branch is not ported; "
            "verify with collect=True and commit_staged_cache"
        )
    B, T, _ = x.shape
    W, cw = cfg.rnn_width, cfg.conv_width
    gate_in = torch.einsum("btd,dw->btw", x, p["wy"])
    xr = torch.einsum("btd,dw->btw", x, p["wx"])
    if update_mask is not None:
        update_mask = update_mask.contiguous()
        # pads / frozen rows contribute nothing to conv or recurrence
        xr = torch.where(update_mask[:, :, None], xr, 0.0)
    # temporal conv with cached left context
    if conv_state is None:
        conv_state = torch.zeros((B, cw - 1, W), dtype=xr.dtype,
                                 device=x.device)
    xr_pad = torch.cat([conv_state, xr], dim=1)  # (B, T+cw-1, W)
    if collect:
        # staged conv contexts: candidate t = xr_pad[:, t : t+cw-1]
        new_conv_state = xr_pad.unfold(1, cw - 1, 1).transpose(2, 3)
    else:
        new_conv_state = xr_pad[:, T:]
    # the reference's order and dtype: sum over taps in the model dtype
    xc = sum(xr_pad[:, k:k + T] * p["conv"][k][None, None, :]
             for k in range(cw))
    xf = xc.float()
    r = torch.sigmoid(xf * p["w_a"])  # recurrence gate r_t
    i = torch.sigmoid(xf * p["w_i"])  # input gate i_t
    if state is None:
        state = torch.zeros((B, W), dtype=torch.float32, device=x.device)
    hs, h_fin = rglru_ops.rglru_scan(xf, r, i, p["lam"], state, update_mask)
    y = hs.to(x.dtype) * F.gelu(gate_in, approximate="tanh")
    y = torch.einsum("btw,wd->btd", y, p["wo"])
    if collect:
        h_fin = torch.cat([state[:, None], hs], dim=1)
    return y, h_fin, new_conv_state
