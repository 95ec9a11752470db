"""Layers of the port (PyTorch counterpart of ``repro.models.layers``):
attention (standard, partial and M-RoPE rotary; causal, bidirectional
for the encoder, and cross-attention over an encoder's K/V), MLP, the
capacity-dispatched MoE, the RG-LRU recurrent block and the xLSTM
blocks (mLSTM, sLSTM).

Parameters are plain mappings of tensors (``nn.ParameterDict`` inside the
model) in the JAX package's layouts — ``wq`` is ``(d, Hq, hd)``, ``wo``
is ``(Hq, hd, d)`` — so the weight bridge copies arrays unchanged and
every einsum below reads like its JAX twin.

Attention has two modes, as in the reference:
  * full sequence (prefill, training): causal (+window) mask from
    absolute positions, plain PyTorch attention (``_attn_core``) below
    ``_FLASH_THRESHOLD`` tokens and the memory-bounded flash attention
    with a hand-written backward (``_flash_attn_train``) at or past it,
    through ``kernels.flash.ops`` (the CUDA kernels for CUDA tensors,
    the plain tiles for CPU tensors);
  * cached verify block: the block's K/V are written to ring slots
    ``pos % S`` of the position-tagged cache (trash slot ``S`` for
    invalid tokens) *before* the read, so rejected drafts are overwritten
    by the next block and rollback is free. The read always goes through
    ``kernels.spec_verify.ops.spec_verify_attention`` — the CUDA kernel
    for CUDA tensors, its plain version for CPU tensors.

The RG-LRU block's recurrence always goes through
``kernels.rglru.ops.rglru_scan`` in the same way, prefill, verify and
training alike; under autograd its backward is the scan's backward
kernel (its plain version on the CPU). The xLSTM recurrences are
``lax.scan``s in the reference, with no Pallas kernel; here they are
loops over T of PyTorch ops.

Every recurrent block keeps the reference's two carries (``_gate_masks``):
the *dynamic* state advances through every updated step, the *committed*
state only through the steps before ``commit_upto`` (the acceptance
prefix of a verify block); ``collect=True`` returns the staged per-step
states instead, for ``model.commit_staged_cache``.
"""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.kernels.spec_verify.ops import spec_verify_attention
from repro_torch.kernels.xlstm import ops as xlstm_ops


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _dense_init(shape, dtype, gen: torch.Generator, device,
                scale: Optional[float] = None,
                experts: bool = False) -> torch.Tensor:
    """N(0, 1)·scale with scale = 1/sqrt(fan_in) (fan_in = shape[0], or
    shape[1] for an ``experts`` stack (E, in, out), as
    ``repro.models.layers._dense_init`` takes it), drawn in float32 on
    ``device`` and cast to ``dtype``. On the meta device nothing is drawn
    (``gen`` may be None): an empty tensor of the shape and dtype."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
    if experts:
        fan_in = shape[1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    if experts:  # one expert at a time: no float32 copy of the whole stack
        w = torch.empty(shape, dtype=dtype, device=device)
        for e in range(shape[0]):
            w[e] = torch.randn(shape[1:], generator=gen, device=device,
                               dtype=torch.float32).mul_(s)
        return w
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
# rotary embeddings: standard / partial (chatglm "2d") / M-RoPE (qwen2-vl)
# ---------------------------------------------------------------------------

def apply_rope(x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
               mrope_positions: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """x: (B, T, H, hd); positions: (B, T) int32 absolute positions.
    cos/sin are cast to ``x.dtype`` before the rotation, as in JAX.

    * standard: rotate the whole head_dim;
    * partial: rotate only ``rope_fraction`` of it (ChatGLM);
    * mrope: three position streams (t, h, w), ``mrope_positions`` (3, B,
      T), each owning a section of the rotary frequencies
      (``cfg.mrope_sections``); without them the three streams are
      ``positions`` and M-RoPE is standard RoPE, bit for bit.
    """
    if cfg.rope == "none":
        return x
    hd = x.shape[-1]
    rot = int(hd * (cfg.rope_fraction if cfg.rope == "partial" else 1.0))
    rot -= rot % 2
    freqs = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, rot, 2, dtype=torch.float32, device=x.device) / rot
    ))
    if cfg.rope == "mrope":
        if mrope_positions is None:
            mrope_positions = positions[None].expand(3, *positions.shape)
        owner = torch.cat([torch.full((n,), i, dtype=torch.long)
                           for i, n in enumerate(cfg.mrope_sections)]
                          )[:rot // 2].to(x.device)
        pos_f = mrope_positions.float()[owner]  # (rot/2, B, T)
        ang = pos_f.permute(1, 2, 0) * freqs  # (B, T, rot/2)
    else:
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

def init_attention(cfg: ModelConfig, gen: torch.Generator, device,
                   cross: bool = False) -> nn.ParameterDict:
    """Self-attention, or with ``cross`` an encoder-decoder's
    cross-attention (no biases, as in the reference)."""
    hd, Hq, Hkv, d = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads, cfg.d_model
    dt = torch_dtype(cfg.dtype)
    p = {
        "wq": _dense_init((d, Hq, hd), dt, gen, device),
        "wk": _dense_init((d, Hkv, hd), dt, gen, device),
        "wv": _dense_init((d, Hkv, hd), dt, gen, device),
        "wo": _dense_init((Hq, hd, d), dt, gen, device),
    }
    if cfg.attn_bias and not cross:
        p["bq"] = torch.zeros((Hq, hd), dtype=dt, device=device)
        p["bk"] = torch.zeros((Hkv, hd), dtype=dt, device=device)
        p["bv"] = torch.zeros((Hkv, hd), dtype=dt, device=device)
    return nn.ParameterDict({k: _param(v) for k, v in p.items()})


_NEG = -1e30


def _flash(q, k, v, qpos, kpos, kval, window: int, qc: int, kc: int,
           length: Optional[int] = None):
    """The counterpart of the reference's ``custom_vjp`` ``_flash``:
    ``kernels.flash.ops.FlashAttention`` (the CUDA kernels for CUDA
    tensors, the plain tiles of ``qc`` x ``kc`` for CPU tensors; on meta
    tensors the kernels' work counted at ``length``)."""
    return flash_ops.FlashAttention.apply(q, k, v, qpos, kpos, kval, window,
                                          qc, kc, length)


def _flash_inputs(q, k, v, positions, valid, q_chunk: int = 512,
                  kv_chunk: int = 1024):
    """``_flash``'s arguments for ``_flash_attn_train``: q (B, Sq, Hkv, G,
    hd) and k, v (B, Sk, Hkv, hd) padded to whole chunks, float positions
    (the pads at -1e30, keys past S invalid), and the chunks."""
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
    return (qq.reshape(B, Sq, Hkv, G, hd).contiguous(), kk.contiguous(),
            vv.contiguous(), qpos, kpos, kval, qc, kc)


def _flash_attn_train(q, k, v, positions, cfg: ModelConfig, *, window: int,
                      valid, q_chunk: int = 512, kv_chunk: int = 1024):
    """Memory-bounded causal attention for long full-sequence forwards
    (training / prefill): O(S·hd) residuals instead of O(S²) scores.
    positions: (B, S) absolute (left-pad aware); valid: (B, S) key
    validity or None. A query row that sees no key gets output 0.
    softcap unsupported here, as in the reference."""
    assert cfg.logit_softcap == 0.0, "flash train path: softcap unsupported"
    B, S, Hq, hd = q.shape
    qq, kk, vv, qpos, kpos, kval, qc, kc = _flash_inputs(
        q, k, v, positions, valid, q_chunk, kv_chunk)
    out = _flash(qq, kk, vv, qpos, kpos, kval, window, qc, kc, S)
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
    mrope_positions: Optional[torch.Tensor] = None,  # (3, B, T)
    bidirectional: bool = False,
    cross_kv: Optional[Tuple] = None,  # (k, v, key valid) cross-attention
):
    """Returns (y, kv). Cached path: ``kv_cache = (k, v, cache_pos)`` with
    k/v ``(B, S+1, Hkv, hd)`` and cache_pos ``(B, S+1)`` int32 (-1 =
    empty); slot S is the trash slot. The cache tensors are updated in
    place (the JAX round donates them) and returned.

    ``cross_kv = (k (B, S, Hkv, hd), v, kvalid (B, S) bool)`` is an
    encoder-decoder's cross-attention: no RoPE, keys masked by
    ``kvalid`` only, no cache (kv None). ``bidirectional`` (the encoder)
    masks keys by ``valid`` only and never takes the flash path,
    whatever T is. Both are plain PyTorch, as they are plain XLA in the
    reference."""
    B, T, _ = x.shape
    q = torch.einsum("btd,dhk->bthk", x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    if cross_kv is not None:
        ck, cv, kvalid = cross_kv
        mask = kvalid[:, None, None, :].expand(B, 1, T, ck.shape[1])
        out = _attn_core(q, ck, cv, mask, cfg)
        return torch.einsum("bthk,hkd->btd", out, p["wo"]), None
    k = torch.einsum("btd,dhk->bthk", x, p["wk"])
    v = torch.einsum("btd,dhk->bthk", x, p["wv"])
    if "bk" in p:
        k = k + p["bk"]
        v = v + p["bv"]
    q = apply_rope(q, positions, cfg, mrope_positions)
    k = apply_rope(k, positions, cfg, mrope_positions)

    if kv_cache is None:
        if not bidirectional and T >= _FLASH_THRESHOLD:
            out = _flash_attn_train(q, k, v, positions, cfg, window=window,
                                    valid=valid)
            y = torch.einsum("bthk,hkd->btd", out, p["wo"])
            return y, (k, v, positions)
        qpos = positions[:, :, None]
        kpos = positions[:, None, :]
        if bidirectional:
            mask = torch.ones((B, T, T), dtype=torch.bool, device=x.device)
        else:
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
    headroom: int = 64, device=None, slot_multiple: int = 1,
):
    """Zero cache for one attention layer (+1 trash slot); ring-sized
    (window + headroom) when windowed. ``slot_multiple`` rounds the slot
    count up (256 in the launch workloads, so that the slot dim can shard
    over a mesh's model axis where kv_heads cannot), as the reference
    does: the ring modulus is then ``slots - 1``, at least the retention
    needed, and the extra slots are never written (cache_pos stays -1)."""
    S = min(max_len, window + headroom) if window > 0 else max_len
    slots = S + 1
    if slot_multiple > 1:
        slots = -(-slots // slot_multiple) * slot_multiple
    hd, Hkv = cfg.head_dim, cfg.num_kv_heads
    dt = torch_dtype(cfg.dtype)
    return (
        torch.zeros((batch, slots, Hkv, hd), dtype=dt, device=device),
        torch.zeros((batch, slots, Hkv, hd), dtype=dt, device=device),
        torch.full((batch, slots), -1, dtype=torch.int32, device=device),
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
# Mixture of Experts (top-k, capacity-based GShard-style dispatch)
# ---------------------------------------------------------------------------

def init_moe(cfg: ModelConfig, gen: torch.Generator,
             device) -> nn.ParameterDict:
    """The reference's tree: a float32 router (d, E), expert stacks
    ``wi``/``wg`` (E, d, f) and ``wo`` (E, f, d), and with
    ``moe_dense_residual`` a nested ``dense`` MLP (Arctic)."""
    dt = torch_dtype(cfg.dtype)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {
        "router": _param(_dense_init((d, E), torch.float32, gen, device)),
        "wi": _param(_dense_init((E, d, f), dt, gen, device, experts=True)),
        "wg": _param(_dense_init((E, d, f), dt, gen, device, experts=True)),
        "wo": _param(_dense_init((E, f, d), dt, gen, device, experts=True)),
    }
    if cfg.moe_dense_residual:
        p["dense"] = init_mlp(cfg, gen, device)
    return nn.ParameterDict(p)


class MoERoute(NamedTuple):
    probs: torch.Tensor  # (N, E) float32 router softmax
    gate_vals: torch.Tensor  # (N, K) float32, renormalised over the K
    gate_idx: torch.Tensor  # (N, K) int64 experts, best first
    slot: torch.Tensor  # (N*K,) place in the expert's buffer, token-major
    keep: torch.Tensor  # (N*K,) bool: slot < cap
    cap: int


def moe_route(p: Mapping, xt: torch.Tensor, cfg: ModelConfig) -> MoERoute:
    """Routing of the (N, d) tokens, as ``repro.models.layers.apply_moe``
    routes: float32 router, softmax, top-k (ties to the lower expert, as
    ``lax.top_k``: a stable descending sort), renormalised gates, and each
    (token, k) pair's slot from the exclusive cumulative count of its
    expert over the pairs before it in token-major, k-minor order; pairs
    at or past the capacity ``max(1, int(capacity_factor * N * K / E))``
    are dropped. Every token of the forward counts, pads included."""
    N = xt.shape[0]
    E, K = cfg.num_experts, cfg.experts_per_token
    logits = xt.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, :K], idx[:, :K]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    cap = max(1, int(cfg.capacity_factor * N * K / E))
    onehot = F.one_hot(gate_idx.reshape(N * K), E).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0) - onehot  # (N*K, E)
    slot = (pos * onehot).sum(-1)
    return MoERoute(probs, gate_vals, gate_idx, slot, slot < cap, cap)


def apply_moe(p: Mapping, x: torch.Tensor,
              cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y, aux_loss). Tokens scatter into per-expert capacity
    buffers (E, cap, d) plus a trash row for the dropped pairs, the
    experts run as batched products (``torch.bmm``: the reference's
    einsums, outside any Pallas kernel there too), and the outputs gather
    back weighted by the gates in ``x.dtype`` and summed over K; Arctic
    adds its dense MLP branch. ``aux_loss`` is the Switch load-balance
    loss (float32)."""
    B, T, d = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    N = B * T
    xt = x.reshape(N, d)
    r = moe_route(p, xt, cfg)
    cap = r.cap
    e_flat = r.gate_idx.reshape(N * K)
    dest = torch.where(r.keep, e_flat * cap + r.slot, E * cap)
    buf = torch.zeros((E * cap + 1, d), dtype=xt.dtype, device=x.device)
    buf = buf.index_put((dest,), xt.repeat_interleave(K, dim=0))
    xin = buf[:E * cap].reshape(E, cap, d)
    h = torch.bmm(xin, p["wi"])
    g = torch.bmm(xin, p["wg"])
    h = F.silu(g) * h
    eout = torch.bmm(h, p["wo"]).reshape(E * cap, d)
    eout = torch.cat([eout, eout.new_zeros((1, d))], dim=0)
    y_flat = eout[dest] * r.gate_vals.reshape(N * K, 1).to(x.dtype)
    y = y_flat.reshape(N, K, d).sum(1).reshape(B, T, d)
    if cfg.moe_dense_residual and "dense" in p:
        y = y + apply_mlp(p["dense"], x, cfg)
    me = r.probs.mean(0)  # (E,)
    ce = F.one_hot(r.gate_idx[:, 0], E).float().mean(0)
    aux = E * torch.sum(me * ce) * cfg.router_aux_weight
    return y, aux


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


def _gate_masks(B: int, T: int, update_mask: Optional[torch.Tensor],
                commit_upto: Optional[torch.Tensor], device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(upd (T, B), com (T, B)) bool gating masks of the recurrent scans,
    time-major as the reference's.

    * ``update_mask`` (B, T) gates the *dynamic* state: False for pads
      (left-padded prefill) and for frozen (finished) rows.
    * ``commit_upto`` (B,) gates the *committed* state: step t commits
      iff it updates and t < commit_upto (the acceptance prefix of a
      verify block). None commits every updated step (train, prefill).
    """
    upd = (torch.ones((T, B), dtype=torch.bool, device=device)
           if update_mask is None else update_mask.t().contiguous())
    if commit_upto is None:
        return upd, upd
    t = torch.arange(T, device=device)[:, None]
    return upd, upd & (t < commit_upto[None, :])


def _committed_conv(xr_pad: torch.Tensor, commit_upto: torch.Tensor,
                    cw: int) -> torch.Tensor:
    """The committed conv context ``xr_pad[:, upto : upto+cw-1]`` per row,
    as the reference's ``jnp.take_along_axis`` (default mode ``"fill"``)
    reads it: an index below 0 counts from the end once (numpy's
    normalisation), and one still outside [0, T+cw-1) after that reads
    NaN. So ``commit_upto`` in [0, T] gives the true context, T+1 and
    past put NaN in the taps past the end, and -1 wraps to the last
    input."""
    L_ = xr_pad.shape[1]
    idx = commit_upto.long()[:, None] + torch.arange(
        cw - 1, device=xr_pad.device)[None, :]
    idx = torch.where(idx < 0, idx + L_, idx)
    inside = (idx >= 0) & (idx < L_)
    got = xr_pad.gather(1, idx.clamp(0, L_ - 1)[:, :, None].expand(
        -1, -1, xr_pad.shape[2]))
    return torch.where(inside[:, :, None], got, float("nan"))


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

    ``commit_upto`` (B,) int returns the *committed* carry instead of the
    dynamic one: the reference's dual-carry scan. The scan stays on the
    kernel: the dynamic state changes only on updated steps, and step t
    commits iff it updates and t < commit_upto, so the committed carry is
    the dynamic state after step commit_upto - 1, which is
    ``cat([state, hs], 1)[:, clamp(commit_upto, 0, T)]`` (the reference
    commits nothing below 0 and every updated step past T). The conv
    context is ``_committed_conv``'s."""
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
    elif commit_upto is not None:
        new_conv_state = _committed_conv(xr_pad, commit_upto, cw)
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
    elif commit_upto is not None:
        at = commit_upto.long().clamp(0, T)
        h_fin = torch.cat([state[:, None], hs], dim=1)[
            torch.arange(B, device=x.device), at]
    return y, h_fin, new_conv_state


# ---------------------------------------------------------------------------
# xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM
# ---------------------------------------------------------------------------

def init_mlstm(cfg: ModelConfig, gen: torch.Generator,
               device) -> nn.ParameterDict:
    dt, f32 = torch_dtype(cfg.dtype), torch.float32
    d, w, H = cfg.d_model, cfg.rnn_width, max(cfg.num_heads, 1)
    p = {
        "wq": _dense_init((d, w), dt, gen, device),
        "wk": _dense_init((d, w), dt, gen, device),
        "wv": _dense_init((d, w), dt, gen, device),
        "wi": _dense_init((d, H), f32, gen, device, scale=0.1),
        "wf": _dense_init((d, H), f32, gen, device, scale=0.1),
        "bf": torch.full((H,), 3.0, dtype=f32, device=device),
        "wo_gate": _dense_init((d, w), dt, gen, device),
        "wo": _dense_init((w, d), dt, gen, device),
    }
    return nn.ParameterDict({k: _param(v) for k, v in p.items()})


def init_slstm(cfg: ModelConfig, gen: torch.Generator,
               device) -> nn.ParameterDict:
    dt, f32 = torch_dtype(cfg.dtype), torch.float32
    d, w, H = cfg.d_model, cfg.rnn_width, max(cfg.num_heads, 1)
    hd = w // H
    p = {
        "wz": _dense_init((d, w), dt, gen, device),
        "wi": _dense_init((d, w), f32, gen, device, scale=0.05),
        "wf": _dense_init((d, w), f32, gen, device, scale=0.05),
        "wo_g": _dense_init((d, w), dt, gen, device),
        # head-wise recurrent kernel (block-diagonal R)
        "r": _dense_init((H, hd, hd), f32, gen, device, scale=0.2),
        "bf": torch.full((w,), 2.0, dtype=f32, device=device),
        "wo": _dense_init((w, d), dt, gen, device),
    }
    return nn.ParameterDict({k: _param(v) for k, v in p.items()})


def apply_mlstm(
    p: Mapping,
    x: torch.Tensor,
    cfg: ModelConfig,
    state: Optional[Mapping[str, torch.Tensor]] = None,
    update_mask: Optional[torch.Tensor] = None,  # (B, T) bool
    commit_upto: Optional[torch.Tensor] = None,  # (B,) int
    collect: bool = False,
):
    """mLSTM with exponential gating and matrix memory. Returns (y,
    new_state), the state a dict ``{"C" (B, H, hd, hd), "n" (B, H, hd),
    "m" (B, H)}`` in float32 (m starts at -inf): the state after every
    updated step, the committed carry with ``commit_upto``, or with
    ``collect`` the staged states (B, T+1, ...), index 0 the state
    before the block.

    The reference's dtypes step for step: q, k, v in the model dtype (k
    divided by sqrt(hd) there), the outer product k_t ⊗ v_t formed in the
    model dtype before the float32 gate multiplies it, q upcast only
    where it meets the float32 state, h cast back to ``x.dtype`` before
    the ``silu(wo_gate)`` product. An output at a step that does not
    update (a pad, a frozen row) is read from the would-be new state, as
    in the reference.

    The recurrence over T, its stabilizer and the denominators
    max(|q·n|, exp(-m)) run in ``kernels.xlstm.ops.mlstm_scan``: one
    kernel launch on the card (a backward kernel under autograd), the
    plain loop on the CPU. The cell C and the normaliser n step together
    there, as one (B, H, hd, hd+1) tensor [C|n]."""
    B, T, _ = x.shape
    H = max(cfg.num_heads, 1)
    W = cfg.rnn_width
    hd = W // H
    # time-major (T, B, ...) from here on: each step's slice is contiguous
    xt = x.transpose(0, 1)
    q = torch.einsum("tbd,dw->tbw", xt, p["wq"]).reshape(T, B, H, hd)
    k = torch.einsum("tbd,dw->tbw", xt, p["wk"]).reshape(
        T, B, H, hd) / math.sqrt(hd)
    v = torch.einsum("tbd,dw->tbw", xt, p["wv"]).reshape(T, B, H, hd)
    xf = xt.float()
    i_pre = torch.einsum("tbd,dh->tbh", xf, p["wi"])
    f_pre = torch.einsum("tbd,dh->tbh", xf, p["wf"]) + p["bf"]
    f32 = dict(dtype=torch.float32, device=x.device)
    if state is None:
        C0 = torch.zeros((B, H, hd, hd), **f32)
        n0 = torch.zeros((B, H, hd), **f32)
        m0 = torch.full((B, H), -math.inf, **f32)
    else:
        C0, n0, m0 = state["C"], state["n"], state["m"]
    upd = com = None
    if update_mask is not None or commit_upto is not None:
        upd, com = _gate_masks(B, T, update_mask, commit_upto, x.device)
        com = com if commit_upto is not None else None
    h, Cn, m = xlstm_ops.mlstm_scan(q, k, v, i_pre, f_pre, C0, n0, m0, upd,
                                    com, collect)
    h = h.reshape(T, B, W).transpose(0, 1).to(x.dtype)
    gate = F.silu(torch.einsum("btd,dw->btw", x, p["wo_gate"]))
    y = torch.einsum("btw,wd->btd", h * gate, p["wo"])
    return y, {"C": Cn[..., :hd], "n": Cn[..., hd], "m": m}


def apply_slstm(
    p: Mapping,
    x: torch.Tensor,
    cfg: ModelConfig,
    state: Optional[Mapping[str, torch.Tensor]] = None,
    update_mask: Optional[torch.Tensor] = None,  # (B, T) bool
    commit_upto: Optional[torch.Tensor] = None,  # (B,) int
    collect: bool = False,
):
    """sLSTM with scalar memory, exponential gating and a head-wise
    recurrence. Returns (y, new_state), the state a dict ``{"c", "n",
    "h", "m"}``, each (B, W) float32 (m starts at -inf), with the same
    three readings as ``apply_mlstm``'s (dynamic, committed, staged).

    The reference's mix of dtypes: z and o pre-activations in the model
    dtype, then upcast; i and f from an upcast x; the recurrence
    ``h R`` in float32 with a float32 R; n clamped at 1e-6 in the
    division. The output is the gated h (a step that does not update
    repeats the last h). The recurrence over T and its stabilizer run in
    ``kernels.xlstm.ops.slstm_scan`` (one kernel launch on the card, a
    backward kernel under autograd, the plain loop on the CPU), on c, n
    and h as one head-major (3, H, B, hd) tensor."""
    B, T, _ = x.shape
    H = max(cfg.num_heads, 1)
    W = cfg.rnn_width
    hd = W // H
    # time- and head-major (T, H, B, hd) from here on: each step's slice
    # is contiguous and h R is one batched product over the heads
    xt = x.transpose(0, 1)
    xf = xt.float()

    def heads(a):  # (T, B, W) -> (T, H, B, hd)
        return a.reshape(T, B, H, hd).transpose(1, 2).contiguous()

    z_in = heads(torch.einsum("tbd,dw->tbw", xt, p["wz"]).float())
    i_in = heads(torch.einsum("tbd,dw->tbw", xf, p["wi"]))
    f_in = heads(torch.einsum("tbd,dw->tbw", xf, p["wf"]) + p["bf"])
    o_sig = heads(torch.sigmoid(
        torch.einsum("tbd,dw->tbw", xt, p["wo_g"]).float()))
    f32 = dict(dtype=torch.float32, device=x.device)
    if state is None:
        cnh = torch.zeros((3, H, B, hd), **f32)
        m0 = torch.full((H, B, hd), -math.inf, **f32)
    else:
        cnh = torch.stack([state[k].reshape(B, H, hd).transpose(0, 1)
                           for k in ("c", "n", "h")])
        m0 = state["m"].reshape(B, H, hd).transpose(0, 1).contiguous()
    upd = com = None
    if update_mask is not None or commit_upto is not None:
        upd, com = _gate_masks(B, T, update_mask, commit_upto, x.device)
        com = com if commit_upto is not None else None
    hs, cnh, m = xlstm_ops.slstm_scan(z_in, i_in, f_in, o_sig, p["r"], cnh,
                                      m0, upd, com, collect)

    def back(a):  # (..., H, B, hd) -> (B, ..., W)
        a = a.movedim(-2, 0)
        return a.reshape(*a.shape[:-2], W)

    h = back(hs).to(x.dtype)  # (B, T, W)
    y = torch.einsum("btw,wd->btd", h, p["wo"])
    c, n, hh = back(cnh).unbind(1)
    return y, {"c": c, "n": n, "h": hh, "m": back(m)}
