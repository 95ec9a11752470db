"""Model assembly of the port: embedding → decoder blocks → head
(PyTorch counterpart of ``repro.models.model``): dense attention
decoders and the hybrid RG-LRU + local-attention stack (RecurrentGemma).

The reference groups layers into ``lax.scan`` stages over stacked
parameters; here the blocks sit in an ``nn.ModuleList`` in the order the
reference runs them (``cfg.layer_kinds``) and run in a Python loop. The
cache holds one entry per layer: a ``(k, v, cache_pos)`` ring for an
attention layer (``local_attn`` layers take a ring of ``local_window +
headroom`` slots), a ``{"h", "conv"}`` dict for an RG-LRU layer (the
reference keeps the same entries, stacked per scan stage).

Two forward shapes:
  * ``prefill`` — full-sequence compute over left-padded prompts, then
    the computed K/V are scattered into a fresh ring cache and the
    recurrent layers' final states copied into it;
  * ``forward`` with a cache — the verify path: a (K+1)-token block is
    appended at per-row offsets, the attention caches commit by ring-slot
    overwrite (in place). With ``collect_states`` the recurrent layers
    return staged per-step states, which ``commit_staged_cache`` gathers
    at the acceptance count into the cache, in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


ATTENTION = ("attn", "local_attn")
RECURRENT = ("rglru",)


def check_supported(cfg: ModelConfig) -> None:
    """The port serves decoders of attention and RG-LRU blocks, each with
    a pre-norm MLP (so far)."""
    if (
        not set(cfg.block_pattern) <= set(ATTENTION + RECURRENT)
        or cfg.num_experts > 0 or cfg.is_encoder_decoder
        or cfg.parallel_block or cfg.rope == "mrope" or cfg.d_ff <= 0
    ):
        raise NotImplementedError(
            f"{cfg.name}: only decoders of attention and RG-LRU blocks "
            "with a pre-norm MLP are ported so far"
        )


def has_recurrent(cfg: ModelConfig) -> bool:
    return any(k in RECURRENT for k in cfg.layer_kinds)


class Block(nn.Module):
    """Pre-norm mixer (``attn`` for attention kinds, ``rglru`` for the
    recurrent one) + pre-norm MLP. Parameters are nested
    ``ParameterDict``s in the reference's layouts and names."""

    def __init__(self, kind: str, norm: nn.ParameterDict,
                 mixer: nn.ParameterDict, mlp_norm: nn.ParameterDict,
                 mlp: nn.ParameterDict) -> None:
        super().__init__()
        self.kind = kind
        self.norm = norm
        setattr(self, "rglru" if kind in RECURRENT else "attn", mixer)
        self.mlp_norm = mlp_norm
        self.mlp = mlp


class Transformer(nn.Module):
    """Parameter container of one decoder; ``forward`` /
    ``prefill`` below are the functions that run it."""

    def __init__(self, cfg: ModelConfig, embed: torch.Tensor,
                 final_norm: nn.ParameterDict,
                 lm_head: Optional[torch.Tensor], blocks: List[Block]) -> None:
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.embed = L._param(embed)
        self.final_norm = final_norm
        self.lm_head = None if lm_head is None else L._param(lm_head)
        self.layers = nn.ModuleList(blocks)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Transformer:
    """Random weights drawn from ``seed`` straight on ``device`` in
    ``cfg.dtype`` (the full-width model never exists on the host)."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    dt = L.torch_dtype(cfg.dtype)
    embed = L._dense_init((cfg.padded_vocab, cfg.d_model), dt, gen, dev,
                          scale=0.02)
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = L._dense_init((cfg.d_model, cfg.padded_vocab), dt, gen, dev)
    blocks = [
        Block(kind, L.init_norm(cfg, dev),
              (L.init_rglru if kind in RECURRENT else L.init_attention)(
                  cfg, gen, dev),
              L.init_norm(cfg, dev), L.init_mlp(cfg, gen, dev))
        for kind in cfg.layer_kinds
    ]
    return Transformer(cfg, embed, L.init_norm(cfg, dev), lm_head, blocks)


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

LayerCache = Union[Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                   Dict[str, torch.Tensor]]


@dataclass
class Cache:
    layers: List[LayerCache]  # (k, v, cache_pos) or {"h", "conv"}
    lengths: torch.Tensor  # (B,) int32 committed tokens per row


def _layer_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                 headroom: int, dev) -> LayerCache:
    if kind in RECURRENT:
        W = cfg.rnn_width
        return {
            "h": torch.zeros((batch, W), dtype=torch.float32, device=dev),
            "conv": torch.zeros((batch, cfg.conv_width - 1, W),
                                dtype=L.torch_dtype(cfg.dtype), device=dev),
        }
    window = cfg.local_window if kind == "local_attn" else cfg.sliding_window
    return L.init_kv_cache(cfg, batch, max_len, window, headroom, device=dev)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               headroom: int = 64, device=None) -> Cache:
    dev = resolve_device(device)
    layers = [_layer_cache(cfg, kind, batch, max_len, headroom, dev)
              for kind in cfg.layer_kinds]
    return Cache(layers, torch.zeros(batch, dtype=torch.int32, device=dev))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _run_block(blk: Block, x, cfg: ModelConfig, *, positions, cache, valid,
               collect: bool):
    h = L.apply_norm(blk.norm, x, cfg)
    if blk.kind in RECURRENT:
        y, h_fin, conv = L.apply_rglru(
            blk.rglru, h, cfg, None if cache is None else cache["h"],
            None if cache is None else cache["conv"], update_mask=valid,
            collect=collect,
        )
        if cache is None or collect:
            new = {"h": h_fin, "conv": conv}
        else:  # commit every updated step, in place
            cache["h"].copy_(h_fin)
            cache["conv"].copy_(conv)
            new = cache
    else:
        window = (cfg.local_window if blk.kind == "local_attn"
                  else cfg.sliding_window)
        y, new = L.attention_forward(
            blk.attn, h, cfg, positions=positions, window=window,
            kv_cache=cache, valid=valid,
        )
    x = x + y
    hm = L.apply_norm(blk.mlp_norm, x, cfg)
    return x + L.apply_mlp(blk.mlp, hm, cfg), new


def _block_hidden(blk: Block, x, cfg: ModelConfig, positions, valid):
    return _run_block(blk, x, cfg, positions=positions, cache=None,
                      valid=valid, collect=False)[0]


def head(params: Transformer, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Final-norm hidden states (B,T,D) → float32 logits (B,T,V_padded)."""
    if cfg.tie_embeddings:
        return torch.einsum("btd,vd->btv", x, params.embed).float()
    return torch.einsum("btd,dv->btv", x, params.lm_head).float()


def forward(
    params: Transformer,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # (B, T) int
    *,
    cache: Optional[Cache] = None,
    positions: Optional[torch.Tensor] = None,  # (B, T) int32
    valid: Optional[torch.Tensor] = None,  # (B, T) bool
    return_hidden: bool = False,
    collect_states: bool = False,
    remat: bool = False,
):
    """Returns (logits (B,T,V_padded) f32, cache | per-layer entries:
    (k, v, pos) for attention, {"h", "conv"} final states for RG-LRU).

    With a cache the layer caches are written in place and a ``Cache`` of
    the same tensors (lengths untouched) comes back. With
    ``collect_states`` as well, the recurrent layers' cache tensors are
    left as they were and the returned ``Cache`` holds their staged
    per-step states instead (``apply_rglru(collect=True)``), for
    ``commit_staged_cache``. ``return_hidden`` returns the final-norm
    hidden states instead of logits (callers then use
    ``rl.grpo.chunked_token_logprobs``, so the (B, T, V) float32 logits
    never exist). ``remat`` checkpoints each block for the backward
    (``torch.utils.checkpoint``, non-reentrant: activation recompute, the
    reference's ``jax.checkpoint`` on the layer scan); a block run so
    returns no cache entry (None)."""
    if remat and cache is not None:
        raise ValueError("remat is for full-sequence (training) forwards")
    # F.embedding, not indexing: its backward on CUDA sums the rows of a
    # repeated token in a fixed order (indexing's accumulates by atomics),
    # so a training step is bit-reproducible
    x = F.embedding(tokens, params.embed).to(L.torch_dtype(cfg.dtype))
    B, T = tokens.shape
    if positions is None:
        ar = torch.arange(T, dtype=torch.int32, device=x.device)[None]
        positions = (cache.lengths[:, None] + ar if cache is not None
                     else ar.expand(B, T))
    kv_out = []
    for li, blk in enumerate(params.layers):
        if remat:
            x = checkpoint(_block_hidden, blk, x, cfg, positions, valid,
                           use_reentrant=False)
            kv_out.append(None)
            continue
        c = cache.layers[li] if cache is not None else None
        x, kv = _run_block(blk, x, cfg, positions=positions, cache=c,
                           valid=valid, collect=collect_states)
        kv_out.append(kv)
    x = L.apply_norm(params.final_norm, x, cfg)
    out = x if return_hidden else head(params, cfg, x)
    if cache is not None:
        return out, Cache(kv_out, cache.lengths)
    return out, kv_out


def prefill(params: Transformer, cfg: ModelConfig, tokens, pad_mask,
            max_len: int, *, headroom: int = 64):
    """Left-padded prompt prefill. tokens (B, Tp), pad_mask (B, Tp) bool
    (False = left pad). Returns (last_logits (B, V), cache) with
    ``cache.lengths`` = per-row prompt lengths. Only the last column's
    logits are computed (rows are right-aligned)."""
    B, Tp = tokens.shape
    dev = tokens.device
    plen = pad_mask.sum(-1).to(torch.int32)
    positions = torch.cumsum(pad_mask.to(torch.int32), dim=-1) - 1
    positions = torch.where(pad_mask, positions, -1).to(torch.int32)
    hidden, kv = forward(params, cfg, tokens, positions=positions,
                         valid=pad_mask, return_hidden=True)
    last_logits = head(params, cfg, hidden[:, -1:])[:, 0]
    cache = init_cache(cfg, B, max_len, headroom, device=dev)
    bidx = torch.arange(B, device=dev)[:, None]
    for c, out in zip(cache.layers, kv):
        if isinstance(c, dict):  # recurrent: forward gave the final state
            for key in c:
                c[key].copy_(out[key])
            continue
        (ck, cv, cpos), (k, v, _pos) = c, out
        S = ck.shape[1] - 1
        n_keep = min(Tp, S)
        psl = positions[:, Tp - n_keep:]
        msl = pad_mask[:, Tp - n_keep:]
        slots = torch.where(msl, psl % S, S)
        ck[bidx, slots] = k[:, Tp - n_keep:].to(ck.dtype)
        cv[bidx, slots] = v[:, Tp - n_keep:].to(cv.dtype)
        cpos[bidx, slots] = torch.where(msl, psl, -1).to(torch.int32)
    return last_logits, Cache(cache.layers, plen)


def copy_cache_rows(cfg: ModelConfig, dst: Cache, src: Cache, slots) -> Cache:
    """Write batch rows ``0..k-1`` of ``src`` into rows ``slots`` of
    ``dst``, in place — the slot-recycling admission primitive: finished
    rows' slots in the continuous-batching pool take the freshly
    (batch-)prefilled caches of the next pending requests, one indexed
    write per cache tensor for the whole admission chunk. Both caches
    share one geometry (``max_len``/``headroom``).

    ``slots`` is a host (k,) index array. Entries ``>= n_slots`` (the
    reference's padding) are dropped, as XLA's scatter drops them: the
    rows they would write are left out here, never clamped onto the last
    slot."""
    slots = np.asarray(slots, np.int64)
    keep = np.nonzero(slots < dst.lengths.shape[0])[0]
    dev = dst.lengths.device
    rows = torch.as_tensor(keep, device=dev)
    idx = torch.as_tensor(slots[keep], device=dev)
    for dl, sl in zip(dst.layers, src.layers):
        pairs = ([(dl[k], sl[k]) for k in dl] if isinstance(dl, dict)
                 else zip(dl, sl))
        for d, s in pairs:
            d[idx] = s[rows].to(d.dtype)
    dst.lengths[idx] = src.lengths[rows]
    return dst


def commit_staged_cache(cfg: ModelConfig, cache: Cache, staged: Cache,
                        n_commit: torch.Tensor) -> Cache:
    """Gather the staged recurrent states at the acceptance count, into
    ``cache`` in place.

    ``staged`` came from ``forward(cache=cache, collect_states=True)``:
    its recurrent entries carry an extra per-step axis (B, T+1, ...),
    index t = the state after t committed tokens. ``n_commit`` (B,)
    selects per row (0 for frozen rows: the state before the block).
    Attention entries were committed by the ring-slot overwrite already.
    The reference returns a new cache; the port writes the gathered
    states into the tensors of ``cache``, the cache the next round
    reads."""
    rows = torch.arange(n_commit.shape[0], device=n_commit.device)
    idx = n_commit.long()
    for kind, c, st in zip(cfg.layer_kinds, cache.layers, staged.layers):
        if kind in RECURRENT:
            for key in c:
                c[key].copy_(st[key][rows, idx])
    return cache


def param_count(params: Transformer) -> int:
    return sum(p.numel() for p in params.parameters())


def set_trainable(params: Transformer) -> Transformer:
    """Mark every parameter as one autograd differentiates, in place.
    Parameters are created frozen (the engine only reads them); the
    learner (``rl.grpo``) needs them trainable. Never call this, nor
    create parameters, under ``torch.inference_mode()``: inference tensors
    cannot be saved for a backward."""
    for p in params.parameters():
        p.requires_grad_(True)
    return params

