"""Model assembly of the port: embedding → decoder blocks → head
(PyTorch counterpart of ``repro.models.model``, dense decoders only).

The reference groups layers into ``lax.scan`` stages over stacked
parameters; here the blocks sit in an ``nn.ModuleList`` and run in a
Python loop. The KV cache is one ``(k, v, cache_pos)`` triple per layer
(the reference keeps the same triples, stacked per scan stage).

Two forward shapes:
  * ``prefill`` — full-sequence compute over left-padded prompts, then
    the computed K/V are scattered into a fresh ring cache;
  * ``forward`` with a cache — the verify path: a (K+1)-token block is
    appended at per-row offsets, the attention caches commit by ring-slot
    overwrite (in place).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def check_supported(cfg: ModelConfig) -> None:
    """The port serves dense attention decoders only (so far)."""
    if (
        cfg.block_pattern != ("attn",) or cfg.num_experts > 0
        or cfg.is_encoder_decoder or cfg.parallel_block
        or cfg.rope == "mrope" or cfg.d_ff <= 0
    ):
        raise NotImplementedError(
            f"{cfg.name}: only dense attention decoders are ported so far"
        )


class Block(nn.Module):
    """Pre-norm attention + pre-norm MLP. Parameters are nested
    ``ParameterDict``s in the reference's layouts and names."""

    def __init__(self, norm: nn.ParameterDict, attn: nn.ParameterDict,
                 mlp_norm: nn.ParameterDict, mlp: nn.ParameterDict) -> None:
        super().__init__()
        self.norm = norm
        self.attn = attn
        self.mlp_norm = mlp_norm
        self.mlp = mlp


class Transformer(nn.Module):
    """Parameter container of one dense decoder; ``forward`` /
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
        Block(L.init_norm(cfg, dev), L.init_attention(cfg, gen, dev),
              L.init_norm(cfg, dev), L.init_mlp(cfg, gen, dev))
        for _ in range(cfg.num_layers)
    ]
    return Transformer(cfg, embed, L.init_norm(cfg, dev), lm_head, blocks)


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

@dataclass
class Cache:
    layers: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    lengths: torch.Tensor  # (B,) int32 committed tokens per row


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               headroom: int = 64, device=None) -> Cache:
    dev = resolve_device(device)
    layers = [
        L.init_kv_cache(cfg, batch, max_len, cfg.sliding_window, headroom,
                        device=dev)
        for _ in range(cfg.num_layers)
    ]
    return Cache(layers, torch.zeros(batch, dtype=torch.int32, device=dev))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _run_block(blk: Block, x, cfg: ModelConfig, *, positions, cache, valid):
    h = L.apply_norm(blk.norm, x, cfg)
    y, kv = L.attention_forward(
        blk.attn, h, cfg, positions=positions, window=cfg.sliding_window,
        kv_cache=cache, valid=valid,
    )
    x = x + y
    hm = L.apply_norm(blk.mlp_norm, x, cfg)
    return x + L.apply_mlp(blk.mlp, hm, cfg), kv


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
):
    """Returns (logits (B,T,V_padded) f32, cache | per-layer (k, v, pos)).

    With a cache the layer caches are written in place and the same
    ``Cache`` (lengths untouched) comes back. ``return_hidden`` returns
    the final-norm hidden states instead of logits."""
    x = params.embed[tokens].to(L.torch_dtype(cfg.dtype))
    B, T = tokens.shape
    if positions is None:
        ar = torch.arange(T, dtype=torch.int32, device=x.device)[None]
        positions = (cache.lengths[:, None] + ar if cache is not None
                     else ar.expand(B, T))
    kv_out = []
    for li, blk in enumerate(params.layers):
        c = cache.layers[li] if cache is not None else None
        x, kv = _run_block(blk, x, cfg, positions=positions, cache=c,
                           valid=valid)
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
    for (ck, cv, cpos), (k, v, _pos) in zip(cache.layers, kv):
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
        for d, s in zip(dl, sl):
            d[idx] = s[rows].to(d.dtype)
    dst.lengths[idx] = src.lengths[rows]
    return dst


def param_count(params: Transformer) -> int:
    return sum(p.numel() for p in params.parameters())
