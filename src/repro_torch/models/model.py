"""Model assembly of the port: embedding → decoder blocks → head
(PyTorch counterpart of ``repro.models.model``): dense attention
decoders (pre-norm, or parallel blocks as in Command R+), M-RoPE over
stub embeddings (Qwen2-VL), capacity-dispatched MoE (Mixtral, Arctic),
the hybrid RG-LRU + local-attention stack (RecurrentGemma), the
attention-free xLSTM stack (mLSTM and sLSTM blocks, no MLP) and the
encoder-decoder (SeamlessM4T: a bidirectional encoder over stub frame
embeddings, ``encode``, and decoder blocks with cross-attention over its
output, whose K/V ``build_cross_cache`` projects once per request).

The reference groups layers into ``lax.scan`` stages over stacked
parameters; here the blocks sit in an ``nn.ModuleList`` in the order the
reference runs them (``cfg.layer_kinds``) and run in a Python loop. The
cache holds one entry per layer: a ``(k, v, cache_pos)`` ring for an
attention layer (``local_attn`` layers take a ring of ``local_window +
headroom`` slots), a ``{"h", "conv"}`` dict for an RG-LRU layer, a
``{"C", "n", "m"}`` dict for an mLSTM layer and a ``{"c", "n", "h",
"m"}`` dict for an sLSTM layer (the reference keeps the same entries,
tuples for xLSTM, stacked per scan stage). The encoder's blocks sit in
``Transformer.encoder``.

Two forward shapes:
  * ``prefill`` — full-sequence compute over left-padded prompts, then
    the computed K/V are scattered into a fresh ring cache and the
    recurrent layers' final states copied into it;
  * ``forward`` with a cache — the verify path: a (K+1)-token block is
    appended at per-row offsets, the attention caches commit by ring-slot
    overwrite (in place). With ``collect_states`` the recurrent layers
    return staged per-step states, which ``commit_staged_cache`` gathers
    at the acceptance count into the cache, in place; without it they
    commit in place every updated step, or with ``commit_upto`` the
    reference's committed carry.
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
RECURRENT = ("rglru", "mlstm", "slstm")
ENC_PARTS = ("norm", "attn", "mlp_norm", "mlp")  # an encoder block


def check_supported(cfg: ModelConfig) -> None:
    """Every block kind of the reference is ported; a config naming
    another is refused."""
    unknown = set(cfg.block_pattern) - set(ATTENTION + RECURRENT)
    if unknown:
        raise NotImplementedError(
            f"{cfg.name}: unknown block kinds {sorted(unknown)}")


def has_recurrent(cfg: ModelConfig) -> bool:
    return any(k in RECURRENT for k in cfg.layer_kinds)


def block_parts(cfg: ModelConfig, kind: str) -> Tuple[str, ...]:
    """A block's parameter groups, as the reference's ``_init_block``
    lays them out: ``norm`` and the mixer (``attn``, or the recurrent
    kind's own name), ``cross_norm`` + ``cross`` after an attention
    mixer of an encoder-decoder, then ``mlp_norm`` + ``moe`` on an
    attention kind of an MoE config, ``mlp`` alone for a parallel block
    (it shares ``norm``), ``mlp_norm`` + ``mlp`` otherwise, and nothing
    when ``d_ff == 0`` (xLSTM)."""
    parts = ("norm", kind if kind in RECURRENT else "attn")
    if cfg.is_encoder_decoder and kind in ATTENTION:
        parts += ("cross_norm", "cross")
    if cfg.num_experts > 0 and kind in ATTENTION:
        return parts + ("mlp_norm", "moe")
    if cfg.d_ff <= 0:
        return parts
    if cfg.parallel_block:
        return parts + ("mlp",)
    return parts + ("mlp_norm", "mlp")


class Block(nn.Module):
    """Pre-norm mixer (``attn`` for attention kinds, ``rglru``, ``mlstm``
    or ``slstm`` for the recurrent ones), an encoder-decoder's
    cross-attention, and an MLP or MoE (``block_parts``; an encoder
    block, kind ``"enc"``, has ``ENC_PARTS``). Parameters are nested
    ``ParameterDict``s in the reference's layouts and names, one
    attribute a group; ``parts`` names them in order."""

    def __init__(self, kind: str, **parts: nn.ParameterDict) -> None:
        super().__init__()
        self.kind = kind
        self.parts = tuple(parts)
        for name, p in parts.items():
            setattr(self, name, p)


class Transformer(nn.Module):
    """Parameter container of one decoder (with an encoder-decoder's
    encoder blocks and their final norm); ``forward`` / ``prefill`` /
    ``encode`` below are the functions that run it."""

    def __init__(self, cfg: ModelConfig, embed: torch.Tensor,
                 final_norm: nn.ParameterDict,
                 lm_head: Optional[torch.Tensor], blocks: List[Block],
                 encoder: Optional[List[Block]] = None,
                 encoder_final_norm: Optional[nn.ParameterDict] = None
                 ) -> None:
        super().__init__()
        check_supported(cfg)
        if cfg.is_encoder_decoder != (encoder_final_norm is not None):
            raise ValueError("an encoder-decoder needs its encoder, and "
                             "only it has one")
        self.cfg = cfg
        self.embed = L._param(embed)
        self.final_norm = final_norm
        self.lm_head = None if lm_head is None else L._param(lm_head)
        self.layers = nn.ModuleList(blocks)
        self.encoder = nn.ModuleList(encoder or [])
        self.encoder_final_norm = encoder_final_norm

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Transformer:
    """Random weights drawn from ``seed`` straight on ``device`` in
    ``cfg.dtype`` (the full-width model never exists on the host). On the
    meta device (``device="meta"``, the dry run) nothing is drawn and
    nothing allocated: every parameter has its shape and dtype only."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(int(seed)))
    dt = L.torch_dtype(cfg.dtype)
    embed = L._dense_init((cfg.padded_vocab, cfg.d_model), dt, gen, dev,
                          scale=0.02)
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = L._dense_init((cfg.d_model, cfg.padded_vocab), dt, gen, dev)
    init = {"attn": L.init_attention, "rglru": L.init_rglru,
            "mlstm": L.init_mlstm, "slstm": L.init_slstm,
            "mlp": L.init_mlp, "moe": L.init_moe,
            "cross": lambda c, g, d: L.init_attention(c, g, d, cross=True)}

    def block(kind, parts):
        return Block(kind, **{
            name: (L.init_norm(cfg, dev) if name.endswith("norm")
                   else init[name](cfg, gen, dev)) for name in parts})

    blocks = [block(kind, block_parts(cfg, kind))
              for kind in cfg.layer_kinds]
    encoder = [block("enc", ENC_PARTS)
               for _ in range(cfg.num_encoder_layers
                              if cfg.is_encoder_decoder else 0)]
    return Transformer(cfg, embed, L.init_norm(cfg, dev), lm_head, blocks,
                       encoder, L.init_norm(cfg, dev)
                       if cfg.is_encoder_decoder else None)


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

LayerCache = Union[Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                   Dict[str, torch.Tensor]]


@dataclass
class Cache:
    # (k, v, cache_pos), or a recurrent kind's state dict
    layers: List[LayerCache]
    lengths: torch.Tensor  # (B,) int32 committed tokens per row


def _layer_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                 headroom: int, dev, slot_multiple: int = 1) -> LayerCache:
    W = cfg.rnn_width
    H = max(cfg.num_heads, 1)
    f32 = dict(dtype=torch.float32, device=dev)
    if kind == "rglru":
        return {
            "h": torch.zeros((batch, W), **f32),
            "conv": torch.zeros((batch, cfg.conv_width - 1, W),
                                dtype=L.torch_dtype(cfg.dtype), device=dev),
        }
    if kind == "mlstm":
        return {"C": torch.zeros((batch, H, W // H, W // H), **f32),
                "n": torch.zeros((batch, H, W // H), **f32),
                "m": torch.full((batch, H), -float("inf"), **f32)}
    if kind == "slstm":
        return {"c": torch.zeros((batch, W), **f32),
                "n": torch.zeros((batch, W), **f32),
                "h": torch.zeros((batch, W), **f32),
                "m": torch.full((batch, W), -float("inf"), **f32)}
    window = cfg.local_window if kind == "local_attn" else cfg.sliding_window
    return L.init_kv_cache(cfg, batch, max_len, window, headroom, device=dev,
                           slot_multiple=slot_multiple)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               headroom: int = 64, device=None,
               slot_multiple: int = 1) -> Cache:
    """A fresh cache; ``slot_multiple`` rounds each attention ring's slot
    count up (``L.init_kv_cache``). On the meta device it allocates
    nothing."""
    dev = resolve_device(device)
    layers = [_layer_cache(cfg, kind, batch, max_len, headroom, dev,
                           slot_multiple)
              for kind in cfg.layer_kinds]
    return Cache(layers, torch.zeros(batch, dtype=torch.int32, device=dev))


# ---------------------------------------------------------------------------
# abstract shapes and logical axes (the dry run's counterpart of the
# reference's ``Param`` trees)
# ---------------------------------------------------------------------------

_NORM_AXES = {"scale": (None,), "bias": (None,)}
_MLP_AXES = {"wi": ("embed", "mlp"), "wg": ("embed", "mlp"),
             "wo": ("mlp", "embed")}
# each parameter group's leaves and their logical axes, as the reference's
# ``init_*`` functions give them (``repro.models.layers``); a cross
# attention takes the attention's, every ``*norm`` group the norm's
PARAM_AXES = {
    "attn": {"wq": ("embed", "heads", "head_dim"),
             "wk": ("embed", "kv_heads", "head_dim"),
             "wv": ("embed", "kv_heads", "head_dim"),
             "wo": ("heads", "head_dim", "embed"),
             "bq": ("heads", "head_dim"),
             "bk": ("kv_heads", "head_dim"),
             "bv": ("kv_heads", "head_dim")},
    "mlp": _MLP_AXES,
    "moe": {"router": ("embed", None),
            "wi": ("experts", "embed", "mlp"),
            "wg": ("experts", "embed", "mlp"),
            "wo": ("experts", "mlp", "embed"),
            "dense": _MLP_AXES},
    "rglru": {"wx": ("embed", "mlp"), "wy": ("embed", "mlp"),
              "wo": ("mlp", "embed"), "conv": (None, "mlp"),
              "w_a": ("mlp",), "w_i": ("mlp",), "lam": ("mlp",)},
    "mlstm": {"wq": ("embed", "mlp"), "wk": ("embed", "mlp"),
              "wv": ("embed", "mlp"), "wi": ("embed", None),
              "wf": ("embed", None), "bf": (None,),
              "wo_gate": ("embed", "mlp"), "wo": ("mlp", "embed")},
    "slstm": {"wz": ("embed", "mlp"), "wi": ("embed", "mlp"),
              "wf": ("embed", "mlp"), "wo_g": ("embed", "mlp"),
              "r": (None, None, None), "bf": ("mlp",),
              "wo": ("mlp", "embed")},
}


def _group_axes(group: str):
    if group.endswith("norm"):
        return _NORM_AXES
    return PARAM_AXES["attn" if group == "cross" else group]


def params_tree(params: Transformer, cfg: ModelConfig, leaf, stack):
    """The reference's parameter tree ``{"embed", "final_norm",
    ["lm_head"], "stages", ["encoder"]}`` over the port's parameters:
    ``leaf(tensor, logical axes)`` gives each leaf, ``stack(list)`` joins
    the per-layer leaves of a scanned stage (``cfg.scan_stages``) and of
    the encoder's blocks along a leading layer axis.
    ``convert.params_to_numpy``, ``param_shapes`` and
    ``param_logical_axes`` are its three readings."""
    def group(d, axes):
        return {k: (group(v, axes[k]) if isinstance(v, nn.ParameterDict)
                    else leaf(v, axes[k])) for k, v in d.items()}

    def block(blk):
        return {name: group(getattr(blk, name), _group_axes(name))
                for name in blk.parts}

    def stacked(parts):
        if isinstance(parts[0], dict):
            return {k: stacked([p[k] for p in parts]) for k in parts[0]}
        return stack(parts)

    layers = iter(params.layers)
    stages = []
    for unit, repeats in cfg.scan_stages:
        reps = [tuple(block(next(layers)) for _ in unit)
                for _ in range(repeats)]
        stages.append(tuple(stacked([r[ui] for r in reps])
                            for ui in range(len(unit)))
                      if repeats > 1 else reps[0])
    tree = {"embed": leaf(params.embed, ("vocab", "embed")),
            "final_norm": group(params.final_norm, _NORM_AXES),
            "stages": stages}
    if params.lm_head is not None:
        tree["lm_head"] = leaf(params.lm_head, ("embed", "vocab"))
    if params.encoder_final_norm is not None:
        tree["encoder"] = {
            "blocks": stacked([block(blk) for blk in params.encoder]),
            "final_norm": group(params.encoder_final_norm, _NORM_AXES)}
    return tree


def param_shapes(cfg: ModelConfig):
    """The parameter tree (``params_tree``) as meta tensors of each
    leaf's shape and dtype: nothing drawn, nothing allocated."""
    return params_tree(init_params(cfg, device="meta"), cfg,
                       lambda t, ax: t.detach(), torch.stack)


def param_logical_axes(cfg: ModelConfig):
    """The logical axes of each leaf of ``param_shapes``' tree; a stacked
    leaf's axes start with ``"layers"``, as the reference's
    ``stack_params`` gives them. With ``param_shapes`` the counterpart of
    the reference's ``split_tree(param_shapes(cfg))``."""
    return params_tree(init_params(cfg, device="meta"), cfg,
                       lambda t, ax: ax, lambda parts: ("layers",) + parts[0])


def _layer_cache_axes(cfg: ModelConfig, kind: str, mesh_model: int):
    """Logical axes of one layer's cache entry (``_layer_cache``'s
    layout). An attention ring shards its kv heads over the model axis
    where they divide it, else its slots (context-parallel decode)."""
    if kind in ATTENTION:
        if mesh_model > 0 and cfg.num_kv_heads % mesh_model == 0:
            kv = ("batch", None, "kv_heads", "head_dim")
            cp = ("batch", None)
        else:
            kv = ("batch", "kv_seq", "kv_heads", "head_dim")
            cp = ("batch", "kv_seq")
        return (kv, kv, cp)
    if kind == "rglru":
        return {"h": ("batch", "mlp"), "conv": ("batch", None, "mlp")}
    if kind == "mlstm":
        return {"C": ("batch", "heads", None, None),
                "n": ("batch", "heads", None), "m": ("batch", "heads")}
    return {k: ("batch", "mlp") for k in ("c", "n", "h", "m")}


def cache_logical_axes(cfg: ModelConfig, mesh_model: int = 16) -> Cache:
    """Axes of ``init_cache``'s Cache, one entry a layer (the reference's
    stacked leading ``"layers"`` axis has no counterpart: the port's
    cache is per layer, and the rules replicate that axis anyway)."""
    return Cache([_layer_cache_axes(cfg, kind, mesh_model)
                  for kind in cfg.layer_kinds], ("batch",))


def cross_cache_logical_axes(cfg: ModelConfig) -> List[Optional[Tuple]]:
    """Axes of ``build_cross_cache``'s output: ``(ck, cv)`` axes for a
    layer with cross-attention, None for one without."""
    ax = ("batch", None, "kv_heads", "head_dim")
    return [(ax, ax) if cfg.is_encoder_decoder and kind in ATTENTION
            else None for kind in cfg.layer_kinds]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _run_block(blk: Block, x, cfg: ModelConfig, *, positions, cache, valid,
               collect: bool, commit_upto=None, mrope_positions=None,
               enc_out=None, enc_mask=None, cross_kv=None):
    """Returns (x, cache entry, MoE aux loss or None). A recurrent layer
    run on a cache without ``collect`` commits in place: every updated
    step, or the committed carry when ``commit_upto`` is given."""
    h = L.apply_norm(blk.norm, x, cfg)
    if blk.kind in RECURRENT:
        if blk.kind == "rglru":
            y, h_fin, conv = L.apply_rglru(
                blk.rglru, h, cfg, None if cache is None else cache["h"],
                None if cache is None else cache["conv"], update_mask=valid,
                commit_upto=commit_upto, collect=collect,
            )
            new = {"h": h_fin, "conv": conv}
        else:
            apply = L.apply_mlstm if blk.kind == "mlstm" else L.apply_slstm
            y, new = apply(getattr(blk, blk.kind), h, cfg, cache,
                           update_mask=valid, commit_upto=commit_upto,
                           collect=collect)
        if cache is not None and not collect:
            for key in cache:
                cache[key].copy_(new[key])
            new = cache
        x = x + y
    else:
        window = (cfg.local_window if blk.kind == "local_attn"
                  else cfg.sliding_window)
        y, new = L.attention_forward(
            blk.attn, h, cfg, positions=positions, window=window,
            kv_cache=cache, valid=valid, mrope_positions=mrope_positions,
        )
        x = x + y
        if cfg.is_encoder_decoder and (enc_out is not None
                                       or cross_kv is not None):
            if cross_kv is None:  # project the encoder output here
                cross_kv = project_cross_kv(blk, enc_out)
            yc, _ = L.attention_forward(
                blk.cross, L.apply_norm(blk.cross_norm, x, cfg), cfg,
                positions=positions, cross_kv=(*cross_kv, enc_mask))
            x = x + yc
    if "moe" in blk.parts:
        y, aux = L.apply_moe(blk.moe, L.apply_norm(blk.mlp_norm, x, cfg), cfg)
        return x + y, new, aux
    if "mlp" not in blk.parts:  # xLSTM: no MLP
        return x, new, None
    # a parallel block's MLP reads the pre-attention h (Command R+)
    hm = h if cfg.parallel_block else L.apply_norm(blk.mlp_norm, x, cfg)
    return x + L.apply_mlp(blk.mlp, hm, cfg), new, None


def _block_hidden(blk: Block, x, cfg: ModelConfig, positions, valid,
                  mrope_positions, enc_out, enc_mask):
    x, _, aux = _run_block(blk, x, cfg, positions=positions, cache=None,
                           valid=valid, collect=False,
                           mrope_positions=mrope_positions,
                           enc_out=enc_out, enc_mask=enc_mask)
    return x, aux


def project_cross_kv(blk: Block, enc_out: torch.Tensor):
    """A decoder block's cross-attention K/V (B, S, Hkv, hd) from the
    encoder output (B, S, d)."""
    return (torch.einsum("bsd,dhk->bshk", enc_out, blk.cross["wk"]),
            torch.einsum("bsd,dhk->bshk", enc_out, blk.cross["wv"]))


def build_cross_cache(params: Transformer, cfg: ModelConfig,
                      enc_out: torch.Tensor) -> List[Optional[Tuple]]:
    """Every decoder layer's cross-attention K/V from the encoder output,
    projected once per request (the reference's decode fast path, which
    saves 2·L·S_enc·d² flops a decode step). One ``(ck, cv)`` per layer,
    None for a layer with no cross-attention: the port's per-layer
    layout, where the reference returns per-stage tuples."""
    return [project_cross_kv(blk, enc_out) if "cross" in blk.parts else None
            for blk in params.layers]


def encode(params: Transformer, cfg: ModelConfig, enc_embeds: torch.Tensor,
           enc_mask: torch.Tensor) -> torch.Tensor:
    """The bidirectional encoder over stub front-end embeddings (B, S, d)
    (audio frames): each block's self-attention sees every valid frame
    (``enc_mask`` (B, S) bool), its output is zeroed at invalid frames,
    then the MLP; the final norm's output (B, S, d) in the model dtype
    feeds the decoder's cross-attention."""
    x = enc_embeds.to(L.torch_dtype(cfg.dtype))
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    for blk in params.encoder:
        y, _ = L.attention_forward(
            blk.attn, L.apply_norm(blk.norm, x, cfg), cfg,
            positions=positions, bidirectional=True, valid=enc_mask)
        x = x + torch.where(enc_mask[:, :, None], y, 0.0)
        x = x + L.apply_mlp(blk.mlp, L.apply_norm(blk.mlp_norm, x, cfg), cfg)
    return L.apply_norm(params.encoder_final_norm, x, cfg)


def head(params: Transformer, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Final-norm hidden states (B,T,D) → float32 logits (B,T,V_padded)."""
    if cfg.tie_embeddings:
        return torch.einsum("btd,vd->btv", x, params.embed).float()
    return torch.einsum("btd,dv->btv", x, params.lm_head).float()


def forward(
    params: Transformer,
    cfg: ModelConfig,
    tokens: Optional[torch.Tensor] = None,  # (B, T) int
    *,
    embeds: Optional[torch.Tensor] = None,  # (B, T, d) modality stub
    cache: Optional[Cache] = None,
    positions: Optional[torch.Tensor] = None,  # (B, T) int32
    valid: Optional[torch.Tensor] = None,  # (B, T) bool
    commit_upto: Optional[torch.Tensor] = None,  # (B,) acceptance prefix
    mrope_positions: Optional[torch.Tensor] = None,  # (3, B, T)
    enc_out: Optional[torch.Tensor] = None,  # (B, S, d) encoder output
    enc_mask: Optional[torch.Tensor] = None,  # (B, S) bool
    cross_cache: Optional[List] = None,  # build_cross_cache's output
    return_hidden: bool = False,
    collect_states: bool = False,
    remat: bool = False,
    return_aux: bool = False,
):
    """Returns (logits (B,T,V_padded) f32, cache | per-layer entries:
    (k, v, pos) for attention, a recurrent kind's final state dict),
    and with ``return_aux`` a third value, the MoE layers' summed
    load-balance loss (a float32 0-d tensor, 0 without MoE: the
    reference's third return value, which only the learner reads).

    ``embeds`` (the stub of a vision front end) replaces the token
    embedding lookup, and ``mrope_positions`` (3, B, T) gives M-RoPE its
    three position streams, as in the reference. An encoder-decoder's
    blocks attend over the encoder output through ``enc_out`` (projected
    in each layer) or ``cross_cache`` (projected once), keys masked by
    ``enc_mask``; with neither, the cross-attention is skipped, as in
    the reference.

    With a cache the layer caches are written in place and a ``Cache`` of
    the same tensors (lengths untouched) comes back. With
    ``collect_states`` as well, the recurrent layers' cache tensors are
    left as they were and the returned ``Cache`` holds their staged
    per-step states instead (``apply_rglru(collect=True)`` and its xLSTM
    twins), for ``commit_staged_cache``. Without ``collect_states`` the
    recurrent caches take, in place, the state after every updated step,
    or with ``commit_upto`` (B,) the committed carry: the state after the
    steps t < commit_upto (the reference's dual carry).
    ``return_hidden`` returns the final-norm
    hidden states instead of logits (callers then use
    ``rl.grpo.chunked_token_logprobs``, so the (B, T, V) float32 logits
    never exist). ``remat`` checkpoints each block for the backward
    (``torch.utils.checkpoint``, non-reentrant: activation recompute, the
    reference's ``jax.checkpoint`` on the layer scan); a block run so
    returns no cache entry (None)."""
    if remat and cache is not None:
        raise ValueError("remat is for full-sequence (training) forwards")
    dt = L.torch_dtype(cfg.dtype)
    if embeds is None:
        # F.embedding, not indexing: its backward on CUDA sums the rows of
        # a repeated token in a fixed order (indexing's accumulates by
        # atomics), so a training step is bit-reproducible
        x = F.embedding(tokens, params.embed).to(dt)
    else:
        x = embeds.to(dt)
    B, T = x.shape[:2]
    if positions is None:
        ar = torch.arange(T, dtype=torch.int32, device=x.device)[None]
        positions = (cache.lengths[:, None] + ar if cache is not None
                     else ar.expand(B, T))
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    kv_out = []
    for li, blk in enumerate(params.layers):
        if remat:
            x, aux = checkpoint(_block_hidden, blk, x, cfg, positions, valid,
                                mrope_positions, enc_out, enc_mask,
                                use_reentrant=False)
            kv = None
        else:
            c = cache.layers[li] if cache is not None else None
            x, kv, aux = _run_block(
                blk, x, cfg, positions=positions, cache=c, valid=valid,
                collect=collect_states, commit_upto=commit_upto,
                mrope_positions=mrope_positions, enc_out=enc_out,
                enc_mask=enc_mask,
                cross_kv=None if cross_cache is None else cross_cache[li])
        if aux is not None:
            aux_total = aux_total + aux
        kv_out.append(kv)
    x = L.apply_norm(params.final_norm, x, cfg)
    out = x if return_hidden else head(params, cfg, x)
    kv_ret = Cache(kv_out, cache.lengths) if cache is not None else kv_out
    return (out, kv_ret, aux_total) if return_aux else (out, kv_ret)


def prefill(params: Transformer, cfg: ModelConfig, tokens, pad_mask,
            max_len: int, *, embeds=None, headroom: int = 64,
            mrope_positions=None, enc_out=None, enc_mask=None):
    """Left-padded prompt prefill. tokens (B, Tp) or embeds (B, Tp, d),
    pad_mask (B, Tp) bool (False = left pad); an encoder-decoder's
    prompt attends over ``enc_out`` (B, S, d) with ``enc_mask``. Returns
    (last_logits (B, V), cache) with ``cache.lengths`` = per-row prompt
    lengths. Only the last column's logits are computed (rows are
    right-aligned)."""
    B, Tp = pad_mask.shape
    dev = pad_mask.device
    plen = pad_mask.sum(-1).to(torch.int32)
    positions = torch.cumsum(pad_mask.to(torch.int32), dim=-1) - 1
    positions = torch.where(pad_mask, positions, -1).to(torch.int32)
    hidden, kv = forward(params, cfg, tokens, embeds=embeds,
                         positions=positions, valid=pad_mask,
                         mrope_positions=mrope_positions, enc_out=enc_out,
                         enc_mask=enc_mask, return_hidden=True)
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

