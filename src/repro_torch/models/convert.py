"""Weight bridge: the reference's parameter tree (as numpy arrays) → the
port's ``Transformer`` (``params_from_numpy``), and back
(``params_to_numpy``).

The input is ``split_tree(init_params(cfg, key))[0]`` of the JAX package
after ``np.asarray`` on every leaf: ``{"embed", "final_norm",
["lm_head"], "stages"}``, where a scanned stage holds each leaf stacked
along a leading layer axis. The stages (a scanned stage of whole
block-pattern units, then one un-scanned stage per remainder layer, as
``cfg.scan_stages`` lays them out) are unstacked into per-layer tensors
in the order the reference's forward runs them. A block's groups are
those ``models.model.block_parts`` names: an attention block's mixer is
its ``attn`` subtree, an RG-LRU block's ``rglru`` (``wx``, ``wy``,
``wo``, ``conv``, ``w_a``, ``w_i``, ``lam``), an mLSTM block's ``mlstm``
(``wq wk wv wi wf bf wo_gate wo``), an sLSTM block's ``slstm`` (``wz wi
wf wo_g r bf wo``); an encoder-decoder's attention block adds
``cross_norm`` and ``cross``, a parallel block has no ``mlp_norm``, an
xLSTM block no MLP, and an MoE block's ``moe`` nests Arctic's ``dense``
MLP. An encoder-decoder's ``encoder`` holds ``blocks`` (``norm``,
``attn``, ``mlp_norm``, ``mlp``), each leaf stacked along a leading axis
of ``num_encoder_layers``, and ``final_norm``.

bfloat16 leaves arrive as ``ml_dtypes.bfloat16`` arrays, which
``torch.from_numpy`` refuses; they cross as their raw 16-bit patterns
(a ``uint16`` view reinterpreted as ``torch.bfloat16``), which is exact —
no float32 round trip. The way back has no bfloat16 numpy type to give
(the port does not depend on ``ml_dtypes``): ``tensor_to_numpy`` hands
bfloat16 tensors out as ``uint16`` patterns, ``params_to_numpy`` as
float32 (exact).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.model import (
    ENC_PARTS,
    Block,
    Transformer,
    block_parts,
    check_supported,
    params_tree,
)


def tensor_from_numpy(arr, device) -> torch.Tensor:
    a = np.array(arr, copy=True, order="C")  # JAX hands out read-only views
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _pdict(d: Dict[str, Any], device, idx=None) -> nn.ParameterDict:
    """A parameter group; a nested mapping (MoE's ``dense``) nests."""
    return nn.ParameterDict({
        k: (_pdict(v, device, idx) if isinstance(v, dict)
            else L._param(tensor_from_numpy(v if idx is None else v[idx],
                                            device)))
        for k, v in d.items()
    })


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device=None) -> Transformer:
    check_supported(cfg)
    dev = resolve_device(device)
    blocks: List[Block] = []
    for si, (unit, repeats) in enumerate(cfg.scan_stages):
        stage = tree["stages"][si]
        for r in range(repeats):
            idx = r if repeats > 1 else None
            for ui, kind in enumerate(unit):
                blocks.append(Block(kind, **{
                    name: _pdict(stage[ui][name], dev, idx)
                    for name in block_parts(cfg, kind)}))
    lm_head = tree.get("lm_head")
    enc = tree.get("encoder")
    encoder = [] if enc is None else [
        Block("enc", **{name: _pdict(enc["blocks"][name], dev, r)
                        for name in ENC_PARTS})
        for r in range(cfg.num_encoder_layers)]
    return Transformer(
        cfg,
        tensor_from_numpy(tree["embed"], dev),
        _pdict(tree["final_norm"], dev),
        None if lm_head is None else tensor_from_numpy(lm_head, dev),
        blocks,
        encoder,
        None if enc is None else _pdict(enc["final_norm"], dev),
    )


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array; bfloat16 as its ``uint16`` bit
    patterns (exact), the inverse of ``tensor_from_numpy``'s crossing."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def params_to_numpy(params: Transformer, cfg: ModelConfig) -> Dict[str, Any]:
    """The inverse of ``params_from_numpy``: the reference's value tree
    ``{"embed", "final_norm", ["lm_head"], "stages", ["encoder"]}`` with
    each scanned stage's leaves, and the encoder's blocks, stacked along
    a leading layer axis, as float32 numpy arrays (bfloat16 widens
    exactly)."""
    return params_tree(params, cfg,
                       lambda t, ax: t.detach().float().cpu().numpy(),
                       np.stack)
