"""Weight bridge: the reference's parameter tree (as numpy arrays) → the
port's ``Transformer``.

The input is ``split_tree(init_params(cfg, key))[0]`` of the JAX package
after ``np.asarray`` on every leaf: ``{"embed", "final_norm",
["lm_head"], "stages"}``, where a scanned stage holds each leaf stacked
along a leading layer axis. The stages (a scanned stage of whole
block-pattern units, then one un-scanned stage per remainder layer, as
``cfg.scan_stages`` lays them out) are unstacked into per-layer tensors
in the order the reference's forward runs them. An attention block's
mixer is its ``attn`` subtree; an RG-LRU block's is ``rglru`` (``wx``,
``wy``, ``wo``, ``conv``, ``w_a``, ``w_i``, ``lam``).

bfloat16 leaves arrive as ``ml_dtypes.bfloat16`` arrays, which
``torch.from_numpy`` refuses; they cross as their raw 16-bit patterns
(a ``uint16`` view reinterpreted as ``torch.bfloat16``), which is exact —
no float32 round trip.
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
    RECURRENT,
    Block,
    Transformer,
    check_supported,
)


def tensor_from_numpy(arr, device) -> torch.Tensor:
    a = np.array(arr, copy=True, order="C")  # JAX hands out read-only views
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _pdict(d: Dict[str, Any], device, idx=None) -> nn.ParameterDict:
    return nn.ParameterDict({
        k: L._param(tensor_from_numpy(v if idx is None else v[idx], device))
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
                p = stage[ui]
                mixer = p["rglru" if kind in RECURRENT else "attn"]
                blocks.append(Block(
                    kind, _pdict(p["norm"], dev, idx),
                    _pdict(mixer, dev, idx), _pdict(p["mlp_norm"], dev, idx),
                    _pdict(p["mlp"], dev, idx),
                ))
    lm_head = tree.get("lm_head")
    return Transformer(
        cfg,
        tensor_from_numpy(tree["embed"], dev),
        _pdict(tree["final_norm"], dev),
        None if lm_head is None else tensor_from_numpy(lm_head, dev),
        blocks,
    )
