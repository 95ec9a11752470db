"""Weight bridge: the reference's parameter tree (as numpy arrays) → the
port's ``Transformer`` (``params_from_numpy``), and back
(``params_to_numpy``).

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


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array; bfloat16 as its ``uint16`` bit
    patterns (exact), the inverse of ``tensor_from_numpy``'s crossing."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def params_to_numpy(params: Transformer, cfg: ModelConfig) -> Dict[str, Any]:
    """The inverse of ``params_from_numpy``: the reference's value tree
    ``{"embed", "final_norm", ["lm_head"], "stages"}`` with each scanned
    stage's leaves stacked along a leading layer axis, as float32 numpy
    arrays (bfloat16 widens exactly)."""
    def arr(t):
        return t.detach().float().cpu().numpy()

    def pd(d):
        return {k: arr(v) for k, v in d.items()}

    layers = list(params.layers)
    stages: List[Any] = []
    li = 0
    for unit, repeats in cfg.scan_stages:
        reps = []
        for _ in range(repeats):
            unit_p = []
            for kind in unit:
                blk = layers[li]
                li += 1
                mixer = "rglru" if kind in RECURRENT else "attn"
                unit_p.append({"norm": pd(blk.norm),
                               mixer: pd(getattr(blk, mixer)),
                               "mlp_norm": pd(blk.mlp_norm),
                               "mlp": pd(blk.mlp)})
            reps.append(tuple(unit_p))
        if repeats > 1:
            reps = [tuple(
                {part: {k: np.stack([r[ui][part][k] for r in reps])
                        for k in reps[0][ui][part]}
                 for part in reps[0][ui]}
                for ui in range(len(unit)))]
        stages.append(reps[0])
    tree: Dict[str, Any] = {"embed": arr(params.embed),
                            "final_norm": pd(params.final_norm),
                            "stages": stages}
    if params.lm_head is not None:
        tree["lm_head"] = arr(params.lm_head)
    return tree
