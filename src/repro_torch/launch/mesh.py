"""Meshes and hardware constants of the port's dry run (counterpart of
``repro.launch.mesh``).

The reference builds a ``jax.make_mesh`` of 256 or 512 placeholder TPU
devices. Here a mesh is abstract: an ordered mapping of axis name to size
(``MeshShape``), which is all the sharding rules read (``mesh.shape[a]``).
Nothing of ``torch.distributed`` is initialised and no device is touched,
so the dry run runs with or without a card.

  * ``make_local_mesh()``: (1, 1) ``("data", "model")``, the one H100;
  * ``make_production_mesh()``: the reference's 16×16 (``data`` ×
    ``model``), read as 256 H100s (32 nodes of 8); ``multi_pod=True``
    its 2×16×16 (``pod`` × ``data`` × ``model``), 512.

The constants price the roofline terms. They are NVIDIA's published
figures for the NVIDIA H100 80GB HBM3 (SXM) at its 700 W limit, data-sheet
numbers, not measurements; the same ones ``chip_smoke.py``'s bounds use.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

CARD = "NVIDIA H100 80GB HBM3, 700 W"  # the card the constants describe
PEAK_FLOPS_BF16 = 989e12  # FLOP/s a card, dense bf16 tensor cores
PEAK_FLOPS_F32 = 67e12  # FLOP/s a card, float32 outside the tensor cores
PEAK_FLOPS = {"bfloat16": PEAK_FLOPS_BF16, "float32": PEAK_FLOPS_F32}
HBM_BW = 3.35e12  # bytes/s a card
GPUS_PER_NODE = 8


class MeshShape:
    """An abstract device mesh: axis names in order and their sizes.

    ``mesh.shape`` is a dict ``{axis: size}`` (so ``mesh.shape[a]`` and
    ``a in mesh.shape`` read as on a ``jax.sharding.Mesh``); ``size`` is
    the number of devices."""

    def __init__(self, shape: Iterable[int], axes: Iterable[str]) -> None:
        self.shape: Dict[str, int] = dict(zip(tuple(axes), tuple(shape)))
        self.axis_names: Tuple[str, ...] = tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def name(self) -> str:
        """The reference's report label: ``16x16``, ``2x16x16``, ``1x1``."""
        return "x".join(str(n) for n in self.shape.values())

    def __repr__(self) -> str:
        return f"MeshShape({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshShape(shape, axes)


def make_local_mesh() -> MeshShape:
    """The one card, with the production mesh's axis names."""
    return MeshShape((1, 1), ("data", "model"))
