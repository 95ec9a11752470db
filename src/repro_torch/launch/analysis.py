"""Counted cost of a step and its roofline terms (counterpart of
``repro.launch.analysis``).

The reference compiles each step with XLA and reads ``cost_analysis()``
(FLOPs, bytes accessed) and ``memory_analysis()`` (temporaries). PyTorch
has no ahead-of-time compile; its counterpart of "evaluate without
allocating" is running the step on meta tensors, and of
``cost_analysis`` a ``TorchDispatchMode`` that counts every aten op the
eager step issues (``count_cost``). The port's forward is a Python loop
over the layers, so every layer is visited and counted.

  * FLOPs: ``torch.utils.flop_counter``'s formulas (matrix products,
    convolutions, attention ops), plus the work the hand-written kernels'
    wrappers report on meta tensors (``kernels.work``) in place of their
    plain versions' operations;
  * bytes: each op's operand bytes plus its result bytes, as XLA's
    "bytes accessed" counts them; view ops and allocations count nothing,
    an in-place op writes its destination (an indexed write only the
    values it stores) and reads it only where its result depends on it;
  * temp bytes: the peak of live op outputs, counted by storage (a
    weakref finalizer on the storage of every tensor an op allocates: a
    tensor autograd saves for the backward keeps its storage alive after
    its Python object is gone), the counterpart of
    ``memory_analysis().temp_size_in_bytes``.

Roofline terms use the card's published peaks (``launch.mesh``: NVIDIA
H100 80GB HBM3, 700 W, data-sheet figures):

  compute = FLOPs / (chips × 989e12)
  memory  = bytes / (chips × 3.35e12)

The port counts no collectives: nothing in PyTorch produces the HLO the
reference parses (``parse_collectives``), and collective traffic needs a
multi-GPU execution path, which the port does not have. The collective
fields stay None. Nothing here touches a device: the dry run runs with or
without a card.
"""

from __future__ import annotations

import math
import weakref
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import work as kernel_work
from repro_torch.launch.mesh import CARD, HBM_BW, PEAK_FLOPS_BF16

_aten = torch.ops.aten
# ops that allocate or relabel without moving data
_FREE = {_aten.empty, _aten.empty_like, _aten.empty_strided,
         _aten.new_empty, _aten.new_empty_strided, _aten._unsafe_view,
         _aten.detach, _aten.lift_fresh, _aten.alias}
# in-place ops whose result does not depend on the destination's values
_OVERWRITE = {_aten.copy_, _aten.fill_, _aten.zero_, _aten.index_put_,
              _aten._index_put_impl_}
# indexed writes: only the stored values are written
_INDEXED = {_aten.index_put_, _aten._index_put_impl_}


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a tensor addresses: a broadcast
    (stride-0) dimension counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


@dataclass
class Cost:
    """Counted totals of one step: ``flops``, ``bytes`` (accessed),
    ``temp_bytes`` (peak of live op outputs), ``ops`` (aten ops issued)
    and, by kernel, the reports of the hand-written kernels' wrappers
    (``launches``, ``kernel_flops``, ``kernel_bytes``)."""

    flops: float = 0.0
    bytes: float = 0.0
    temp_bytes: float = 0.0
    ops: int = 0
    launches: Counter = field(default_factory=Counter)
    kernel_flops: Counter = field(default_factory=Counter)
    kernel_bytes: Counter = field(default_factory=Counter)

    def vector(self) -> Tuple[float, float, float]:
        return (self.flops, self.bytes, self.temp_bytes)


class _CountMode(TorchDispatchMode):
    def __init__(self, cost: Cost) -> None:
        super().__init__()
        self.cost = cost
        self.live = 0
        self.storages = set()  # the live storages' addresses

    def _free(self, key: int, n: int) -> None:
        self.storages.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        c = self.cost
        c.ops += 1
        packet = func.overloadpacket
        if packet in flop_registry:
            c.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if func.is_view or packet in _FREE:
            return out
        schema_args = func._schema.arguments
        inplace = bool(schema_args) and schema_args[0].alias_info is not None \
            and schema_args[0].alias_info.is_write
        operands = list(args) + list(kwargs.values())
        if inplace and packet in _OVERWRITE:
            operands = operands[1:]
        c.bytes += sum(tensor_bytes(t) for t in _tensors(operands))
        if inplace:
            dest = args[0]
            if packet in _INDEXED:  # the indexed region's bytes
                idx = args[1]
                region = torch.broadcast_shapes(
                    *(i.shape for i in idx if i is not None))
                c.bytes += dest.element_size() * math.prod(region) \
                    * math.prod(dest.shape[len(idx):])
            else:
                c.bytes += tensor_bytes(dest)
            return out
        for t in _tensors(out):
            c.bytes += tensor_bytes(t)
            st = t.untyped_storage()
            key = st._cdata
            if key in self.storages:  # an output aliasing a live one
                continue
            n = st.nbytes()
            self.storages.add(key)
            self.live += n
            c.temp_bytes = max(c.temp_bytes, self.live)
            weakref.finalize(st, self._free, key, n)
        return out


def count_cost(fn, *args, **kwargs) -> Tuple[Any, Cost]:
    """Run ``fn(*args, **kwargs)`` (on meta tensors: nothing allocated,
    nothing launched) under the counting mode; returns (its result, the
    ``Cost``). The counterpart of the reference's ``extract_cost`` and of
    ``memory_analysis()``'s temporaries."""
    cost = Cost()

    def sink(name: str, flops: float, nbytes: float) -> None:
        cost.flops += flops
        cost.bytes += nbytes
        cost.launches[name] += 1
        cost.kernel_flops[name] += flops
        cost.kernel_bytes[name] += nbytes

    with kernel_work.collect(sink), _CountMode(cost):
        out = fn(*args, **kwargs)
    return out, cost


@dataclass
class Roofline:
    """The reference's record, counted. ``hlo_flops`` / ``hlo_bytes`` /
    ``model_flops`` are per device, the totals over the mesh's devices:
    an ideal split (the port does not model XLA's replication), so each
    term divides by one card's peak. ``collective_bytes`` and
    ``collectives`` are None: the port counts no collectives."""

    arch: str
    shape: str
    mesh: str
    n_chips: int
    hlo_flops: float  # per device: total / n_chips (an ideal split)
    hlo_bytes: float  # per device: total / n_chips (an ideal split)
    model_flops: float  # per device: 6·N·D (dense) / 6·N_active·D (MoE)
    collective_bytes: Optional[float] = None
    collectives: Optional[Dict[str, Dict[str, int]]] = None
    bytes_per_device: float = 0.0
    peak_memory: float = 0.0
    temp_bytes: float = 0.0  # total peak of live intermediates

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def t_collective(self) -> Optional[float]:
        return None

    @property
    def dominant(self) -> str:
        return "compute" if self.t_compute >= self.t_memory else "memory"

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    def as_dict(self) -> dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "n_chips": self.n_chips,
            "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "collectives": self.collectives,
            "bytes_per_device": self.bytes_per_device,
            "peak_memory": self.peak_memory,
            "total_flops": self.hlo_flops * self.n_chips,
            "total_bytes": self.hlo_bytes * self.n_chips,
            "temp_bytes": self.temp_bytes,
            "split": "ideal",
            "counted": True,
            "card": CARD,
        }


def model_flops_for(cfg, shape, n_active_params: int) -> float:
    """MODEL_FLOPS = 6·N·D with D = decoded/processed tokens.

    train: 6·N·B·S (fwd 2ND + bwd 4ND); prefill: 2·N·B·S;
    decode/verify: 2·N·B·T per step."""
    if shape.kind == "train":
        return 6.0 * n_active_params * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active_params * shape.global_batch * shape.seq_len
    T = 1 if shape.kind == "decode" else 9
    return 2.0 * n_active_params * shape.global_batch * T
