"""Logical-axis sharding rules of the port's dry run (counterpart of
``repro.launch.sharding``; MaxText-style rules).

Every parameter, cache and input leaf carries logical axis names
(``models.model.param_logical_axes``, ``cache_logical_axes``, the
workloads' input axes); a rules table maps logical names to mesh axes. A
logical axis shards only where the dimension divides the mesh axis size,
otherwise it replicates (Qwen2-1.5B's 12 heads on a 16-way model axis),
which the dry run's ``bytes_per_device`` then shows. The rules are the
hill-climb's lever: overrides are plain dicts.

The port runs one eager process on one card, with no SPMD partitioner:
a spec here is what the reference's ``NamedSharding`` would be, used to
count each device's share of the state (``dryrun.bytes_per_device``).
``P`` is a tuple stand-in for ``PartitionSpec``; ``constrain`` and
``constrain_moe`` are the identity.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

AxisVal = Union[None, str, Tuple[str, ...]]


class P(tuple):
    """A partition spec: one mesh axis (a name, a tuple of names, or None
    for replicated) per array dimension; a one-name tuple reads as the
    name, as ``PartitionSpec`` canonicalises it."""

    def __new__(cls, *parts: AxisVal) -> "P":
        return super().__new__(cls, (
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


# Default logical→mesh rules (single- and multi-pod meshes share them;
# absent mesh axes are dropped automatically).
DEFAULT_RULES: Dict[str, AxisVal] = {
    "vocab": "model",
    "embed": ("pod", "data"),  # FSDP / ZeRO-3 on the weight feature dim
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "layers": None,
    # activations
    "batch": ("pod", "data"),
    "act_seq": "model",  # sequence-parallel residual stream (training)
    "kv_seq": "model",  # decode cache sequence when kv_heads can't shard
}


def _mesh_axis_size(mesh, axis: AxisVal) -> int:
    if axis is None:
        return 1
    if isinstance(axis, str):
        return mesh.shape[axis] if axis in mesh.shape else 1
    n = 1
    for a in axis:
        n *= mesh.shape[a] if a in mesh.shape else 1
    return n


def _filter_axis(mesh, axis: AxisVal) -> AxisVal:
    """Drop mesh axes that don't exist in this mesh (pod on single-pod)."""
    if axis is None:
        return None
    if isinstance(axis, str):
        return axis if axis in mesh.shape else None
    kept = tuple(a for a in axis if a in mesh.shape)
    return kept if kept else None


def spec_for(
    shape: Sequence[int],
    axes: Sequence[Optional[str]],
    mesh,
    rules: Optional[Dict[str, AxisVal]] = None,
) -> P:
    """Partition spec of one array from its logical axes + divisibility;
    ``mesh`` is anything with a ``.shape`` mapping (``mesh.MeshShape``)."""
    rules = rules or DEFAULT_RULES
    used: set = set()
    parts = []
    for dim, name in zip(shape, axes):
        axis = _filter_axis(mesh, rules.get(name)) if name else None
        if axis is not None:
            size = _mesh_axis_size(mesh, axis)
            flat = (axis,) if isinstance(axis, str) else tuple(axis)
            if dim % max(size, 1) != 0 or any(a in used for a in flat):
                axis = None
            else:
                used.update(flat)
        parts.append(axis)
    return P(*parts)


def is_axes(x) -> bool:
    """True for a logical-axes leaf: a tuple of names and Nones."""
    return isinstance(x, tuple) and not isinstance(x, P) and all(
        isinstance(a, (str, type(None))) for a in x)


def map_tree(fn, tree, axes):
    """``fn(leaf, leaf_axes)`` over a value tree and its matching axes
    tree: dicts, lists, tuples, named tuples and the model's ``Cache``
    (its ``layers`` and ``lengths``) are walked, an axes leaf (``is_axes``)
    ends the walk, a None stays None."""
    if axes is None:
        return None
    if is_axes(axes):
        return fn(tree, axes)
    if isinstance(axes, dict):
        return {k: map_tree(fn, tree[k], axes[k]) for k in axes}
    if hasattr(axes, "layers") and hasattr(axes, "lengths"):  # Cache
        return type(axes)(map_tree(fn, tree.layers, axes.layers),
                          map_tree(fn, tree.lengths, axes.lengths))
    parts = [map_tree(fn, t, a) for t, a in zip(tree, axes)]
    if hasattr(axes, "_fields"):  # a named tuple
        return type(axes)(*parts)
    return type(axes)(parts)


def tree_specs(
    shapes_tree,  # tree of tensors (meta or real)
    axes_tree,  # matching tree of logical-axes tuples
    mesh,
    rules: Optional[Dict[str, AxisVal]] = None,
):
    """Partition-spec tree for a (shapes, logical axes) pair (the
    reference's ``tree_shardings``, specs in place of shardings)."""
    return map_tree(lambda t, ax: spec_for(tuple(t.shape), ax, mesh, rules),
                    shapes_tree, axes_tree)


# ---------------------------------------------------------------------------
# Activation-sharding context (sequence-parallel residual stream). The
# reference's forward consults it between blocks; the port's forward, one
# process with no partitioner, has nothing to constrain.
# ---------------------------------------------------------------------------

_ctx = threading.local()


def activation_spec() -> Optional[P]:
    return getattr(_ctx, "act_spec", None)


def moe_cap_axis() -> AxisVal:
    return getattr(_ctx, "moe_cap", None)


@contextlib.contextmanager
def use_activation_spec(spec: Optional[P], moe_cap: AxisVal = None):
    prev = getattr(_ctx, "act_spec", None)
    prev_m = getattr(_ctx, "moe_cap", None)
    _ctx.act_spec = spec
    _ctx.moe_cap = moe_cap
    try:
        yield
    finally:
        _ctx.act_spec = prev
        _ctx.moe_cap = prev_m


def constrain(x):
    """The identity: the reference applies the ambient activation spec as
    a sharding constraint for XLA's SPMD partitioner; a one-process eager
    program has no partitioner to constrain."""
    return x


def constrain_moe(x):
    """The identity, for the reference's MoE capacity-buffer constraint
    (``moe_cap_axis``), as ``constrain``."""
    return x


def batch_spec(mesh, rules=None, extra_dims: int = 1) -> P:
    rules = rules or DEFAULT_RULES
    b = _filter_axis(mesh, rules.get("batch"))
    return P(b, *([None] * extra_dims))


def residual_spec(mesh, seq_len: int, rules=None) -> Optional[P]:
    """(batch, seq, d) sequence-parallel spec if seq divides the model
    axis (Megatron sequence parallelism)."""
    rules = rules or DEFAULT_RULES
    b = _filter_axis(mesh, rules.get("batch"))
    s = _filter_axis(mesh, rules.get("act_seq"))
    if s is None:
        return P(b, None, None)
    if seq_len % _mesh_axis_size(mesh, s) != 0:
        s = None
    return P(b, s, None)
