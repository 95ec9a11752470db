"""Checkpointing of the port (counterpart of ``repro.checkpoint.ckpt``):
a tree of tensors → ``.npz`` keyed by tree path, plus a JSON metadata
entry and an optional versioned JSON **sidecar**.

A tree is nested dicts, lists/tuples, NamedTuples (keyed by field name)
and modules (keyed by their parameters' dotted names, split on the
dots); leaves are tensors or numpy arrays. Keys are the
'/'-joined paths (``params/layers/3/attn/wq``, ``opt/mu/embed``);
``__metadata__`` and ``__sidecar__`` are reserved. Tensors cross as
numpy, bfloat16 as its 16-bit patterns (``uint16``), as
``models.convert`` does.

Non-tensor state (drafter windows, length priors, generator state,
loader cursor — anything JSON-able that must travel with the weights so
a resumed run is warm) rides in the sidecar: ``save(..., sidecar={...})``
and ``load_sidecar(path)``. Loads check the sidecar schema version and
fail with a clear error on a mismatch instead of mis-reading a foreign
blob.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.models.convert import tensor_from_numpy, tensor_to_numpy

SIDECAR_SCHEMA_VERSION = 1
_RESERVED = ("__metadata__", "__sidecar__")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix: str, out: List[Tuple[str, Any]]) -> None:
    if isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            out.append((prefix + name.replace(".", "/"), p))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}/", out)
    elif _is_namedtuple(tree):
        for k in tree._fields:
            _flatten(getattr(tree, k), f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}/", out)
    else:
        out.append((prefix[:-1], tree))


def save(
    path: str,
    tree: Any,
    metadata: Optional[Dict] = None,
    sidecar: Optional[Dict] = None,
) -> None:
    """Save a tree (+ JSON metadata, + optional JSON sidecar blobs)."""
    leaves: List[Tuple[str, Any]] = []
    _flatten(tree, "", leaves)
    flat = {}
    for key, leaf in leaves:
        if key in _RESERVED:
            raise ValueError(f"tree path {key!r} collides with a reserved key")
        flat[key] = (tensor_to_numpy(leaf) if isinstance(leaf, torch.Tensor)
                     else np.asarray(leaf))
    if sidecar is not None:
        flat["__sidecar__"] = json.dumps(
            {"schema_version": SIDECAR_SCHEMA_VERSION, "blobs": sidecar}
        )
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, __metadata__=json.dumps(metadata or {}), **flat)


def load_sidecar(
    path: str, expected_version: int = SIDECAR_SCHEMA_VERSION
) -> Dict:
    """Read the sidecar blobs; schema-checked.

    Raises ``KeyError`` when the checkpoint has no sidecar and
    ``ValueError`` on a schema/version mismatch — resumption code must
    not guess at the layout of a foreign blob.
    """
    with np.load(path, allow_pickle=False) as zf:
        if "__sidecar__" not in zf.files:
            raise KeyError(
                f"{path}: checkpoint has no sidecar state "
                "(saved without sidecar=...)"
            )
        obj = json.loads(str(zf["__sidecar__"]))
    if not isinstance(obj, dict) or "schema_version" not in obj:
        raise ValueError(f"{path}: malformed sidecar (no schema_version)")
    if obj["schema_version"] != expected_version:
        raise ValueError(
            f"{path}: sidecar schema_version {obj['schema_version']} != "
            f"expected {expected_version}; re-save the checkpoint with "
            "this build or upgrade the loader"
        )
    return obj["blobs"]


def _restore_leaf(key: str, arr: np.ndarray, like) -> Any:
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(
            f"shape mismatch at {key}: ckpt {arr.shape} vs "
            f"{tuple(like.shape)}"
        )
    if isinstance(like, np.ndarray):
        return arr.astype(like.dtype)
    if like.dtype == torch.bfloat16 and arr.dtype == np.uint16:
        return tensor_from_numpy(arr.view(np.int16), like.device).view(
            torch.bfloat16)
    return tensor_from_numpy(arr, like.device).to(like.dtype)


def _rebuild(like, prefix: str, leaves: Dict[str, np.ndarray]):
    if isinstance(like, nn.Module):
        with torch.no_grad():
            for name, p in like.named_parameters():
                key = prefix + name.replace(".", "/")
                p.copy_(_restore_leaf(key, _take(leaves, key), p))
        return like
    if isinstance(like, dict):
        return {k: _rebuild(v, f"{prefix}{k}/", leaves)
                for k, v in like.items()}
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(getattr(like, k), f"{prefix}{k}/",
                                     leaves) for k in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, f"{prefix}{i}/", leaves)
                          for i, v in enumerate(like))
    key = prefix[:-1]
    return _restore_leaf(key, _take(leaves, key), like)


def _take(leaves: Dict[str, np.ndarray], key: str) -> np.ndarray:
    if key not in leaves:
        raise KeyError(f"checkpoint missing leaf {key}")
    return leaves[key]


def load(path: str, like: Any) -> Tuple[Any, Dict]:
    """Restore into the structure of ``like`` (a template tree): tensors
    come back on the template's device in its dtype. A module in the
    template is restored in place (its parameters keep their identity,
    so whatever holds the model sees the loaded weights) and returned."""
    with np.load(path, allow_pickle=False) as zf:
        meta = json.loads(str(zf["__metadata__"]))
        leaves = {k: zf[k] for k in zf.files if k not in _RESERVED}
    return _rebuild(like, "", leaves), meta
