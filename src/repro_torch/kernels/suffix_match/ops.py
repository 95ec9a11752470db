"""Wrappers of the suffix-match drafting kernels (``csrc/suffix_match.cu``)
and the host plumbing around them (port of
``repro.kernels.suffix_match.ops``).

* ``pack_forest`` — concatenate the distinct per-problem packed trees of
  one batch into one node table + corpus (indices offset per tree, sizes
  padded to power-of-two buckets), as int32 tensors on the device, plus
  the per-tree root indices;
* ``pack_forest_chunked`` — the per-tree layout: row t of every array
  holds tree t with tree-local indices, padded to common strides; roots
  are tree ordinals;
* ``suffix_match_propose`` — one device call for a ``(B, m)`` batch of
  context tails: longest-suffix match length + up to ``n_prop_max``
  greedy continuation tokens per row, routed on the forest's layout.

For CUDA tensors a wrapper launches its kernel (or raises); for CPU
tensors it runs the plain version (``ref.py``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.suffix_match.ref import (
    suffix_match_propose_chunked_ref,
    suffix_match_propose_ref,
)

_MIN_NODES = 1024
_MIN_EDGES = 1024
_MIN_CORPUS = 2048
_MIN_STRIDE = 256
_SENTINEL = np.int32(np.iinfo(np.int32).max)  # sorts past every real edge

# Launches of each CUDA kernel by its wrapper (one per call on CUDA).
LAUNCHES = 0
LAUNCHES_CHUNKED = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "suffix_match_propose_flat": (
        _P, _I, _P, _I, _P, _I,  # tails, roots, budgets (+ strides)
        _P, _P, _P, _P, _P, _P, _P, _P, _P,  # forest
        _I, _I, _I, _I, _I, _I,  # B, m, E, C, K, min_match
        _P, _P, _P, _P,  # match_len, n_prop, props, stream
    ),
    "suffix_match_propose_chunked": (
        _P, _I, _P, _I, _P, _I,  # tails, roots, budgets (+ strides)
        _P, _P, _P, _P, _P, _P, _P, _P, _P,  # forest (T rows each)
        _I, _I, _I, _I, _I, _I,  # B, m, T, Es, Ns, Cs
        _I, _I,  # K, min_match
        _P, _P, _P, _P,  # match_len, n_prop, props, stream
    ),
}


class PackedForest(NamedTuple):
    """Concatenated ``PackedSuffixTree`` exports, on the device."""

    edge_node: torch.Tensor
    edge_tok: torch.Tensor
    edge_child: torch.Tensor
    suffix_link: torch.Tensor
    edge_start: torch.Tensor
    edge_len: torch.Tensor
    first_tok: torch.Tensor
    best_child: torch.Tensor
    corpus: torch.Tensor


class ChunkedForest(NamedTuple):
    """Per-tree export: row ``t`` holds tree ``t`` (tree-local node, edge
    and corpus indices, padded to a common stride). ``roots`` for this
    layout are tree ordinals (row indices), not node ids."""

    edge_node: torch.Tensor  # (T, Es)
    edge_tok: torch.Tensor
    edge_child: torch.Tensor
    suffix_link: torch.Tensor  # (T, Ns)
    edge_start: torch.Tensor
    edge_len: torch.Tensor
    first_tok: torch.Tensor
    best_child: torch.Tensor
    corpus: torch.Tensor  # (T, Cs)


def _bucket(n: int, floor: int) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


def pack_forest(
    packs: Sequence, *, min_nodes: int = _MIN_NODES,
    min_edges: int = _MIN_EDGES, min_corpus: int = _MIN_CORPUS,
    device=None,
) -> Tuple[PackedForest, np.ndarray]:
    """Concatenate packed trees; returns (forest, root index per tree).

    Node indices are shifted by each tree's node offset and edge spans by
    its corpus offset, so every tree keeps its exact host semantics
    (``suffix_link[root] == root`` included). Per-tree edge tables are
    lexicographic in (node, token) over disjoint increasing node ranges,
    so the concatenation stays sorted. Padding is inert (edge sentinels
    sort last, padding nodes have no edges and self-link), and lengths
    are padded to power-of-two buckets with 25% headroom."""
    n_total = sum(p.n_nodes for p in packs)
    e_total = sum(p.n_edges for p in packs)
    c_total = sum(len(p.corpus) for p in packs)
    N = _bucket(max(n_total + n_total // 4, 1), min_nodes)
    E = _bucket(max(e_total + e_total // 4, 1), min_edges)
    C = _bucket(max(c_total + c_total // 4, 1), min_corpus)
    en = np.full(E, _SENTINEL, np.int32)
    et = np.full(E, _SENTINEL, np.int32)
    ec = np.full(E, -1, np.int32)
    sl = np.zeros(N, np.int32)
    es = np.zeros(N, np.int32)
    el = np.zeros(N, np.int32)
    ft = np.full(N, -1, np.int32)
    bc = np.full(N, -1, np.int32)
    corpus = np.full(C, -1, np.int32)
    roots = np.zeros(len(packs), np.int32)
    noff = eoff = coff = 0
    for i, p in enumerate(packs):
        n, e, c = p.n_nodes, p.n_edges, len(p.corpus)
        roots[i] = noff
        en[eoff:eoff + e] = p.edge_node + noff
        et[eoff:eoff + e] = p.edge_tok
        ec[eoff:eoff + e] = p.edge_child + noff
        bc[noff:noff + n] = np.where(p.best_child >= 0,
                                     p.best_child + noff, -1)
        sl[noff:noff + n] = p.suffix_link + noff
        es[noff:noff + n] = p.edge_start + coff
        el[noff:noff + n] = p.edge_len
        ft[noff:noff + n] = p.first_tok
        corpus[coff:coff + c] = p.corpus
        noff += n
        eoff += e
        coff += c
    # Inert padding nodes self-link so a (masked) hop can never escape.
    sl[noff:] = np.arange(noff, N, dtype=np.int32)
    dev = resolve_device(device)
    forest = PackedForest(*(
        torch.tensor(a, device=dev)
        for a in (en, et, ec, sl, es, el, ft, bc, corpus)
    ))
    return forest, roots


def pack_forest_chunked(
    packs: Sequence, *, min_stride_nodes: int = _MIN_STRIDE,
    min_stride_edges: int = _MIN_STRIDE, min_stride_corpus: int = _MIN_STRIDE,
    min_trees: int = 1, device=None,
) -> Tuple[ChunkedForest, np.ndarray]:
    """Pack trees into the per-tree chunked layout; returns (forest, tree
    ordinal per tree).

    Nothing is offset: every row keeps the tree-local indices of its
    ``PackedSuffixTree`` (root = node 0). Strides are the bucketed largest
    single-tree sizes (25% headroom, power-of-two with floors) and the
    tree count is bucketed too. Padding is inert: edge sentinels sort
    last, padding nodes self-link *locally*, padded corpus is separators
    (-1), and padded tree rows are never selected (inactive rows clamp to
    tree 0 with root -1)."""
    n_max = max((p.n_nodes for p in packs), default=1)
    e_max = max((p.n_edges for p in packs), default=1)
    c_max = max((len(p.corpus) for p in packs), default=1)
    Ns = _bucket(n_max + n_max // 4, min_stride_nodes)
    Es = _bucket(e_max + e_max // 4, min_stride_edges)
    Cs = _bucket(c_max + c_max // 4, min_stride_corpus)
    T = _bucket(max(len(packs), 1), max(min_trees, 1))
    en = np.full((T, Es), _SENTINEL, np.int32)
    et = np.full((T, Es), _SENTINEL, np.int32)
    ec = np.full((T, Es), -1, np.int32)
    sl = np.broadcast_to(np.arange(Ns, dtype=np.int32), (T, Ns)).copy()
    es = np.zeros((T, Ns), np.int32)
    el = np.zeros((T, Ns), np.int32)
    ft = np.full((T, Ns), -1, np.int32)
    bc = np.full((T, Ns), -1, np.int32)
    corpus = np.full((T, Cs), -1, np.int32)
    for i, p in enumerate(packs):
        n, e, c = p.n_nodes, p.n_edges, len(p.corpus)
        en[i, :e] = p.edge_node
        et[i, :e] = p.edge_tok
        ec[i, :e] = p.edge_child
        sl[i, :n] = p.suffix_link
        es[i, :n] = p.edge_start
        el[i, :n] = p.edge_len
        ft[i, :n] = p.first_tok
        bc[i, :n] = p.best_child
        corpus[i, :c] = p.corpus
    dev = resolve_device(device)
    forest = ChunkedForest(*(
        torch.tensor(a, device=dev)
        for a in (en, et, ec, sl, es, el, ft, bc, corpus)
    ))
    return forest, np.arange(len(packs), dtype=np.int32)


def _check(forest, tails, roots, budgets, n_prop_max) -> None:
    dev = tails.device
    ndim = 2 if isinstance(forest, ChunkedForest) else 1
    for name, t in zip(PackedForest._fields, forest):
        if t.dtype != torch.int32 or t.dim() != ndim or not t.is_contiguous():
            raise ValueError(f"suffix_match: forest.{name} must be a "
                             f"contiguous {ndim}-D int32 tensor")
        if t.device != dev:
            raise ValueError(f"suffix_match: forest.{name} is not on {dev}")
    if ndim == 2 and len({t.shape[0] for t in forest}) != 1:
        raise ValueError("suffix_match: chunked forest arrays must share "
                         "their tree count")
    if tails.dim() != 2 or tails.stride(1) != 1:
        raise ValueError("suffix_match: tails must be (B, m) with unit "
                         "stride along m")
    B, m = tails.shape
    if m < 1 or n_prop_max < 1:
        raise ValueError("suffix_match: needs m >= 1 and n_prop_max >= 1")
    for name, t in (("tails", tails), ("roots", roots), ("budgets", budgets)):
        if t.dtype != torch.int32 or t.device != dev:
            raise ValueError(f"suffix_match: {name} must be int32 on {dev}")
    if tuple(roots.shape) != (B,) or tuple(budgets.shape) != (B,):
        raise ValueError("suffix_match: roots and budgets must be (B,)")


def suffix_match_propose_cuda(forest: PackedForest, tails, roots, budgets,
                              *, n_prop_max: int, min_match: int):
    """Launch the CUDA kernel (CUDA tensors only)."""
    global LAUNCHES
    if not tails.is_cuda:
        raise ValueError("suffix_match_propose_cuda takes CUDA tensors")
    if not isinstance(forest, PackedForest):
        raise ValueError("suffix_match_propose_cuda takes a PackedForest")
    _check(forest, tails, roots, budgets, n_prop_max)
    B, m = tails.shape
    E = forest.edge_node.shape[0]
    C = forest.corpus.shape[0]
    lib = _build.load("suffix_match", _SIGNATURES)
    match_len = torch.empty(B, dtype=torch.int32, device=tails.device)
    n_prop = torch.empty(B, dtype=torch.int32, device=tails.device)
    props = torch.empty((B, n_prop_max), dtype=torch.int32,
                        device=tails.device)
    err = lib.suffix_match_propose_flat(
        tails.data_ptr(), tails.stride(0), roots.data_ptr(), roots.stride(0),
        budgets.data_ptr(), budgets.stride(0),
        *(t.data_ptr() for t in forest),
        B, m, E, C, int(n_prop_max), int(min_match),
        match_len.data_ptr(), n_prop.data_ptr(), props.data_ptr(),
        _build.cuda_stream_ptr(tails.device),
    )
    _build.check(err, "suffix_match_propose launch")
    LAUNCHES += 1
    return match_len, n_prop, props


def suffix_match_propose_chunked_cuda(forest: ChunkedForest, tails, roots,
                                      budgets, *, n_prop_max: int,
                                      min_match: int):
    """Launch the chunked-layout CUDA kernel (CUDA tensors only);
    ``roots`` are tree ordinals, < 0 for an inactive row."""
    global LAUNCHES_CHUNKED
    if not tails.is_cuda:
        raise ValueError("suffix_match_propose_chunked_cuda takes CUDA "
                         "tensors")
    if not isinstance(forest, ChunkedForest):
        raise ValueError("suffix_match_propose_chunked_cuda takes a "
                         "ChunkedForest")
    _check(forest, tails, roots, budgets, n_prop_max)
    B, m = tails.shape
    T, Es = forest.edge_node.shape
    Ns = forest.suffix_link.shape[1]
    Cs = forest.corpus.shape[1]
    lib = _build.load("suffix_match", _SIGNATURES)
    match_len = torch.empty(B, dtype=torch.int32, device=tails.device)
    n_prop = torch.empty(B, dtype=torch.int32, device=tails.device)
    props = torch.empty((B, n_prop_max), dtype=torch.int32,
                        device=tails.device)
    err = lib.suffix_match_propose_chunked(
        tails.data_ptr(), tails.stride(0), roots.data_ptr(), roots.stride(0),
        budgets.data_ptr(), budgets.stride(0),
        *(t.data_ptr() for t in forest),
        B, m, T, Es, Ns, Cs, int(n_prop_max), int(min_match),
        match_len.data_ptr(), n_prop.data_ptr(), props.data_ptr(),
        _build.cuda_stream_ptr(tails.device),
    )
    _build.check(err, "suffix_match_propose_chunked launch")
    LAUNCHES_CHUNKED += 1
    return match_len, n_prop, props


def propose_device(forest, tails, roots, budgets, *, n_prop_max: int,
                   min_match: int):
    """Propose over device tensors (usable inside the fused round), routed
    on the forest's layout: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if isinstance(forest, ChunkedForest):
        if tails.is_cuda:
            return suffix_match_propose_chunked_cuda(
                forest, tails, roots, budgets,
                n_prop_max=n_prop_max, min_match=min_match,
            )
        return suffix_match_propose_chunked_ref(
            tails, roots, budgets, *forest,
            n_prop_max=n_prop_max, min_match=min_match,
        )
    if tails.is_cuda:
        return suffix_match_propose_cuda(
            forest, tails, roots, budgets,
            n_prop_max=n_prop_max, min_match=min_match,
        )
    return suffix_match_propose_ref(
        tails, roots, budgets, *forest,
        n_prop_max=n_prop_max, min_match=min_match,
    )


def pack_query(tails, roots, budgets) -> np.ndarray:
    """Fuse per-round inputs into the single (B, m+2) transfer array."""
    return np.concatenate(
        [
            np.asarray(tails, np.int32),
            np.asarray(roots, np.int32)[:, None],
            np.asarray(budgets, np.int32)[:, None],
        ],
        axis=1,
    )


def suffix_match_propose(
    forest,  # PackedForest | ChunkedForest
    tails,  # (B, m) int context tails, -1 = padding/reset
    roots,  # (B,) int root node (flat) / tree ordinal (chunked); < 0 = inactive
    budgets,  # (B,) int per-row draft budget
    *,
    n_prop_max: int,
    min_match: int = 1,
    query: np.ndarray | None = None,  # pre-packed (B, m+2) override
):
    """Batched longest-suffix match + greedy continuation proposal on the
    forest's device. The host inputs cross as ONE (B, m+2) upload.
    Returns ``(match_len (B,), n_prop (B,), props (B, n_prop_max))``
    device tensors (not synchronised)."""
    if query is None:
        query = pack_query(tails, roots, budgets)
    q = torch.tensor(np.asarray(query, np.int32), device=forest.corpus.device)
    return propose_device(
        forest, q[:, :-2], q[:, -2], q[:, -1],
        n_prop_max=int(n_prop_max), min_match=int(min_match),
    )
