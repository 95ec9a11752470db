"""Wrapper of the spec-verify attention kernel (``csrc/spec_verify.cu``).

For CUDA tensors it checks what the kernel takes, allocates the output
and launches on the current stream; for CPU tensors it runs the plain
version (``ref.py``). There is no fallback between the two: a CUDA
tensor the kernel cannot take raises.

Unlike the TPU wrapper it pads no row or slot: the kernel reads queries
in the model's ``(B, T, Hq, hd)`` layout and regroups them per kv head
itself (rows ``t*G + g``), and masks the ragged end of the cache. The
kernels are built for head dims 32, 64, 128 and 256; a smaller head dim
(the examples' 24, the 10m preset's 40) is zero-padded to the next of
them (``padded_head_dim``) with the scale of the real one: zero columns
add nothing to a score, and the output's first ``hd`` columns are the
answer.

Both kernels split the ring's tiles among CTAs (split-KV), and a combine
kernel merges a row's partials in split order; the plans come from
shapes alone, so a row's output never depends on what the cache holds
elsewhere, and the wrapper reads no tensor value on the host. The
bfloat16 plan (``split_plan``) also counts the batch's streams. The
float32 plan (``f32_split_plan``) fixes the split by S+1, hd and the SM
count alone, so a row's float32 output does not depend on B, T or the
other rows either, bit for bit (float32 is the exact gate of resumes
and re-sliced batches); only the cut of rows into CTAs, which no row's
arithmetic depends on, follows B and T. The float32 kernel runs on CUDA
cores in full float32 (fused multiply-adds, no TF32): a CTA holds up to
96 query rows of one kv head (8 a warp) and streams its split's live
K/V tiles once by 16-byte ``cp.async`` into a two-stage ring, with
register-tiled products (a lane: 4 rows x 4 slots of scores, 4 rows x
hd/16 output columns) and the online softmax on the score registers;
its combine is launched as a programmatic dependent of the main grid.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import work as _work
from repro_torch.kernels.spec_verify.ref import spec_verify_attention_ref

# Launches of the CUDA kernel by this wrapper (one per call on CUDA).
LAUNCHES = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # q, k, v, cache_pos, positions, out, the partials' scratch; B, T, Hq,
    # Hkv, S+1, hd, window; softcap, scale; the plan (tile, n_split,
    # tiles_per_split), for float32 also the rows' cut (warps,
    # row_blocks); the stream
    "spec_verify_attention_f32": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _I, _I, _I, _F, _F, _I, _I, _I, _I, _I,
                                  _P),
    "spec_verify_attention_bf16": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _I, _I, _I, _F, _F, _I, _I, _I, _P),
}
_ENTRY = {torch.float32: "spec_verify_attention_f32",
          torch.bfloat16: "spec_verify_attention_bf16"}


# The bfloat16 kernel's geometry (csrc/spec_verify.cu, TcCfg): slot
# positions one split may stage.
SPLIT_SLOTS_MAX = 4096


@dataclass(frozen=True)
class SplitPlan:
    """How the bfloat16 kernel cuts one call: ``row_blocks`` CTAs of up
    to ``cta_rows`` query rows for each (batch, kv head), and the ring of
    ``n_tiles`` tiles of ``tile`` slots into ``n_split`` splits, split j
    owning tiles j, j + n_split, j + 2 n_split, ... (at most
    ``tiles_per_split``). Ownership is fixed by tile index, so it depends
    on shapes alone; interleaving spreads a partly filled ring over the
    splits. Each (batch, kv head, row block, split) is one CTA, one K/V
    stream."""

    tile: int
    n_tiles: int
    cta_rows: int
    row_blocks: int
    n_split: int
    tiles_per_split: int

    def split_tiles(self, j: int) -> range:
        """The tiles split ``j`` owns, in the order it walks them."""
        return range(j, self.n_tiles, self.n_split)

    def split_slots(self, j: int, S1: int) -> List[Tuple[int, int]]:
        """The slot ranges ``[lo, hi)`` split ``j`` owns."""
        return [(t * self.tile, min((t + 1) * self.tile, S1))
                for t in self.split_tiles(j)]

    def row_ranges(self, TG: int) -> List[Tuple[int, int]]:
        return [(r * self.cta_rows, min((r + 1) * self.cta_rows, TG))
                for r in range(self.row_blocks)]

    def partial_floats(self, B: int, Hkv: int, TG: int, hd: int) -> int:
        """float32 scratch the partials take: ``acc`` of each (batch, kv
        head, split, row), then its (m, l); none for one split."""
        if self.n_split == 1:
            return 0
        return self.n_split * B * Hkv * TG * (hd + 2)


def split_plan(B: int, T: int, Hq: int, Hkv: int, S1: int, hd: int,
               n_sm: int) -> SplitPlan:
    """The bfloat16 kernel's split plan, from shapes and the SM count
    alone. Splits are added until the CTAs (streams x splits) fill the
    SMs once, but no further than keeps the float32 partials within half
    the bfloat16 K/V bytes (they are pure overhead) and than there are
    tiles; a split never stages more than ``SPLIT_SLOTS_MAX`` slots. A
    CTA holds two warpgroups of 64 query rows, one at hd 256 (whose
    float32 accumulator takes half a thread's registers)."""
    tile = 32 if hd > 128 else 64
    cta_rows = 64 if hd > 128 else 128
    TG = T * (Hq // Hkv)
    n_tiles = -(-S1 // tile)
    row_blocks = -(-TG // cta_rows)
    streams = B * Hkv * row_blocks
    kv_bytes = 2 * B * S1 * Hkv * hd * 2
    per_split = B * Hkv * TG * (hd + 2) * 4
    n = max(1, min(n_sm // streams, kv_bytes // (2 * per_split), n_tiles))
    n = max(n, -(-n_tiles * tile // SPLIT_SLOTS_MAX))
    return SplitPlan(tile=tile, n_tiles=n_tiles, cta_rows=cta_rows,
                     row_blocks=row_blocks, n_split=n,
                     tiles_per_split=-(-n_tiles // n))


# The float32 kernel's geometry (csrc/spec_verify.cu, F32Cfg): the most
# warps (8 query rows each) a CTA has, by head dim (what its shared memory
# and registers allow); the least slots a split owns.
F32_WARPS_MAX = {32: 12, 64: 12, 128: 12, 256: 8}
F32_SPLIT_SLOTS = 128


def f32_split_plan(B: int, T: int, Hq: int, Hkv: int, S1: int, hd: int,
                   n_sm: int) -> SplitPlan:
    """The float32 kernel's plan. The split (tiles of 64 slots, 32 at hd
    256; ``n_split`` splits of at least ``F32_SPLIT_SLOTS`` slots, at most
    one a SM) comes from (S+1, hd, n_sm) alone: a row's float32 output
    does not depend on the batch. A kv head's T*G rows are cut into
    ``row_blocks`` CTAs of ``cta_rows`` (whole warps of 8 rows, at most
    ``F32_WARPS_MAX[hd]`` warps): enough blocks that the (batch, kv head,
    split, block) CTAs cover the ``n_sm`` SMs once, where the rows
    allow."""
    tile = 32 if hd > 128 else 64
    n_tiles = -(-S1 // tile)
    n_split = max(1, min(-(-n_tiles * tile // F32_SPLIT_SLOTS), n_sm))
    warp_rows = -(-T * (Hq // Hkv) // 8)
    streams = B * Hkv * n_split
    blocks = max(-(-warp_rows // F32_WARPS_MAX[hd]),
                 min(warp_rows, -(-n_sm // streams)))
    warps = -(-warp_rows // blocks)
    return SplitPlan(tile=tile, n_tiles=n_tiles, cta_rows=8 * warps,
                     row_blocks=-(-warp_rows // warps), n_split=n_split,
                     tiles_per_split=-(-n_tiles // n_split))


_SMS: Dict[int, int] = {}

# The head dims the kernels are instantiated for.
HEAD_DIMS = (32, 64, 128, 256)


def padded_head_dim(hd: int) -> int:
    """The head dim a launch at ``hd`` runs at: the smallest of
    ``HEAD_DIMS`` that holds it."""
    for h in HEAD_DIMS:
        if hd <= h:
            return h
    raise ValueError(f"spec_verify: head_dim {hd} above {HEAD_DIMS[-1]}")


def _sm_count(device: torch.device) -> int:
    """The card's SM count, read once per device."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _check(q, k, v, cache_pos, positions) -> None:
    if q.dtype not in _ENTRY:
        raise TypeError(f"spec_verify: q dtype {q.dtype} not in "
                        f"{sorted(map(str, _ENTRY))}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"spec_verify: q {tuple(q.shape)}, k {tuple(k.shape)}"
                         f", v {tuple(v.shape)}")
    B, T, Hq, hd = q.shape
    Bk, S, Hkv, hdk = k.shape
    if Bk != B or hdk != hd or Hkv < 1 or Hq % Hkv:
        raise ValueError(f"spec_verify: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"spec_verify: head_dim {hd} not in {HEAD_DIMS}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("spec_verify: q, k and v must share one dtype")
    if tuple(cache_pos.shape) != (B, S) or tuple(positions.shape) != (B, T):
        raise ValueError("spec_verify: cache_pos must be (B, S), positions (B, T)")
    if cache_pos.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError("spec_verify: cache_pos and positions must be int32")
    for name, t in (("q", q), ("k", k), ("v", v), ("cache_pos", cache_pos),
                    ("positions", positions)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"spec_verify: {name} is not on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"spec_verify: {name} is not contiguous")


def spec_verify_attention_cuda(q, k, v, cache_pos, positions, *,
                               window: int = 0,
                               softcap: float = 0.0) -> torch.Tensor:
    """Launch the CUDA kernel (CUDA tensors only). At a head dim that no
    kernel is built for (24, 40: the examples' tiny models) q and the
    whole K and V ring are zero-padded to ``padded_head_dim`` at every
    launch, a copy of the ring beside the kernel that ``work()`` does not
    count; a config at such a head dim would allocate its cache padded
    instead."""
    global LAUNCHES
    hd_real = q.shape[-1]
    hd_run = padded_head_dim(hd_real)
    if hd_run != hd_real:
        q, k, v = (torch.nn.functional.pad(t, (0, hd_run - hd_real))
                   for t in (q, k, v))
    _check(q, k, v, cache_pos, positions)
    B, T, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    lib = _build.load("spec_verify", _SIGNATURES)
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), cache_pos.data_ptr(),
            positions.data_ptr(), out.data_ptr())
    shape = (B, T, Hq, Hkv, S, hd, int(window), float(softcap),
             float(1.0 / hd_real ** 0.5))
    bf16 = q.dtype == torch.bfloat16
    n_sm = _sm_count(q.device)
    plan = (split_plan if bf16 else f32_split_plan)(B, T, Hq, Hkv, S, hd,
                                                    n_sm)
    part = torch.empty(plan.partial_floats(B, Hkv, T * (Hq // Hkv), hd),
                       dtype=torch.float32, device=q.device)
    cut = () if bf16 else (plan.cta_rows // 8, plan.row_blocks)
    err = getattr(lib, _ENTRY[q.dtype])(
        *ptrs, part.data_ptr() or None, *shape, plan.tile, plan.n_split,
        plan.tiles_per_split, *cut, _build.cuda_stream_ptr(q.device))
    _build.check(err, "spec_verify_attention launch")
    LAUNCHES += 1
    return out if hd_run == hd_real else out[..., :hd_real].contiguous()


def work(B: int, T: int, Hq: int, Hkv: int, S1: int, hd: int,
         esz: int) -> Tuple[float, float]:
    """(flops, bytes) of one launch from shapes alone: q read and the
    output written once, cache_pos and positions once, K and V of every
    slot once; QKᵀ and PV over every (row, slot) pair. A meta tensor has no
    cache_pos values, so every slot counts as valid and visible: the most
    the kernel reads at this shape (a ring filled past its size, as the
    dry run's 32k context). ``chip_smoke.sv_bound_ms`` takes off the
    slots a real cache_pos leaves out."""
    nbytes = (2 * B * T * Hq * hd * esz + 4 * B * S1 + 4 * B * T
              + 2 * B * S1 * Hkv * hd * esz)
    return 4.0 * B * T * S1 * Hq * hd, float(nbytes)


def spec_verify_attention(q, k, v, cache_pos, positions, *,
                          window: int = 0,
                          softcap: float = 0.0) -> torch.Tensor:
    """(B, T, Hq, hd) attention of the draft block against the ring
    cache: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors; for meta tensors an output of the shape, nothing launched,
    and the kernel's ``work`` reported (``kernels.work``)."""
    if q.is_cuda:
        return spec_verify_attention_cuda(
            q, k, v, cache_pos, positions, window=window, softcap=softcap
        )
    if q.is_meta:
        B, T, Hq, hd = q.shape
        _work.report("spec_verify_attention",
                     *work(B, T, Hq, k.shape[2], k.shape[1], hd,
                           q.element_size()))
        return torch.empty_like(q)
    return spec_verify_attention_ref(
        q, k, v, cache_pos, positions, window=window, softcap=softcap
    )
