"""Wrapper of the RG-LRU scan kernel (``csrc/rglru.cu``).

For CUDA tensors it checks what the kernel takes, allocates the outputs
and launches on the current stream; for CPU tensors it runs the plain
version (``ref.py``). There is no fallback between the two: a CUDA
tensor the kernel cannot take raises.

Unlike the TPU wrapper it precomputes and pads nothing: the kernel forms
log a and i·x from x, r and i on the chip, masks the ragged width, and
takes the optional (B, T) update mask of the model's scan.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru.ref import rglru_scan_ref

# Launches of the CUDA kernel by this wrapper (one per call on CUDA), in
# all and by (B, T): verify blocks and prefills have different shapes.
LAUNCHES = 0
LAUNCHES_BY_SHAPE: Counter = Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"rglru_scan_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                  _P)}


def _check(x, r, i, lam, h0, mask) -> None:
    if x.dim() != 3 or r.shape != x.shape or i.shape != x.shape:
        raise ValueError(f"rglru_scan: x {tuple(x.shape)}, r {tuple(r.shape)}"
                         f", i {tuple(i.shape)} must be one (B, T, W) shape")
    B, T, W = x.shape
    if B < 1 or W < 1:
        raise ValueError(f"rglru_scan: empty shape {tuple(x.shape)}")
    if tuple(lam.shape) != (W,) or tuple(h0.shape) != (B, W):
        raise ValueError(f"rglru_scan: lam {tuple(lam.shape)} must be ({W},)"
                         f", h0 {tuple(h0.shape)} must be ({B}, {W})")
    tensors = [("x", x), ("r", r), ("i", i), ("lam", lam), ("h0", h0)]
    for name, t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"rglru_scan: {name} is {t.dtype}, not float32")
    if mask is not None:
        if tuple(mask.shape) != (B, T) or mask.dtype != torch.bool:
            raise ValueError(f"rglru_scan: mask must be ({B}, {T}) bool, is "
                             f"{tuple(mask.shape)} {mask.dtype}")
        tensors.append(("mask", mask))
    for name, t in tensors:
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"rglru_scan: {name} is not on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"rglru_scan: {name} is not contiguous")


def rglru_scan_cuda(x, r, i, lam, h0, mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel (CUDA tensors only)."""
    global LAUNCHES
    _check(x, r, i, lam, h0, mask)
    B, T, W = x.shape
    lib = _build.load("rglru", _SIGNATURES)
    hs = torch.empty_like(x)
    h_final = torch.empty_like(h0)
    err = lib.rglru_scan_f32(
        x.data_ptr(), r.data_ptr(), i.data_ptr(), lam.data_ptr(),
        h0.data_ptr(), None if mask is None else mask.data_ptr(),
        hs.data_ptr(), h_final.data_ptr(), B, T, W,
        _build.cuda_stream_ptr(x.device),
    )
    _build.check(err, "rglru_scan launch")
    LAUNCHES += 1
    LAUNCHES_BY_SHAPE[(B, T)] += 1
    return hs, h_final


def rglru_scan(x, r, i, lam, h0, mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hs (B, T, W), h_final (B, W)) of the RG-LRU recurrence over x, r,
    i (B, T, W) float32 from h0 (B, W), steps where ``mask`` (B, T) is
    False keeping h: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if x.is_cuda:
        return rglru_scan_cuda(x, r, i, lam, h0, mask)
    return rglru_scan_ref(x, r, i, lam, h0, mask)
