"""Wrappers of the RG-LRU scan kernel (``csrc/rglru.cu``) and of its
backward (``csrc/rglru_bwd.cu``), and the autograd function that joins
them.

For CUDA tensors each wrapper checks what its kernel takes, allocates the
outputs and launches on the current stream; for CPU tensors it runs the
plain version (``ref.py``). There is no fallback between the two: a CUDA
tensor a kernel cannot take raises.

Unlike the TPU wrapper it precomputes and pads nothing: the kernel forms
log a and i·x from x, r and i on the chip, masks the ragged width, and
takes the optional (B, T) update mask of the model's scan.

``rglru_scan`` is what the model calls. Where autograd records (grad
enabled and an input that requires grad) it goes through ``RGLRUScan``,
whose backward is the backward kernel (its plain version on the CPU);
otherwise it calls the forward alone, as rollouts under
``inference_mode`` do.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru.ref import rglru_scan_bwd_ref, rglru_scan_ref

# Launches of the CUDA kernels by these wrappers (one per call on CUDA), in
# all and by (B, T): verify blocks and prefills have different shapes.
LAUNCHES = 0
LAUNCHES_BY_SHAPE: Counter = Counter()
BWD_LAUNCHES = 0
BWD_LAUNCHES_BY_SHAPE: Counter = Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"rglru_scan_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                  _P)}
_BWD_SIGNATURES = {"rglru_scan_bwd_f32": (_P,) * 15 + (_I, _I, _I, _P)}


def _check(x, r, i, lam, h0, mask, what="rglru_scan", **more) -> None:
    """Shapes, float32, one CUDA device, contiguity; ``more`` are further
    float32 tensors of shape (B, T, W) (``hs``, ``dhs``) or (B, W)
    (``dh_final``), named by their keywords."""
    if x.dim() != 3 or r.shape != x.shape or i.shape != x.shape:
        raise ValueError(f"{what}: x {tuple(x.shape)}, r {tuple(r.shape)}"
                         f", i {tuple(i.shape)} must be one (B, T, W) shape")
    B, T, W = x.shape
    if B < 1 or W < 1:
        raise ValueError(f"{what}: empty shape {tuple(x.shape)}")
    if tuple(lam.shape) != (W,) or tuple(h0.shape) != (B, W):
        raise ValueError(f"{what}: lam {tuple(lam.shape)} must be ({W},)"
                         f", h0 {tuple(h0.shape)} must be ({B}, {W})")
    tensors = [("x", x), ("r", r), ("i", i), ("lam", lam), ("h0", h0),
               *more.items()]
    for name, t in more.items():
        want = (B, W) if name == "dh_final" else (B, T, W)
        if tuple(t.shape) != want:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} must be "
                             f"{want}")
    for name, t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} is {t.dtype}, not float32")
    if mask is not None:
        if tuple(mask.shape) != (B, T) or mask.dtype != torch.bool:
            raise ValueError(f"{what}: mask must be ({B}, {T}) bool, is "
                             f"{tuple(mask.shape)} {mask.dtype}")
        tensors.append(("mask", mask))
    for name, t in tensors:
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{what}: {name} is not on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")


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


def rglru_scan_bwd_cuda(x, r, i, lam, h0, hs, dhs, dh_final,
                        mask: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, ...]:
    """Launch the backward kernel (CUDA tensors only): (dx, dr, di, dlam,
    dh0), as ``rglru_scan_bwd_ref`` computes them."""
    global BWD_LAUNCHES
    _check(x, r, i, lam, h0, mask, "rglru_scan_bwd", hs=hs, dhs=dhs,
           dh_final=dh_final)
    B, T, W = x.shape
    lib = _build.load("rglru_bwd", _BWD_SIGNATURES)
    dx, dr, di = (torch.empty_like(x) for _ in range(3))
    dlam = torch.empty_like(lam)
    dh0 = torch.empty_like(h0)
    dab = torch.empty_like(h0)  # per-row sums of dΛ, reduced in order
    err = lib.rglru_scan_bwd_f32(
        *(t.data_ptr() for t in (x, r, i, lam, h0, hs, dhs, dh_final)),
        None if mask is None else mask.data_ptr(),
        *(t.data_ptr() for t in (dx, dr, di, dlam, dh0, dab)), B, T, W,
        _build.cuda_stream_ptr(x.device),
    )
    _build.check(err, "rglru_scan_bwd launch")
    BWD_LAUNCHES += 1
    BWD_LAUNCHES_BY_SHAPE[(B, T)] += 1
    return dx, dr, di, dlam, dh0


def rglru_scan_bwd(x, r, i, lam, h0, hs, dhs, dh_final,
                   mask: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, ...]:
    """The scan's backward: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if x.is_cuda:
        return rglru_scan_bwd_cuda(x, r, i, lam, h0, hs, dhs, dh_final, mask)
    return rglru_scan_bwd_ref(x, r, i, lam, h0, hs, dhs, dh_final, mask)


def _scan_fwd(x, r, i, lam, h0, mask):
    if x.is_cuda:
        return rglru_scan_cuda(x, r, i, lam, h0, mask)
    return rglru_scan_ref(x, r, i, lam, h0, mask)


class RGLRUScan(torch.autograd.Function):
    """The scan under autograd: the forward launch, then the backward
    launch from the saved x, r, i, Λ, h0, hs and mask (no recompute)."""

    @staticmethod
    def forward(ctx, x, r, i, lam, h0, mask):
        hs, h_final = _scan_fwd(x, r, i, lam, h0, mask)
        ctx.save_for_backward(x, r, i, lam, h0, hs, mask)
        return hs, h_final

    @staticmethod
    def backward(ctx, dhs, dh_final):
        x, r, i, lam, h0, hs, mask = ctx.saved_tensors
        grads = rglru_scan_bwd(x, r, i, lam, h0, hs, dhs.contiguous(),
                               dh_final.contiguous(), mask)
        return (*grads, None)


def rglru_scan(x, r, i, lam, h0, mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hs (B, T, W), h_final (B, W)) of the RG-LRU recurrence over x, r,
    i (B, T, W) float32 from h0 (B, W), steps where ``mask`` (B, T) is
    False keeping h: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors; differentiable through ``RGLRUScan`` where autograd
    records."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, r, i, lam, h0)):
        return RGLRUScan.apply(x, r, i, lam, h0, mask)
    return _scan_fwd(x, r, i, lam, h0, mask)
