"""Wrapper of the spec-verify attention kernel (``csrc/spec_verify.cu``).

For CUDA tensors it checks what the kernel takes, allocates the output
and launches on the current stream; for CPU tensors it runs the plain
version (``ref.py``). There is no fallback between the two: a CUDA
tensor the kernel cannot take raises.

Unlike the TPU wrapper it pads nothing: the kernel reads queries in the
model's ``(B, T, Hq, hd)`` layout and regroups them per kv head itself
(rows ``t*G + g``), and masks the ragged end of the cache.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.spec_verify.ref import spec_verify_attention_ref

# Launches of the CUDA kernel by this wrapper (one per call on CUDA).
LAUNCHES = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float,
        ctypes.c_float, _P)
_SIGNATURES = {"spec_verify_attention_f32": _SIG,
               "spec_verify_attention_bf16": _SIG}
_ENTRY = {torch.float32: "spec_verify_attention_f32",
          torch.bfloat16: "spec_verify_attention_bf16"}


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
    if hd not in (32, 64, 128, 256):
        raise ValueError(f"spec_verify: head_dim {hd} not in (32, 64, 128, "
                         "256)")
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
    """Launch the CUDA kernel (CUDA tensors only)."""
    global LAUNCHES
    _check(q, k, v, cache_pos, positions)
    B, T, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    lib = _build.load("spec_verify", _SIGNATURES)
    out = torch.empty_like(q)
    err = getattr(lib, _ENTRY[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), cache_pos.data_ptr(),
        positions.data_ptr(), out.data_ptr(),
        B, T, Hq, Hkv, S, hd, int(window), float(softcap),
        float(1.0 / hd ** 0.5), _build.cuda_stream_ptr(q.device),
    )
    _build.check(err, "spec_verify_attention launch")
    LAUNCHES += 1
    return out


def spec_verify_attention(q, k, v, cache_pos, positions, *,
                          window: int = 0,
                          softcap: float = 0.0) -> torch.Tensor:
    """(B, T, Hq, hd) attention of the draft block against the ring
    cache: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if q.is_cuda:
        return spec_verify_attention_cuda(
            q, k, v, cache_pos, positions, window=window, softcap=softcap
        )
    return spec_verify_attention_ref(
        q, k, v, cache_pos, positions, window=window, softcap=softcap
    )
