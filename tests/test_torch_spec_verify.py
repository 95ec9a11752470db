"""Spec-verify attention: the port's plain version against the JAX
package's Pallas kernel (interpret mode) and its jnp reference, on the
parametrised cases of tests/test_kernels.py (GQA, MQA, window, softcap,
float32 and bfloat16), and at RecurrentGemma's head_dim 256 with 16-way
MQA and a window. Tolerances as there: atol 3e-5 (float32) / 3e-2
(bfloat16), rtol 1e-2 — the summation order and the bfloat16 rounding
points differ between the frameworks. The CUDA kernel is held against
the plain version in the ``gpu`` test (and in ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.spec_verify import (
    spec_verify_attention as jax_kernel,
    spec_verify_attention_ref as jax_ref,
)
from repro_torch.kernels.spec_verify import ops as sv_ops
from repro_torch.kernels.spec_verify.ref import spec_verify_attention_ref

CASES = [
    (2, 9, 8, 2, 64, 257, 0, 0.0, "float32"),
    (1, 1, 4, 4, 128, 129, 0, 0.0, "float32"),
    (3, 5, 6, 2, 64, 130, 48, 0.0, "float32"),
    (2, 17, 8, 4, 128, 513, 0, 30.0, "bfloat16"),
    (2, 4, 12, 2, 64, 300, 100, 0.0, "bfloat16"),
    (1, 2, 16, 1, 32, 70, 0, 0.0, "float32"),  # MQA
    # RecurrentGemma's attention: head_dim 256, MQA with 16 query heads
    (2, 17, 16, 1, 256, 300, 100, 0.0, "bfloat16"),
    (1, 3, 16, 1, 256, 130, 48, 0.0, "float32"),
]


def _cache_pos(rng, B, S):
    lengths = rng.integers(1, S - 1, size=B)
    cpos = np.full((B, S), -1, np.int64)
    for b in range(B):
        for pos in range(max(0, lengths[b] - (S - 1)), lengths[b]):
            cpos[b, pos % (S - 1)] = pos
    return lengths, cpos


def _inputs(B, T, Hq, Hkv, hd, S, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, Hq, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, hd)).astype(np.float32)
    lengths, cpos = _cache_pos(rng, B, S)
    positions = lengths[:, None] + np.arange(T)[None]
    return q, k, v, cpos.astype(np.int32), positions.astype(np.int32)


def _torch(a, dtype):
    t = torch.from_numpy(a)
    return t.to(getattr(torch, dtype)) if t.is_floating_point() else t


def _tol(dtype):
    return dict(atol=3e-2 if dtype == "bfloat16" else 3e-5, rtol=1e-2)


@pytest.mark.parametrize("B,T,Hq,Hkv,hd,S,window,softcap,dtype", CASES)
def test_plain_matches_jax_kernel_and_ref(B, T, Hq, Hkv, hd, S, window,
                                          softcap, dtype):
    arrs = _inputs(B, T, Hq, Hkv, hd, S)
    jargs = [jnp.asarray(a, dtype) if a.dtype == np.float32 else jnp.asarray(a)
             for a in arrs]
    want_kernel = np.asarray(
        jax_kernel(*jargs, window=window, softcap=softcap, chunk=128,
                   interpret=True), np.float32)
    want_ref = np.asarray(
        jax_ref(*jargs, window=window, softcap=softcap), np.float32)
    targs = [_torch(a, dtype) for a in arrs]
    got = sv_ops.spec_verify_attention(*targs, window=window, softcap=softcap)
    assert got.dtype == targs[0].dtype and got.shape == targs[0].shape
    got = got.float().numpy()
    np.testing.assert_allclose(got, want_kernel, **_tol(dtype))
    np.testing.assert_allclose(got, want_ref, **_tol(dtype))


def test_cpu_wrapper_runs_the_plain_version_without_launching():
    arrs = _inputs(1, 3, 4, 2, 32, 40)
    before = sv_ops.LAUNCHES
    out = sv_ops.spec_verify_attention(*[_torch(a, "float32") for a in arrs])
    assert sv_ops.LAUNCHES == before and torch.isfinite(out).all()


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,Hq,Hkv,hd,S,window,softcap,dtype", CASES)
def test_cuda_kernel_matches_plain(B, T, Hq, Hkv, hd, S, window, softcap,
                                   dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    targs = [_torch(a, dtype).cuda()
             for a in _inputs(B, T, Hq, Hkv, hd, S)]
    got = sv_ops.spec_verify_attention_cuda(*targs, window=window,
                                            softcap=softcap)
    want = spec_verify_attention_ref(*targs, window=window, softcap=softcap)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **_tol(dtype))
