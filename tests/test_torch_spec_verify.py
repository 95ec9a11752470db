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


# ---- split-KV: the bfloat16 kernel's plan and combine ----------------------

# (B, T, Hq, Hkv, S+1, hd): Qwen3-8B's and RecurrentGemma-9B's main-path
# shapes, small shapes, T = 1, B = 1, a G that is no power of two and a
# ring longer than one split may stage
PLAN_SHAPES = [
    (8, 17, 32, 8, 577, 128),
    (8, 17, 16, 1, 2113, 256),
    (2, 9, 8, 2, 257, 64),
    (2, 4, 12, 2, 300, 64),
    (8, 1, 32, 8, 577, 128),
    (8, 1, 16, 1, 2113, 256),
    (1, 17, 16, 1, 2113, 256),
    (1, 1, 4, 4, 129, 32),
    (1, 17, 32, 8, 20000, 128),
]
MAIN_SHAPES = PLAN_SHAPES[:2]


@pytest.mark.parametrize("B,T,Hq,Hkv,S1,hd", PLAN_SHAPES)
def test_split_plan_covers_every_row_and_slot_once(B, T, Hq, Hkv, S1, hd):
    plan = sv_ops.split_plan(B, T, Hq, Hkv, S1, hd, n_sm=132)
    assert plan == sv_ops.split_plan(B, T, Hq, Hkv, S1, hd, n_sm=132)
    TG = T * (Hq // Hkv)
    assert plan.tile == (32 if hd > 128 else 64)
    assert plan.n_tiles * plan.tile >= S1 > (plan.n_tiles - 1) * plan.tile
    rows = plan.row_ranges(TG)
    assert len(rows) == plan.row_blocks
    for lo, hi in rows:
        assert 0 < hi - lo <= plan.cta_rows
    # splits own whole tiles by index (fixed in slot space), none is
    # empty of tiles or holds more than a split may stage
    assert 1 <= plan.n_split <= plan.n_tiles
    for j in range(plan.n_split):
        owned = plan.split_slots(j, S1)
        assert 0 < len(owned) <= plan.tiles_per_split
        assert len(owned) * plan.tile <= sv_ops.SPLIT_SLOTS_MAX
        assert all(lo % plan.tile == 0 and lo < hi for lo, hi in owned)
    # every (b, kv head, row, slot) belongs to exactly one CTA
    cover = np.zeros((B, Hkv, TG, S1), np.uint8)
    for b in range(B):
        for h in range(Hkv):
            for r_lo, r_hi in rows:
                for j in range(plan.n_split):
                    for s_lo, s_hi in plan.split_slots(j, S1):
                        cover[b, h, r_lo:r_hi, s_lo:s_hi] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("B,T,Hq,Hkv,S1,hd", MAIN_SHAPES)
def test_split_plan_partials_stay_below_the_kv_bytes(B, T, Hq, Hkv, S1, hd):
    plan = sv_ops.split_plan(B, T, Hq, Hkv, S1, hd, n_sm=132)
    assert plan.n_split > 1  # the card is filled by splits at these shapes
    assert B * Hkv * plan.row_blocks * plan.n_split <= 132
    part_bytes = 4 * plan.partial_floats(B, Hkv, T * (Hq // Hkv), hd)
    kv_bytes = 2 * B * S1 * Hkv * hd * 2
    assert part_bytes <= kv_bytes / 2


def _plain_partials(q, k, v, cpos, pos, slots, window, softcap):
    """What one split's CTA writes, in plain float32: per (b, kv head, g,
    t) row over the ring slots ``slots`` (an index array), m (NEG where
    the row sees nothing there), l and acc (P rounded to the input type
    before P.V, as the kernel does)."""
    from repro_torch.kernels.spec_verify.ref import NEG

    B, T, Hq, hd = q.shape
    Hkv = k.shape[2]
    qg = q.float().reshape(B, T, Hkv, Hq // Hkv, hd)
    s = torch.einsum("btkgh,bskh->bkgts", qg, k[:, slots].float()) / hd ** 0.5
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    cp, qp = cpos[:, None, slots], pos[:, :, None]
    mask = (cp >= 0) & (cp <= qp)
    if window > 0:
        mask &= cp > qp - window
    mask = mask[:, None, None]
    s = torch.where(mask, s, NEG)
    m = s.max(dim=-1).values
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    acc = torch.einsum("bkgts,bskh->bkgth", p.to(q.dtype).float(),
                       v[:, slots].float())
    return m, p.sum(dim=-1), acc


# (B, T, Hq, Hkv, hd, S+1, window, softcap, cache lengths [lo, hi),
# whether some split is empty for every row)
MERGE_CASES = [
    (2, 5, 8, 2, 64, 257, 0, 0.0, (20, 50), True),
    (2, 9, 8, 2, 64, 257, 0, 30.0, (100, 240), False),
    (3, 4, 12, 2, 64, 300, 100, 0.0, (150, 290), True),
    (2, 3, 16, 1, 256, 300, 64, 0.0, (40, 280), False),
    (2, 3, 16, 1, 256, 300, 0, 0.0, (4, 20), True),
]


def _ring_inputs(B, T, Hq, Hkv, hd, S1, lengths_range, seed):
    """Ring caches holding positions [0, len_b + T) with the block's
    queries at len_b .. len_b + T - 1; query 0 of row 1 is blinded
    (position -1: it sees no slot)."""
    rng = np.random.default_rng(seed)
    S = S1 - 1
    q = rng.normal(size=(B, T, Hq, hd)).astype(np.float32)
    k = rng.normal(size=(B, S1, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, S1, Hkv, hd)).astype(np.float32)
    lengths = rng.integers(*lengths_range, size=B)
    cpos = np.full((B, S1), -1, np.int32)
    for b in range(B):
        for p in range(lengths[b] + T):
            cpos[b, p % S] = p
    positions = (lengths[:, None] + np.arange(T)[None]).astype(np.int32)
    positions[1, 0] = -1
    return q, k, v, cpos, positions


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,T,Hq,Hkv,hd,S1,window,softcap,lengths,empty_split", MERGE_CASES)
def test_merged_split_partials_equal_unsplit_plain_and_jax(
        B, T, Hq, Hkv, hd, S1, window, softcap, lengths, empty_split, dtype):
    from repro_torch.kernels.spec_verify.ref import NEG, combine_partials_ref

    arrs = _ring_inputs(B, T, Hq, Hkv, hd, S1, lengths, seed=B + hd)
    targs = [_torch(a, dtype) for a in arrs]
    plan = sv_ops.split_plan(B, T, Hq, Hkv, S1, hd, n_sm=132)
    assert plan.n_split > 1
    parts = [_plain_partials(*targs, torch.cat([torch.arange(lo, hi) for lo, hi
                                                in plan.split_slots(j, S1)]),
                             window, softcap)
             for j in range(plan.n_split)]
    m, l, acc = (torch.stack(x) for x in zip(*parts))
    # where the cache ends early, some split is empty for every row
    assert bool((m <= NEG).all(dim=(1, 2, 3, 4)).any()) == empty_split
    merged = combine_partials_ref(m, l, acc)  # (B, Hkv, G, T, hd)
    got = merged.permute(0, 3, 1, 2, 4).reshape(B, T, Hq, hd)
    got = got.to(targs[0].dtype).float().numpy()
    assert (got[1, 0] == 0).all()  # the blinded query
    unsplit = spec_verify_attention_ref(*targs, window=window,
                                        softcap=softcap).float().numpy()
    assert (unsplit[1, 0] == 0).all()
    jargs = [jnp.asarray(a, dtype) if a.dtype == np.float32 else jnp.asarray(a)
             for a in arrs]
    want_kernel = np.asarray(
        jax_kernel(*jargs, window=window, softcap=softcap, chunk=128,
                   interpret=True), np.float32)
    np.testing.assert_allclose(got, unsplit, **_tol(dtype))
    np.testing.assert_allclose(got, want_kernel, **_tol(dtype))
    np.testing.assert_allclose(unsplit, want_kernel, **_tol(dtype))


# bf16 edge cases of the split kernel, on the card: (B, T, Hq, Hkv, hd,
# S+1, window, softcap, cache lengths [lo, hi)); queries blinded as in
# _ring_inputs
EDGE_CASES = [
    (8, 1, 32, 8, 128, 577, 0, 0.0, (128, 560)),        # T = 1
    (4, 5, 8, 2, 128, 300, 0, 0.0, (20, 290)),          # a row sees nothing
    (8, 17, 16, 1, 256, 2113, 2048, 0.0, (1, 12)),      # one live split
    (2, 9, 8, 2, 64, 257, 0, 0.0, (1, 240)),            # hd 64
    (2, 17, 8, 4, 128, 513, 0, 30.0, (1, 490)),         # softcap
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,Hq,Hkv,hd,S1,window,softcap,lengths",
                         EDGE_CASES)
def test_cuda_kernel_edge_cases_match_plain(B, T, Hq, Hkv, hd, S1, window,
                                            softcap, lengths):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    targs = [_torch(a, "bfloat16").cuda() for a in
             _ring_inputs(B, T, Hq, Hkv, hd, S1, lengths, seed=7)]
    got = sv_ops.spec_verify_attention_cuda(*targs, window=window,
                                            softcap=softcap)
    want = spec_verify_attention_ref(*targs, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert (got[1, 0] == 0).all()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **_tol("bfloat16"))
