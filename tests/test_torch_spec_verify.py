"""Spec-verify attention: the port's plain version against the JAX
package's Pallas kernel (interpret mode) and its jnp reference, on the
parametrised cases of tests/test_kernels.py (GQA, MQA, window, softcap,
float32 and bfloat16), and at RecurrentGemma's head_dim 256 with 16-way
MQA and a window. Tolerances as there: atol 3e-5 (float32) / 3e-2
(bfloat16), rtol 1e-2 — the summation order and the bfloat16 rounding
points differ between the frameworks. Both kernels' split plans are held
to covering every slot once, the float32 one also to not moving with the
batch, and partials merged in a plan's split order to the unsplit plain
version and the JAX kernel. The CUDA kernels are held against the plain
version in the ``gpu`` tests (and in ``chip_smoke.py``), the float32
kernel also to its batch invariance, bit for bit, and at head dims the
wrapper zero-pads to a built one.
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


# the examples' head layouts the wrapper pads: 4/2 heads of 24, 8/4 of 40
PADDED_CASES = [(2, 1, 4, 2, 24, 129, 0, 0.0, "float32"),
                (2, 5, 4, 2, 24, 129, 0, 0.0, "bfloat16"),
                (2, 9, 8, 4, 40, 257, 0, 0.0, "float32")]


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,Hq,Hkv,hd,S,window,softcap,dtype",
                         CASES + PADDED_CASES)
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


@pytest.mark.parametrize("hd,want", [(24, 32), (32, 32), (40, 64), (64, 64),
                                     (96, 128), (200, 256), (256, 256)])
def test_padded_head_dim(hd, want):
    """A head dim the kernels are not built for runs at the next one
    (zero columns): the examples' 24 at 32, the 10m preset's 40 at 64."""
    assert sv_ops.padded_head_dim(hd) == want
    assert want in sv_ops.HEAD_DIMS


def test_padded_head_dim_refuses_above_the_largest():
    with pytest.raises(ValueError, match="above 256"):
        sv_ops.padded_head_dim(320)


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


# the float32 kernel's plan at PLAN_SHAPES and Qwen2-1.5B's float32 shape
# in 10c (B 4, T 17, 12/2 heads, S+1 129)
F32_PLAN_SHAPES = PLAN_SHAPES + [(4, 17, 12, 2, 129, 128)]


@pytest.mark.parametrize("B,T,Hq,Hkv,S1,hd", F32_PLAN_SHAPES)
def test_f32_split_plan_covers_every_slot_once_whatever_the_batch(
        B, T, Hq, Hkv, S1, hd):
    plan = sv_ops.f32_split_plan(B, T, Hq, Hkv, S1, hd, n_sm=132)
    assert plan.tile == (32 if hd > 128 else 64)
    assert plan.n_tiles * plan.tile >= S1 > (plan.n_tiles - 1) * plan.tile
    assert 1 <= plan.n_split <= min(plan.n_tiles, 132)
    assert plan.tiles_per_split == -(-plan.n_tiles // plan.n_split)
    # the split is fixed by S+1, hd and the SM count: the same for any B
    # and T (a row's float32 output does not depend on the batch)
    split = (plan.tile, plan.n_tiles, plan.n_split, plan.tiles_per_split)
    for b in (1, 4, 8):
        for t in (1, 17):
            other = sv_ops.f32_split_plan(b, t, Hq, Hkv, S1, hd, n_sm=132)
            assert (other.tile, other.n_tiles, other.n_split,
                    other.tiles_per_split) == split
            # the rows' cut follows the batch: whole warps of 8 rows, every
            # row once
            rows = other.row_ranges(t * (Hq // Hkv))
            assert other.cta_rows % 8 == 0
            assert other.cta_rows <= 8 * sv_ops.F32_WARPS_MAX[hd]
            assert rows[0][0] == 0 and rows[-1][1] == t * (Hq // Hkv)
            assert all(r[1] == n[0] for r, n in zip(rows, rows[1:]))
    # every slot belongs to exactly one split
    cover = np.zeros(S1, np.uint8)
    for j in range(plan.n_split):
        owned = plan.split_slots(j, S1)
        assert 0 < len(owned) <= plan.tiles_per_split
        for lo, hi in owned:
            cover[lo:hi] += 1
    assert (cover == 1).all()


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


# whether some split is empty for every row under the float32 kernel's
# plan (f32_split_plan), case by case
MERGE_F32_PLAN_EMPTY = [True, False, False, False, True]


def _merge_params():
    """MERGE_CASES in both types under the bfloat16 kernel's plan
    (``split_plan``), and in float32 under the float32 kernel's
    (``f32_split_plan``)."""
    out = []
    for i, case in enumerate(MERGE_CASES):
        head = "-".join(map(str, case[:8])) + f"-lengths{i}"
        for dtype in ("float32", "bfloat16"):
            out.append(pytest.param(*case, dtype, "split_plan",
                                    id=f"{head}-{case[9]}-{dtype}"))
        empty = MERGE_F32_PLAN_EMPTY[i]
        out.append(pytest.param(*case[:9], empty, "float32", "f32_split_plan",
                                id=f"{head}-{empty}-float32-f32_split_plan"))
    return out


@pytest.mark.parametrize(
    "B,T,Hq,Hkv,hd,S1,window,softcap,lengths,empty_split,dtype,plan_of",
    _merge_params())
def test_merged_split_partials_equal_unsplit_plain_and_jax(
        B, T, Hq, Hkv, hd, S1, window, softcap, lengths, empty_split, dtype,
        plan_of):
    from repro_torch.kernels.spec_verify.ref import NEG, combine_partials_ref

    arrs = _ring_inputs(B, T, Hq, Hkv, hd, S1, lengths, seed=B + hd)
    targs = [_torch(a, dtype) for a in arrs]
    plan = getattr(sv_ops, plan_of)(B, T, Hq, Hkv, S1, hd, n_sm=132)
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


# edge cases of the split kernels, on the card: (B, T, Hq, Hkv, hd, S+1,
# window, softcap, cache lengths [lo, hi), dtype); queries blinded as in
# _ring_inputs
EDGE_CASES = [
    (8, 1, 32, 8, 128, 577, 0, 0.0, (128, 560), "bfloat16"),      # T = 1
    (4, 5, 8, 2, 128, 300, 0, 0.0, (20, 290), "bfloat16"),  # a row sees nothing
    (8, 17, 16, 1, 256, 2113, 2048, 0.0, (1, 12), "bfloat16"),  # one live split
    (2, 9, 8, 2, 64, 257, 0, 0.0, (1, 240), "bfloat16"),          # hd 64
    (2, 17, 8, 4, 128, 513, 0, 30.0, (1, 490), "bfloat16"),       # softcap
    (8, 1, 32, 8, 128, 577, 0, 0.0, (128, 560), "float32"),       # T = 1
    (4, 5, 8, 2, 128, 300, 0, 0.0, (20, 290), "float32"),   # a row sees nothing
    (2, 2, 16, 1, 32, 70, 0, 0.0, (1, 60), "float32"),            # hd 32, G 16
    (2, 9, 8, 2, 64, 257, 0, 0.0, (1, 240), "float32"),           # hd 64
    (2, 5, 16, 1, 256, 300, 160, 0.0, (100, 290), "float32"),     # hd 256, window
    (8, 17, 16, 1, 256, 2113, 2048, 0.0, (1, 12), "float32"),     # one live split
    (2, 4, 12, 2, 64, 300, 100, 0.0, (1, 290), "float32"),        # G = 6
    (2, 17, 16, 1, 128, 577, 0, 0.0, (100, 560), "float32"),      # G = 16
    (2, 17, 8, 4, 128, 513, 0, 30.0, (1, 490), "float32"),        # softcap
    (1, 17, 32, 8, 128, 20000, 0, 0.0, (15000, 19980), "float32"),  # long ring
    (8, 17, 32, 8, 128, 577, 0, 0.0, (128, 513), "float32"),      # 10b's shape
    (4, 17, 12, 2, 128, 129, 0, 0.0, (8, 80), "float32"),         # 10c's shape
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,Hq,Hkv,hd,S1,window,softcap,lengths,dtype",
                         EDGE_CASES)
def test_cuda_kernel_edge_cases_match_plain(B, T, Hq, Hkv, hd, S1, window,
                                            softcap, lengths, dtype):
    _card()
    targs = [_torch(a, dtype).cuda() for a in
             _ring_inputs(B, T, Hq, Hkv, hd, S1, lengths, seed=7)]
    got = sv_ops.spec_verify_attention_cuda(*targs, window=window,
                                            softcap=softcap)
    want = spec_verify_attention_ref(*targs, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert (got[1, 0] == 0).all()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,Hq,Hkv,hd,S1,lengths", [
    (8, 17, 32, 8, 128, 577, (128, 513)),   # 10b's shape
    (4, 17, 12, 2, 128, 129, (8, 80)),      # 10c's shape
])
def test_cuda_f32_kernel_is_batch_invariant(B, T, Hq, Hkv, hd, S1, lengths):
    """Bit for bit: a launch equals the same rows launched as two half
    batches and as T = 1 launches of each query, and a row's output is
    unchanged when the other rows' queries and positions are redrawn."""
    _card()
    q, k, v, cpos, pos = [_torch(a, "float32").cuda() for a in
                          _ring_inputs(B, T, Hq, Hkv, hd, S1, lengths,
                                       seed=11)]
    run = sv_ops.spec_verify_attention_cuda
    full = run(q, k, v, cpos, pos)
    h = B // 2
    halves = torch.cat([run(q[:h], k[:h], v[:h], cpos[:h], pos[:h]),
                        run(q[h:], k[h:], v[h:], cpos[h:], pos[h:])])
    singles = torch.cat([run(q[:, t:t + 1].contiguous(), k, v, cpos,
                             pos[:, t:t + 1].contiguous())
                         for t in range(T)], dim=1)
    q2, pos2 = q.clone(), pos.clone()
    q2[:, 1:] = torch.randn_like(q2[:, 1:])
    pos2[:, 1:] = pos[:, 1:].flip(1) - 7
    redrawn = run(q2, k, v, cpos, pos2)
    torch.cuda.synchronize()
    assert torch.equal(full, halves)
    assert torch.equal(full, singles)
    assert torch.equal(full[:, 0], redrawn[:, 0])
