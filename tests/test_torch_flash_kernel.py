"""The flash attention kernels' package (``kernels/flash``): the wrappers
on the CPU and on meta tensors, the kernels' tile skipping and launch
plans, and a model of their backward's decomposition.

* on the CPU the wrapper returns the plain version's bits, and the plain
  version (``ref.py``) equals the JAX package's ``_flash`` forward and its
  ``jax.vjp`` (B 2, S 500 chunk-padded, 2/4 heads of 16, windows 0 and
  65, left pads) on the same numpy inputs: atol 3e-5, rtol 1e-4 forward
  and atol 1e-4, rtol 1e-3 for the gradients (``tests/test_torch_flash.py``'s);
* on meta tensors: outputs of the shapes, and the kernels' ``work``;
* ``flash_tile_live`` on the kernels' pre-pass ranges (modelled here:
  ``_tile_ranges``, ``_merge_ranges``) never skips a tile holding a
  visible pair, and keeps exactly the triangle for a causal run;
* ``visible_pairs`` and ``causal_pairs`` equal a dense mask's count;
* the backward split as the kernels run it (D, then a dK/dV pass a key
  tile and head group at a time over the group's heads and live query
  tiles in order, the groups' partials added in order, then a dQ pass
  over the live key tiles) equals ``flash_bwd_ref`` within atol 1e-5,
  rtol 1e-4 (float32: only the summation order differs);
* the dK/dV pass's head groups cover every head once; every launch plan
  fits the card (``_plan_model``, a model of ``Plan`` in
  ``csrc/flash_attn.cu``).

The CUDA kernels are held to the plain version, and the library's
``flash_plan`` export to ``_plan_model``, by the ``gpu`` tests (and the
kernels by ``chip_smoke.py`` 8a); they need only the port, so on a
machine without JAX they run alone: ``pytest --noconftest -m gpu`` on
this file.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import work as kwork
from repro_torch.kernels.flash import ops as fo
from repro_torch.kernels.flash import ref as fr
from test_torch_chip_smoke import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FWD_TOL = dict(atol=3e-5, rtol=1e-4)
GRAD_TOL = dict(atol=1e-4, rtol=1e-3)
SPLIT_TOL = dict(atol=1e-5, rtol=1e-4)
SMEM_MAX = 232_448  # bytes of shared memory a CTA can have on sm_90


def _positions(B, S, Sq, Sk, n_pad, rng=None):
    """Float positions as ``_flash_attn_train`` makes them: row b's first
    n_pad[b] tokens are pads at -1 (kval 0), chunk pads past S at -1e30."""
    pos = np.broadcast_to(np.arange(S, dtype=np.float32), (B, S)).copy()
    val = np.ones((B, S), np.float32)
    for b, n in enumerate(n_pad):
        val[b, :n] = 0
        pos[b, :n] = -1
        pos[b, n:] = np.arange(S - n)
    qpos = np.pad(pos, ((0, 0), (0, Sq - S)), constant_values=-1e30)
    kpos = np.pad(pos, ((0, 0), (0, Sk - S)), constant_values=-1e30)
    kval = np.pad(val, ((0, 0), (0, Sk - S)))
    return qpos, kpos, kval


def _inputs(B, S, Sq, Sk, Hkv, G, hd, n_pad, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, Hkv, G, hd)).astype(np.float32)
    k = rng.normal(size=(B, Sk, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, Sk, Hkv, hd)).astype(np.float32)
    dout = rng.normal(size=(B, Sq, Hkv, G, hd)).astype(np.float32)
    q[:, S:] = 0
    k[:, S:] = 0
    v[:, S:] = 0
    return (q, k, v, *_positions(B, S, Sq, Sk, n_pad)), dout


def _t(a, grad=False):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.requires_grad_() if grad else t


def _dense_mask(qpos, kpos, kval, window):
    m = (kpos[:, None, :] <= qpos[:, :, None]) & (kval[:, None, :] > 0)
    if window > 0:
        m &= kpos[:, None, :] > qpos[:, :, None] - window
    return m


@pytest.mark.parametrize("window", [0, 65])
def test_cpu_wrapper_is_the_plain_version_and_matches_jax(window):
    import jax
    import jax.numpy as jnp

    from repro.models import layers as JL

    B, S, Sq, Sk, Hkv, G, hd, qc, kc = 2, 500, 512, 512, 2, 2, 16, 128, 256
    (q, k, v, qpos, kpos, kval), dout = _inputs(B, S, Sq, Sk, Hkv, G, hd,
                                                (0, 70), seed=3)
    args = tuple(_t(a) for a in (q, k, v, qpos, kpos, kval))
    out, lse = fo.flash_fwd(*args, window, qc, kc)
    rout, rlse = fr.flash_fwd_ref(*args, window, qc, kc)
    assert torch.equal(out, rout) and torch.equal(lse, rlse)
    jout, jlse = JL._flash_fwd_impl(*(jnp.asarray(a) for a in
                                      (q, k, v, qpos, kpos, kval)),
                                    window, qc, kc)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **FWD_TOL)
    live = np.asarray(jlse) > -1e29
    assert np.array_equal(lse.numpy() > -1e29, live) and (~live).any()
    np.testing.assert_allclose(lse.numpy()[live], np.asarray(jlse)[live],
                               **FWD_TOL)
    g = fo.flash_bwd(*args, out, lse, _t(dout), window, qc, kc)
    rg = fr.flash_bwd_ref(*args, rout, rlse, _t(dout), window, qc, kc)
    assert all(torch.equal(a, b) for a, b in zip(g, rg))

    def jfn(q_, k_, v_):
        return JL._flash(q_, k_, v_, jnp.asarray(qpos), jnp.asarray(kpos),
                         jnp.asarray(kval), window, qc, kc)

    _, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jg = vjp(jnp.asarray(dout))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    tout = fo.FlashAttention.apply(tq, tk, tv, *args[3:], window, qc, kc)
    assert torch.equal(tout.detach(), out)
    ag = torch.autograd.grad(tout, (tq, tk, tv), _t(dout))
    for name, a, b, j in zip(("dq", "dk", "dv"), ag, g, jg):
        assert torch.equal(a, b), name
        np.testing.assert_allclose(a.numpy(), np.asarray(j), err_msg=name,
                                   **GRAD_TOL)


def test_meta_branch_reports_the_kernel_work():
    B, S, Hkv, G, hd, window = 2, 2048, 2, 3, 128, 1000
    e = dict(device="meta")
    q = torch.empty((B, S, Hkv, G, hd), dtype=torch.bfloat16, **e)
    k = torch.empty((B, S, Hkv, hd), dtype=torch.bfloat16, **e)
    v = torch.empty_like(k)
    pos = torch.empty((B, S), **e)
    seen = []
    with kwork.collect(lambda n, f, b: seen.append((n, f, b))):
        out, lse = fo.flash_fwd(q, k, v, pos, pos, pos, window)
        assert out.shape == q.shape and out.dtype == torch.bfloat16
        assert lse.shape == (B, Hkv, G, S) and lse.dtype == torch.float32
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        o = fo.FlashAttention.apply(qg, kg, vg, pos, pos, pos, window, None,
                                    None)
        dq, dk, dv = torch.autograd.grad(o, (qg, kg, vg), torch.empty_like(o))
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    pairs = B * fo.causal_pairs(S, window)
    fwd = fo.flash_work(B, S, S, Hkv, G, hd, 2, pairs)
    bwd = fo.flash_work(B, S, S, Hkv, G, hd, 2, pairs, backward=True)
    assert seen == [("flash_attn_fwd", *fwd), ("flash_attn_fwd", *fwd),
                    ("flash_attn_bwd", *bwd)]
    assert fwd[0] == 4 * hd * pairs * Hkv * G
    assert bwd[0] == 10 * hd * pairs * Hkv * G
    # q, k, v and positions read, out and lse written; the backward also
    # reads out, dout and lse and writes dq, dk, dv
    nq, nk = B * S * Hkv * G * hd, B * S * Hkv * hd
    assert fwd[1] == 2 * (2 * nq + 2 * nk) + 4 * 3 * B * S + 4 * B * Hkv * G * S
    assert bwd[1] == 2 * (4 * nq + 4 * nk) + 4 * 3 * B * S + 4 * B * Hkv * G * S


def test_meta_branch_counts_the_length_before_padding():
    """Through the layer, which pads S 2,272 to 2,560 queries and 3,072
    keys: the work is counted at S (the pads see no key), not at the
    padded lengths."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L

    B, S, Hq, Hkv, hd, window = 2, 2272, 4, 1, 256, 2048
    e = dict(device="meta", dtype=torch.bfloat16)
    q = torch.empty((B, S, Hq, hd), **e).requires_grad_()
    k = torch.empty((B, S, Hkv, hd), **e).requires_grad_()
    v = torch.empty((B, S, Hkv, hd), **e).requires_grad_()
    pos = torch.empty((B, S), dtype=torch.int32, device="meta")
    seen = []
    with kwork.collect(lambda n, f, b: seen.append((n, f, b))):
        out = L._flash_attn_train(q, k, v, pos, get_config("qwen2-1.5b"),
                                  window=window, valid=None)
        torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
    assert out.shape == q.shape
    pairs = B * fo.causal_pairs(S, window)
    G = Hq // Hkv
    assert seen == [
        ("flash_attn_fwd", *fo.flash_work(B, S, S, Hkv, G, hd, 2, pairs)),
        ("flash_attn_bwd", *fo.flash_work(B, S, S, Hkv, G, hd, 2, pairs,
                                          backward=True))]
    assert pairs < B * fo.causal_pairs(2560, window)


def _tile_any(mask, rows, cols):
    """(B, nq, nk) bool: whether each rows x cols tile holds a True."""
    B, Sq, Sk = mask.shape
    nq, nk = -(-Sq // rows), -(-Sk // cols)
    m = np.zeros((B, nq * rows, nk * cols), bool)
    m[:, :Sq, :Sk] = mask
    return m.reshape(B, nq, rows, nk, cols).any(axis=(2, 4))


def _tile_ranges(pos, val=None, rows=fo.RANGE_ROWS):
    """(B, ceil(S / rows), 2) float32: the (min, max) of ``pos`` (B, S)
    over each ``rows`` entries, counting only those with ``val > 0``
    (+inf, -inf where none): the kernels' pre-pass."""
    B, S = pos.shape
    n = -(-S // rows)
    p = pos.float()
    keep = torch.ones_like(p, dtype=torch.bool) if val is None else val > 0
    pad = n * rows - S
    p = F.pad(p, (0, pad)).view(B, n, rows)
    keep = F.pad(keep, (0, pad), value=False).view(B, n, rows)
    inf = torch.tensor(float("inf"))
    lo = torch.where(keep, p, inf).amin(-1)
    hi = torch.where(keep, p, -inf).amax(-1)
    return torch.stack([lo, hi], -1)


def _merge_ranges(r, per):
    """Ranges of ``per`` consecutive entries (a kernel tile of per x
    ``RANGE_ROWS`` rows), the last tile taking what is left."""
    B, n, _ = r.shape
    m = -(-n // per)
    pad = m * per - n
    lo = F.pad(r[..., 0], (0, pad), value=float("inf")).view(B, m, per)
    hi = F.pad(r[..., 1], (0, pad), value=float("-inf")).view(B, m, per)
    return torch.stack([lo.amin(-1), hi.amax(-1)], -1)


def _live(qpos, kpos, kval, window, rows, cols):
    qr = _merge_ranges(_tile_ranges(_t(qpos)), rows // fo.RANGE_ROWS)
    kr = _merge_ranges(_tile_ranges(_t(kpos), _t(kval)),
                       cols // fo.RANGE_ROWS)
    return fo.flash_tile_live(qr[:, :, None], kr[:, None, :], window).numpy()


@pytest.mark.parametrize("seed", range(4))
def test_tile_live_never_skips_a_visible_pair(seed):
    rng = np.random.default_rng(seed)
    B = 3
    for _ in range(6):
        S = int(rng.integers(40, 700))
        chunk = int(rng.choice([128, 256, S]))
        Sq = Sk = -(-S // chunk) * chunk
        n_pad = rng.integers(0, S, size=B)
        n_pad[rng.integers(B)] = 0
        qpos, kpos, kval = _positions(B, S, Sq, Sk, n_pad)
        window = int(rng.choice([0, 1, 65, 257]))
        dense = _dense_mask(qpos, kpos, kval, window)
        # the forward's and dQ's tiles (64 x 64, 64 x 32 at hd 256) and
        # the dK/dV pass's (32 query rows a step)
        for rows, cols in ((64, 64), (64, 32), (32, 64)):
            live = _live(qpos, kpos, kval, window, rows, cols)
            need = _tile_any(dense, rows, cols)
            assert live.shape == need.shape
            assert not (need & ~live).any(), (S, window, rows, cols)


def test_tile_live_keeps_the_causal_triangle():
    B, S = 2, 1000
    qpos, kpos, kval = _positions(B, S, S, S, (0, 0))
    for window in (0, 257):
        dense = _dense_mask(qpos, kpos, kval, window)
        for rows, cols in ((64, 64), (64, 32), (32, 64)):
            live = _live(qpos, kpos, kval, window, rows, cols)
            assert np.array_equal(live, _tile_any(dense, rows, cols))
    live = _live(qpos, kpos, kval, 0, 64, 64)
    assert live.sum() == B * 16 * 17 // 2  # ceil(1000 / 64) = 16 tiles


@pytest.mark.parametrize("window", [0, 1, 65, 257])
def test_visible_pairs_count_the_dense_mask(window):
    B, S = 3, 400
    qpos, kpos, kval = _positions(B, S, 512, 512, (0, 33, 400))
    dense = _dense_mask(qpos, kpos, kval, window)
    got = fo.visible_pairs(_t(qpos), _t(kpos), _t(kval), window, rows=100)
    assert got == int(dense.sum())
    p = np.arange(S, dtype=np.float32)[None]
    one = _dense_mask(p, p, np.ones((1, S), np.float32), window)
    assert fo.causal_pairs(S, window) == int(one.sum())


def _bwd_split_model(q, k, v, qpos, kpos, kval, out, lse, dout, window):
    """The kernels' backward in plain PyTorch, tile by tile in their
    order: D = rowsum(dO o O); per (b, h) and 64-key tile, each head
    group's heads in order and each head's live 32-row query tiles in
    order, the groups' partial sums then added in group order (dK, dV);
    per (b, h, g) and 64-row query tile, its live 64-key tiles in order
    (dQ). Tiles past S are cut (the kernels zero-fill them)."""
    B, Sq, Hkv, G, hd = q.shape
    Sk = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    D = torch.einsum("bskgh,bskgh->bkgs", dout.float(), out.float())
    dq = torch.zeros(q.shape)
    dk = torch.zeros(k.shape)
    dv = torch.zeros(v.shape)

    def p_ds(b, h, g, qs, ks):
        s = q[b, qs, h, g].float() @ k[b, ks, h].float().T * scale
        m = _dense_mask(qpos[b, qs][None].numpy(), kpos[b, ks][None].numpy(),
                        kval[b, ks][None].numpy(), window)[0]
        p = torch.where(torch.from_numpy(m),
                        torch.exp(s - lse[b, h, g, qs][:, None]), 0.0)
        dp = dout[b, qs, h, g].float() @ v[b, ks, h].float().T
        return p, p * (dp - D[b, h, g, qs][:, None]) * scale

    live_kv = _live(qpos.numpy(), kpos.numpy(), kval.numpy(), window, 32, 64)
    parts = fo.dkdv_parts(B, Sk, Hkv, G)
    for b in range(B):
        for h in range(Hkv):
            for kt in range(-(-Sk // 64)):
                ks = slice(kt * 64, min(Sk, kt * 64 + 64))
                for part in range(parts):
                    pk = torch.zeros(dk[b, ks, h].shape)
                    pv = torch.zeros(dv[b, ks, h].shape)
                    for g in range(part * G // parts,
                                   (part + 1) * G // parts):
                        for qt in np.flatnonzero(live_kv[b, :, kt]):
                            qs = slice(qt * 32, min(Sq, qt * 32 + 32))
                            p, ds = p_ds(b, h, g, qs, ks)
                            pv += p.T @ dout[b, qs, h, g].float()
                            pk += ds.T @ q[b, qs, h, g].float()
                    dv[b, ks, h] += pv
                    dk[b, ks, h] += pk
    live_q = _live(qpos.numpy(), kpos.numpy(), kval.numpy(), window, 64, 64)
    for b in range(B):
        for h in range(Hkv):
            for g in range(G):
                for qt in range(-(-Sq // 64)):
                    qs = slice(qt * 64, min(Sq, qt * 64 + 64))
                    for kt in np.flatnonzero(live_q[b, qt]):
                        ks = slice(kt * 64, min(Sk, kt * 64 + 64))
                        _, ds = p_ds(b, h, g, qs, ks)
                        dq[b, qs, h, g] += ds @ k[b, ks, h].float()
    return dq, dk, dv


@pytest.mark.parametrize("window", [0, 65])
def test_backward_split_model_matches_the_plain_backward(window):
    B, S, Hkv, G, hd = 2, 300, 2, 3, 16  # S not a multiple of the tiles
    assert fo.dkdv_parts(B, S, Hkv, G) == 3  # one head a group here
    (q, k, v, qpos, kpos, kval), dout = _inputs(B, S, S, S, Hkv, G, hd,
                                                (0, 45), seed=7)
    args = tuple(_t(a) for a in (q, k, v, qpos, kpos, kval))
    out, lse = fr.flash_fwd_ref(*args, window, S, S)
    want = fr.flash_bwd_ref(*args, out, lse, _t(dout), window, S, S)
    got = _bwd_split_model(*args, out, lse, _t(dout), window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name,
                                   **SPLIT_TOL)


def test_dkdv_head_groups():
    """The dK/dV pass's head groups: enough for DKDV_CTAS CTAs, at most
    G, each group non-empty and every head in exactly one."""
    # 8a as the layer pads it (keys to 3,072), phase 9, 13c, a long run
    assert fo.dkdv_parts(4, 3072, 2, 6) == 3
    assert fo.dkdv_parts(4, 3072, 1, 16) == 6
    assert fo.dkdv_parts(12, 4096, 16, 1) == 1
    assert fo.dkdv_parts(8, 32768, 8, 4) == 1
    for G in range(1, 17):
        for B, Sk, Hkv in ((1, 64, 1), (4, 3072, 2), (2, 700, 4)):
            P = fo.dkdv_parts(B, Sk, Hkv, G)
            assert 1 <= P <= G
            assert P == G or B * Hkv * -(-Sk // 64) * P >= fo.DKDV_CTAS
            heads = [g for p in range(P)
                     for g in range(p * G // P, (p + 1) * G // P)]
            assert heads == list(range(G))
            assert all((p + 1) * G // P > p * G // P for p in range(P))


def _plan_model(hd, dtype):
    """``Plan`` in ``csrc/flash_attn.cu`` (what its ``flash_plan`` export
    returns, ``ops.flash_plan``): per kernel its threads, dynamic shared
    memory (bytes), the rows it owns, the rows it steps over and the
    stages of its copy ring."""
    f32 = dtype == torch.float32
    esz = 4 if f32 else 2
    ld = hd + (4 if f32 else 8)  # elements a shared row (16 bytes of pad)
    bn = 32 if hd == 256 else 64
    nc = 2 if hd == 256 or (f32 and hd == 128) else 1
    kv_st = dq_st = 1 if (f32 and hd == 256) else 2
    bm, bnb, bmq = 64, fo.KEY_TILE, 32
    return {
        "fwd": dict(threads=128, smem=(bm * ld + 2 * 2 * bn * ld) * esz
                    + 2 * 2 * bn * 4, rows=bm, cols=bn, stages=2),
        "dkdv": dict(threads=128 * nc, smem=(2 * bnb * ld + 2 * kv_st * bmq
                                             * ld) * esz + 3 * kv_st * bmq * 4,
                     rows=bnb, cols=bmq, stages=kv_st),
        "dq": dict(threads=128, smem=(2 * bm * ld + 2 * dq_st * bn * ld) * esz
                   + 2 * dq_st * bn * 4, rows=bm, cols=bn, stages=dq_st),
    }


def test_launch_plans_fit_the_card():
    for hd in fo.FLASH_HDS:
        for dt in (torch.bfloat16, torch.float32):
            plan = _plan_model(hd, dt)
            assert tuple(plan) == fo.PLAN_KERNELS
            for kernel, p in plan.items():
                assert tuple(p) == fo.PLAN_KEYS
                assert p["smem"] <= SMEM_MAX, (hd, dt, kernel, p)
                assert p["threads"] <= 1024 and p["threads"] % 128 == 0
                assert p["rows"] % 16 == 0 and p["cols"] % 32 == 0
                assert p["stages"] in (1, 2)
            # the dK/dV pass: a 16-key row group a warp, hd split over
            # the warps of a row group
            assert plan["dkdv"]["threads"] // 32 * 16 \
                == plan["dkdv"]["rows"] * (plan["dkdv"]["threads"] // 128)
    assert [fo.built_hd(h) for h in (1, 16, 64, 65, 96, 128, 200, 256)] == \
        [64, 64, 64, 128, 128, 128, 256, 256]
    with pytest.raises(ValueError, match="257"):
        fo.built_hd(257)


@pytest.mark.gpu
def test_library_plans_are_the_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the plans come from the built library")
    for hd in fo.FLASH_HDS:
        for dt in (torch.bfloat16, torch.float32):
            assert fo.flash_plan(hd, dt) == _plan_model(hd, dt), (hd, dt)


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    (q, k, v, qpos, kpos, kval), _ = _inputs(1, 64, 64, 64, 1, 1, 16, (0,),
                                             seed=0)
    args = [_t(a) for a in (q, k, v, qpos, kpos, kval)]
    with pytest.raises(ValueError, match="not on"):
        fo.flash_fwd_cuda(*args, 0)
    big = [torch.zeros((1, 64, 1, 1, 320)), torch.zeros((1, 64, 1, 320)),
           torch.zeros((1, 64, 1, 320)), *args[3:]]
    with pytest.raises(ValueError, match="320"):
        fo.flash_fwd_cuda(*big, 0)
    with pytest.raises(TypeError, match="float16"):
        fo.flash_fwd_cuda(*(a.half() for a in args[:3]), *args[3:], 0)
    # the plain version takes CPU tensors only
    with pytest.raises(ValueError, match="meta"):
        fo.flash_fwd(*args[:3], args[3].to("meta"), *args[4:], 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_the_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    tol = {"float32": (1e-4, 1e-3, 1e-4),
           "bfloat16": (3e-2, 1e-2, 3e-2)}[dtype]
    dt = getattr(torch, dtype)
    for hd, window, n_pad, S in ((64, 0, (0, 37), 300), (128, 257, (5, 300),
                                                         300),
                                 (256, 2048, (0, 0), 700), (96, 65, (0, 9),
                                                            200)):
        (q, k, v, qpos, kpos, kval), dout = _inputs(2, S, S, S, 2, 3, hd,
                                                    n_pad, seed=hd)
        args = [_t(a).cuda() for a in (q, k, v, qpos, kpos, kval)]
        args[:3] = [a.to(dt) for a in args[:3]]
        d = _t(dout).cuda().to(dt)
        out, lse = fo.flash_fwd(*args, window)
        rout, rlse = fr.flash_fwd_ref(*args, window, S, S)
        torch.testing.assert_close(out.float(), rout.float(), atol=tol[0],
                                   rtol=tol[1])
        assert torch.equal(lse <= -1e29, rlse <= -1e29)
        g = fo.flash_bwd(*args, out, lse, d, window)
        g2 = fo.flash_bwd(*args, out, lse, d, window)
        rg = fr.flash_bwd_ref(*args, out, lse, d, window, S, S)
        for a, a2, r in zip(g, g2, rg):
            assert torch.equal(a, a2)
            e = float((a.float() - r.float()).abs().max()
                      / r.float().abs().max())
            assert e <= tol[2], (hd, window, e)
