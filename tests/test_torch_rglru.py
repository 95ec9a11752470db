"""The RG-LRU scan and block of the port against the JAX package.

* The port's plain scan against ``rglru_scan_ref`` and the Pallas kernel
  (``rglru_scan``, interpret mode on the CPU) at the cases of
  tests/test_kernels.py, atol/rtol 1e-5 as there (float32; XLA and
  PyTorch round the transcendentals differently).
* The masked scan (left pads, frozen rows) against the model's
  ``_rglru_scan`` with committed = updated, as the serving path uses it.
* ``apply_rglru`` against the JAX block on the same weights, for prefill
  (update mask over left pads) and verify (``collect=True``: staged
  per-step h and conv contexts from a cached state, a frozen row), and
  the committed carry of ``commit_upto`` (h and the conv context) against
  the reference's dual-carry scan, in [0, T] and past both ends.
* A model of the CUDA kernel's decomposition (tiles of 32 steps by 32
  lanes, gates formed a tile at a time, the carry walked per lane, no
  load at a masked step) bit for bit against the plain version, and
  within the tolerance against the JAX kernel and ``_rglru_scan``.
* The CUDA kernel against the plain version, bit for bit (``gpu``: skips
  without a card; ``chip_smoke.py`` runs it at the main path's shapes).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.kernels.rglru import rglru_scan as jax_kernel
from repro.kernels.rglru import rglru_scan_ref as jax_ref
from repro.models import layers as JL
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rglru import ops as rg_ops
from repro_torch.kernels.rglru.ref import RGLRU_C, rglru_scan_ref
from repro_torch.models import layers as TL
from repro_torch.models.convert import tensor_from_numpy

TOL = dict(atol=1e-5, rtol=1e-5)
CASES = [(2, 16, 128), (1, 7, 130), (3, 128, 256)]


def _inputs(B, T, W, seed=1):
    """As tests/test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, W)).astype(np.float32)
    r = rng.uniform(size=(B, T, W)).astype(np.float32)
    i = rng.uniform(size=(B, T, W)).astype(np.float32)
    lam = rng.normal(size=(W,)).astype(np.float32)
    h0 = rng.normal(size=(B, W)).astype(np.float32)
    return x, r, i, lam, h0


def _update_mask(B, T, seed=2):
    """Left pads of random length on every row, and row 0 frozen."""
    rng = np.random.default_rng(seed)
    mask = np.arange(T)[None] >= rng.integers(0, T, size=B)[:, None]
    mask[0] = False
    return mask


@pytest.mark.parametrize("B,T,W", CASES)
def test_plain_scan_matches_jax_kernel_and_ref(B, T, W):
    arrs = _inputs(B, T, W)
    jargs = [jnp.asarray(a) for a in arrs]
    hs, hf = rg_ops.rglru_scan(*map(torch.from_numpy, arrs))
    assert hs.shape == (B, T, W) and hf.shape == (B, W)
    for want_hs, want_hf in (jax_kernel(*jargs), jax_ref(*jargs)):
        np.testing.assert_allclose(hs.numpy(), np.asarray(want_hs), **TOL)
        np.testing.assert_allclose(hf.numpy(), np.asarray(want_hf), **TOL)


@pytest.mark.parametrize("B,T,W", CASES)
def test_masked_scan_matches_jax_model_scan(B, T, W):
    x, r, i, lam, h0 = _inputs(B, T, W)
    mask = _update_mask(B, T)
    upd = jnp.asarray(mask.T)
    want_hs, want_hf = JL._rglru_scan(*map(jnp.asarray, (x, r, i, lam, h0)),
                                      upd, upd)
    hs, hf = rg_ops.rglru_scan(*map(torch.from_numpy, (x, r, i, lam, h0)),
                               mask=torch.from_numpy(mask))
    np.testing.assert_allclose(hs.numpy(), np.asarray(want_hs), **TOL)
    np.testing.assert_allclose(hf.numpy(), np.asarray(want_hf), **TOL)
    np.testing.assert_array_equal(hf[0].numpy(), h0[0])  # frozen row


def test_cpu_wrapper_runs_the_plain_version_without_launching():
    before = rg_ops.LAUNCHES
    shapes = dict(rg_ops.LAUNCHES_BY_SHAPE)
    hs, _ = rg_ops.rglru_scan(*map(torch.from_numpy, _inputs(1, 3, 8)))
    assert rg_ops.LAUNCHES == before and torch.isfinite(hs).all()
    assert dict(rg_ops.LAUNCHES_BY_SHAPE) == shapes


# ---------------------------------------------------------------------------
# the CUDA kernel's decomposition, modelled on the CPU
# ---------------------------------------------------------------------------
# csrc/rglru.cu gives a CTA one row and KWT = 32 width lanes and walks T
# in chunks of KCT = 32 steps: its gater warps copy a chunk's tiles of x,
# r and i (nothing at a masked step) and form a and mult * (i * x) for the
# tile; then one thread per lane walks the carry over the chunk in time
# order. The model repeats that tile by tile: the gates with the plain
# version's expressions on the tile's loaded steps, log sigmoid(Λ) per
# lane, the carry in numpy float32 (a product and a sum, each rounded).

KCT, KWT = 32, 32


def _tile_gates(x, r, i, a_base):
    """a and mult * (i * x) of the loaded steps of one tile."""
    x, r, i, a_base = (torch.from_numpy(np.ascontiguousarray(v))
                       for v in (x, r, i, a_base))
    log_a = RGLRU_C * r * a_base
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 1e-9, 1.0))
    return torch.exp(log_a).numpy(), (mult * (i * x)).numpy()


def _kernel_model(x, r, i, lam, h0, mask):
    """(hs, h_final, loads): the scan as the kernel's CTAs compute it;
    ``loads[b, t]`` counts the tiles that copied step t of row b."""
    B, T, W = x.shape
    hs = np.full((B, T, W), np.nan, np.float32)
    hf = np.full((B, W), np.nan, np.float32)
    a_base = torch.log(torch.sigmoid(torch.from_numpy(lam))).numpy()
    upd = np.ones((B, T), bool) if mask is None else mask
    loads = np.zeros((B, T), int)
    for b in range(B):
        for w0 in range(0, W, KWT):  # a CTA
            lanes = slice(w0, min(w0 + KWT, W))
            n = lanes.stop - w0
            h = h0[b, lanes].copy()
            for t0 in range(0, T, KCT):  # a chunk (a stage of the ring)
                steps = np.arange(t0, min(t0 + KCT, T))
                kept = steps[upd[b, steps]]  # the steps copied
                loads[b, kept] += 1
                a = np.full((KCT, KWT), np.nan, np.float32)  # unloaded
                gx = a.copy()
                if len(kept):
                    a[kept - t0, :n], gx[kept - t0, :n] = _tile_gates(
                        x[b, kept, lanes], r[b, kept, lanes],
                        i[b, kept, lanes], a_base[lanes])
                for t in steps:  # the walker: one thread a lane
                    if upd[b, t]:
                        h = a[t - t0, :n] * h + gx[t - t0, :n]
                    hs[b, t, lanes] = h
            hf[b, lanes] = h
    return hs, hf, loads


def _model_mask(kind, B, T, seed):
    """Rows masked for the whole block, left pads longer than a chunk,
    or random left pads."""
    rng = np.random.default_rng(seed)
    if kind == "frozen rows":
        mask = np.ones((B, T), bool)
        mask[1::3] = False
        return mask
    if kind == "long pads":
        pads = np.minimum(rng.integers(KCT + 1, 3 * KCT, size=B), T - 1)
    elif kind == "pads":
        pads = rng.integers(0, T, size=B)
    else:
        return None
    return np.arange(T)[None] >= pads[:, None]


# (B, T, W, mask): T of 1, the verify block's 17, KCT - 1, KCT, KCT + 1
# and the longest prompt's 2047; widths that are not multiples of KWT
MODEL_CASES = {
    "T1": (2, 1, 40, None),
    "T17_frozen_rows": (8, 17, 72, "frozen rows"),
    "T31_pads": (3, 31, 70, "pads"),
    "T32": (2, 32, 96, None),
    "T33_long_pads": (3, 33, 40, "long pads"),
    "T33_frozen_rows": (4, 33, 33, "frozen rows"),
    "T2047": (1, 2047, 36, None),
    "T2047_long_pads": (2, 2047, 20, "long pads"),
}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_kernel_model_bit_identical_to_plain_and_near_jax(case):
    B, T, W, kind = MODEL_CASES[case]
    arrs = _inputs(B, T, W, seed=len(case))
    mask = _model_mask(kind, B, T, seed=3)
    hs, hf, loads = _kernel_model(*arrs, mask)
    want_hs, want_hf = rglru_scan_ref(
        *map(torch.from_numpy, arrs),
        None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(hs.view(np.uint32),
                                  want_hs.numpy().view(np.uint32))
    np.testing.assert_array_equal(hf.view(np.uint32),
                                  want_hf.numpy().view(np.uint32))
    # each kept step is copied once by each of the row's tiles, a masked
    # one never (a row masked for a whole chunk loads nothing there)
    upd = np.ones((B, T), bool) if mask is None else mask
    np.testing.assert_array_equal(loads, upd * -(-W // KWT))
    if kind in ("frozen rows", "long pads"):  # a row's first chunk masked
        assert (~upd[:, :KCT]).all(axis=1).any()
    jargs = [jnp.asarray(a) for a in arrs]
    if mask is None:
        jhs, jhf = jax_kernel(*jargs)
    else:
        upd_t = jnp.asarray(mask.T)
        jhs, jhf = JL._rglru_scan(*jargs, upd_t, upd_t)
    np.testing.assert_allclose(hs, np.asarray(jhs), **TOL)
    np.testing.assert_allclose(hf, np.asarray(jhf), **TOL)


# ---------------------------------------------------------------------------
# apply_rglru
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def block():
    jcfg = jax_smoke_variant(jax_get_config("recurrentgemma-9b"))
    assert jcfg.dtype == "float32"
    jp = JL.split_tree(JL.init_rglru(jax.random.key(5), jcfg))[0]
    tp = {k: tensor_from_numpy(np.asarray(v), "cpu") for k, v in jp.items()}
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg)), jp, tp


def _x(cfg, B, T, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, T, cfg.d_model)).astype(np.float32)


def test_apply_rglru_prefill_matches_jax(block):
    jcfg, cfg, jp, tp = block
    B, T = 3, 12
    x = _x(cfg, B, T, 6)
    mask = _update_mask(B, T, seed=7)
    mask[0, -4:] = True  # row 0: a short prompt, not frozen
    jy, jh, jconv = JL.apply_rglru(jp, jnp.asarray(x), jcfg,
                                   update_mask=jnp.asarray(mask))
    ty, th, tconv = TL.apply_rglru(tp, torch.from_numpy(x), cfg,
                                   update_mask=torch.from_numpy(mask))
    for got, want in ((ty, jy), (th, jh), (tconv, jconv)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_apply_rglru_verify_collect_matches_jax(block):
    jcfg, cfg, jp, tp = block
    B, T, W, cw = 3, 5, cfg.rnn_width, cfg.conv_width
    rng = np.random.default_rng(8)
    x = _x(cfg, B, T, 9)
    h0 = rng.normal(size=(B, W)).astype(np.float32)
    conv0 = rng.normal(size=(B, cw - 1, W)).astype(np.float32)
    valid = np.ones((B, T), bool)
    valid[1] = False  # a frozen row
    jy, jh, jconv = JL.apply_rglru(
        jp, jnp.asarray(x), jcfg, jnp.asarray(h0), jnp.asarray(conv0),
        update_mask=jnp.asarray(valid), collect=True)
    ty, th, tconv = TL.apply_rglru(
        tp, torch.from_numpy(x), cfg, torch.from_numpy(h0),
        torch.from_numpy(conv0), update_mask=torch.from_numpy(valid),
        collect=True)
    assert tuple(th.shape) == (B, T + 1, W)
    assert tuple(tconv.shape) == (B, T + 1, cw - 1, W)
    for got, want in ((ty, jy), (th, jh), (tconv, jconv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the frozen row's staged states are all the state before the block
    np.testing.assert_array_equal(th[1].numpy(), np.broadcast_to(h0[1],
                                                                 (T + 1, W)))


# per row: commit nothing, a prefix, everything; then past the ends: -1
# (the conv context's first index wraps to the last input), T + 1 (its
# last tap reads past the end: NaN), -(T + cw) (the first tap wraps to
# -1, still outside: NaN) and T + cw - 1 (every tap past the end)
COMMIT_CASES = {"inside": lambda T, cw: [0, 2, T],
                "outside": lambda T, cw: [-1, T + 1, -(T + cw)],
                "far_outside": lambda T, cw: [T + cw - 1, -T - 40, T + 9]}


@pytest.mark.parametrize("case", sorted(COMMIT_CASES))
def test_apply_rglru_commit_upto_matches_jax_dual_carry(block, case):
    """The port keeps the scan on its kernel and gathers the committed
    carry from the scan's hs: ``cat([h0, hs], 1)[:, clamp(upto, 0, T)]``.
    That is the reference's second carry (``_rglru_scan``): the dynamic
    state changes only at updated steps, and step t commits iff it
    updates and t < upto, so the committed state is the dynamic state
    after step upto - 1 (h0 for upto <= 0, the last state for upto >=
    T). The conv context follows ``jnp.take_along_axis``'s default
    "fill" mode: a negative index counts from the end once, an index
    still out of range reads NaN. A frozen row and a left-padded one."""
    jcfg, cfg, jp, tp = block
    B, T, W, cw = 3, 5, cfg.rnn_width, cfg.conv_width
    rng = np.random.default_rng(10)
    x = _x(cfg, B, T, 11)
    h0 = rng.normal(size=(B, W)).astype(np.float32)
    conv0 = rng.normal(size=(B, cw - 1, W)).astype(np.float32)
    valid = np.ones((B, T), bool)
    valid[1] = False  # a frozen row
    valid[2, :2] = False  # left pads
    upto = np.asarray(COMMIT_CASES[case](T, cw), np.int32)
    jy, jh, jconv = JL.apply_rglru(
        jp, jnp.asarray(x), jcfg, jnp.asarray(h0), jnp.asarray(conv0),
        update_mask=jnp.asarray(valid), commit_upto=jnp.asarray(upto))
    ty, th, tconv = TL.apply_rglru(
        tp, torch.from_numpy(x), cfg, torch.from_numpy(h0),
        torch.from_numpy(conv0), update_mask=torch.from_numpy(valid),
        commit_upto=torch.from_numpy(upto))
    for got, want in ((ty, jy), (th, jh), (tconv, jconv)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    nan = np.isnan(np.asarray(jconv))
    np.testing.assert_array_equal(np.isnan(tconv.numpy()), nan)
    assert nan.any() == (case != "inside")


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,W", CASES + [(8, 17, 4096), (8, 256, 4096),
                                           (1, 2047, 4096), (2, 33, 4001),
                                           (3, 40, 4000), (1, 1, 1)])
def test_cuda_kernel_matches_plain(B, T, W):
    """Within the tolerance and bit for bit, with and without a mask, at
    the small cases, the path's verify and prefill shapes, the longest
    prompt, a width not a multiple of 4 (4-byte copies) and a ragged one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    args = [torch.from_numpy(a).cuda() for a in _inputs(B, T, W)]
    for mask in (None, torch.from_numpy(_update_mask(B, T)).cuda()):
        got = rg_ops.rglru_scan_cuda(*args, mask)
        want = rglru_scan_ref(*args, mask)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                       **TOL)
            assert torch.equal(g, w)
