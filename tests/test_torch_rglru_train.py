"""The RG-LRU scan's backward and the recurrent block's gradients against
the JAX package, float32, on the same numpy inputs:

* ``rglru_scan_bwd_ref`` (the plain reverse-time adjoint) and the scan
  under autograd on CPU tensors (``ops.RGLRUScan``, whose backward runs
  the plain version there) against ``jax.vjp`` of the model's
  ``_rglru_scan`` (committed = updated), on the same cotangents of hs and
  h_final, without and with an update mask, at ragged (B, T, W): within
  atol/rtol 1e-5 (XLA and PyTorch round the transcendentals differently,
  as for the forward); and against ``torch.autograd`` through the plain
  forward ``rglru_scan_ref`` (dx, di and dh0 equal, dr and dΛ within
  1e-5: autograd's sums run in another order);
* the backward wrapper on CPU tensors runs the plain version and counts
  no launch;
* ``apply_rglru``'s gradients (wx, wy, wo, conv, w_a, w_i, Λ and the
  input), under a prefill-style update mask and without one, against
  ``jax.grad`` of the JAX block on RecurrentGemma-9B's smoke variant
  (d_model 256, 3 layers, local window 64): within atol 1e-5, rtol 1e-4;
* the hybrid trains and still rolls out: with trainable parameters a
  forward under autograd reaches every RG-LRU parameter, and the
  engine's ``inference_mode`` forward runs the hybrid;
* the CUDA backward kernel against the plain version, bit for bit
  (``gpu``: skips without a card; ``chip_smoke.py`` phase 9a runs it at
  the training shape).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.models import layers as JL
from repro_torch.configs import get_config, smoke_variant
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rglru import ops as rg_ops
from repro_torch.kernels.rglru.ref import rglru_scan_bwd_ref, rglru_scan_ref
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.convert import tensor_from_numpy

TOL = dict(atol=1e-5, rtol=1e-5)
BLOCK_TOL = dict(atol=1e-5, rtol=1e-4)
CASES = [(2, 16, 128), (1, 7, 130), (3, 37, 70), (2, 33, 33)]
NAMES = ("dx", "dr", "di", "dlam", "dh0")


def _inputs(B, T, W, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, T, W)).astype(np.float32),
            rng.uniform(size=(B, T, W)).astype(np.float32),
            rng.uniform(size=(B, T, W)).astype(np.float32),
            rng.normal(size=(W,)).astype(np.float32),
            rng.normal(size=(B, W)).astype(np.float32))


def _cotangents(B, T, W, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, T, W)).astype(np.float32),
            rng.normal(size=(B, W)).astype(np.float32))


def _mask(B, T, seed=3):
    """Left pads of random length, row 0 kept whole, the last row frozen
    (all masked) when B > 2."""
    rng = np.random.default_rng(seed)
    mask = np.arange(T)[None] >= rng.integers(0, T, size=B)[:, None]
    mask[0] = True
    if B > 2:
        mask[-1] = False
    return mask


def _jax_vjp(arrs, cot, mask):
    B, T = arrs[0].shape[:2]
    upd = jnp.ones((T, B), bool) if mask is None else jnp.asarray(mask.T)
    _, vjp = jax.vjp(lambda *a: JL._rglru_scan(*a, upd, upd),
                     *map(jnp.asarray, arrs))
    return [np.asarray(g) for g in vjp(tuple(map(jnp.asarray, cot)))]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("B,T,W", CASES)
def test_bwd_ref_and_autograd_match_jax_vjp(B, T, W, masked):
    arrs = _inputs(B, T, W)
    cot = _cotangents(B, T, W)
    mask = _mask(B, T) if masked else None
    want = _jax_vjp(arrs, cot, mask)
    tm = None if mask is None else torch.from_numpy(mask)
    targs = [torch.from_numpy(a) for a in arrs]
    tcot = [torch.from_numpy(c) for c in cot]
    hs, _ = rglru_scan_ref(*targs, tm)
    plain = rglru_scan_bwd_ref(*targs, hs, *tcot, tm)
    leaves = [t.clone().requires_grad_() for t in targs]
    out = rg_ops.rglru_scan(*leaves, tm)  # through ops.RGLRUScan
    fn = torch.autograd.grad(out, leaves, tcot)
    for name, p, f, w in zip(NAMES, plain, fn, want):
        np.testing.assert_allclose(p.numpy(), w, err_msg=name, **TOL)
        assert torch.equal(p, f), name  # the Function runs the plain version
    # autograd through the plain forward, on the same cotangents
    leaves = [t.clone().requires_grad_() for t in targs]
    ag = torch.autograd.grad(rglru_scan_ref(*leaves, tm), leaves, tcot)
    for name, p, a in zip(NAMES, plain, ag):
        if name in ("dr", "dlam"):
            np.testing.assert_allclose(p.numpy(), a.numpy(), err_msg=name,
                                       **TOL)
        else:
            assert torch.equal(p, a), name
    if mask is not None:  # a masked step passes the adjoint and gets none
        for g in plain[:3]:
            assert not bool(g[torch.from_numpy(~mask)].any())


def test_cpu_bwd_wrapper_runs_the_plain_version_without_launching():
    before = rg_ops.BWD_LAUNCHES
    shapes = dict(rg_ops.BWD_LAUNCHES_BY_SHAPE)
    targs = [torch.from_numpy(a) for a in _inputs(2, 5, 8)]
    hs, _ = rglru_scan_ref(*targs)
    got = rg_ops.rglru_scan_bwd(*targs, hs, *map(torch.from_numpy,
                                                 _cotangents(2, 5, 8)))
    assert rg_ops.BWD_LAUNCHES == before
    assert dict(rg_ops.BWD_LAUNCHES_BY_SHAPE) == shapes
    assert all(bool(torch.isfinite(g).all()) for g in got)


# ---------------------------------------------------------------------------
# apply_rglru under autograd
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def block():
    jcfg = jax_smoke_variant(jax_get_config("recurrentgemma-9b"))
    jp = JL.split_tree(JL.init_rglru(jax.random.key(5), jcfg))[0]
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg)), jp


@pytest.mark.parametrize("masked", [False, True])
def test_apply_rglru_grads_match_jax(block, masked):
    jcfg, cfg, jp = block
    B, T = 2, 24
    rng = np.random.default_rng(11)
    x = rng.normal(size=(B, T, cfg.d_model)).astype(np.float32)
    dy = rng.normal(size=(B, T, cfg.d_model)).astype(np.float32)
    mask = _mask(B, T, seed=12) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)

    def jloss(p, xx):
        y, _, _ = JL.apply_rglru(p, xx, jcfg, update_mask=jmask)
        return jnp.sum(y * dy)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: tensor_from_numpy(np.asarray(v), "cpu").requires_grad_()
          for k, v in jp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, _, _ = TL.apply_rglru(tp, tx, cfg, update_mask=(
        None if mask is None else torch.from_numpy(mask)))
    names = sorted(tp)
    assert names == ["conv", "lam", "w_a", "w_i", "wo", "wx", "wy"]
    grads = torch.autograd.grad((y * torch.from_numpy(dy)).sum(),
                                [tp[k] for k in names] + [tx])
    for k, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgp[k]), err_msg=k,
                                   **BLOCK_TOL)
        assert bool(g.abs().max() > 0), k
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgx),
                               **BLOCK_TOL)


def test_hybrid_trains_and_still_rolls_out():
    cfg = smoke_variant(get_config("recurrentgemma-9b"))
    params = TM.set_trainable(TM.init_params(cfg, seed=0, device="cpu"))
    toks = torch.randint(2, cfg.vocab_size, (1, 8),
                         generator=torch.Generator().manual_seed(0))
    logits, _ = TM.forward(params, cfg, toks)
    named = dict(params.named_parameters())
    rec = [k for k in named if ".rglru." in k]
    assert len(rec) == 7 * sum(k == "rglru" for k in cfg.layer_kinds)
    grads = torch.autograd.grad(logits[:, :, : cfg.vocab_size].sum(),
                                [named[k] for k in rec])
    for k, g in zip(rec, grads):
        assert bool(torch.isfinite(g).all()) and bool(g.abs().max() > 0), k
    with torch.inference_mode():  # the engine's rollouts run the hybrid
        logits, _ = TM.forward(params, cfg, toks)
    assert torch.isfinite(logits).all()


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,W", CASES + [(4, 2272, 4096), (2, 33, 4001),
                                           (1, 1, 1)])
def test_cuda_bwd_kernel_matches_plain(B, T, W):
    """Bit for bit, with and without a mask, at the small cases, the
    training shape, a width not a multiple of 4 and one lane."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    args = [torch.from_numpy(a).cuda() for a in _inputs(B, T, W)]
    cot = [torch.from_numpy(c).cuda() for c in _cotangents(B, T, W)]
    for mask in (None, torch.from_numpy(_mask(B, T)).cuda()):
        hs, _ = rglru_scan_ref(*args, mask)
        got = rg_ops.rglru_scan_bwd_cuda(*args, hs, *cot, mask)
        want = rglru_scan_bwd_ref(*args, hs, *cot, mask)
        torch.cuda.synchronize()
        for name, g, w in zip(NAMES, got, want):
            assert torch.equal(g, w), name
