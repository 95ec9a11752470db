"""The port's memory-bounded flash attention (``_flash_attn_train``, a
``torch.autograd.Function`` with a hand-written backward) against the
JAX package's ``custom_vjp`` one on the same numpy inputs, float32:

* forward within atol 3e-5, rtol 1e-4 (``tests/test_models.py``'s
  tolerance for the reference's own flash-vs-dense check);
* ``dq``, ``dk``, ``dv`` against ``jax.vjp`` of the same call with the
  same cotangent, and against autograd through the port's dense
  ``_attn_core``, within atol 1e-4, rtol 1e-3;
* the residuals saved for the backward hold no (S, S) tensor;

at B 2, S 2304 (so the q and kv chunks both pad), 4/2 heads, hd 16,
windows 0 and 257, with no key mask and with a left-pad mask. Then a
2,100-token prefill (every layer through the flash path) against JAX's
``prefill``.
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
from repro.models import model as JM
from conftest import make_params
from test_torch_model import _compare_caches
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy

FWD_TOL = dict(atol=3e-5, rtol=1e-4)
GRAD_TOL = dict(atol=1e-4, rtol=1e-3)
PREFILL_TOL = dict(atol=2e-4, rtol=2e-4)  # tests/test_torch_model.py's

B, S, HQ, HKV, HD = 2, 2304, 4, 2, 16
CFG = ModelConfig(name="flash", family="dense", num_layers=1, d_model=64,
                  num_heads=HQ, num_kv_heads=HKV, head_dim=HD, d_ff=64,
                  vocab_size=64)


def _inputs(valid_kind: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, HQ, HD)).astype(np.float32)
    k = rng.normal(size=(B, S, HKV, HD)).astype(np.float32)
    v = rng.normal(size=(B, S, HKV, HD)).astype(np.float32)
    dout = rng.normal(size=(B, S, HQ, HD)).astype(np.float32)
    if valid_kind == "none":
        valid = None
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    else:  # left pads, as prefill gives them: pads at position -1
        n_pad = np.array([0, 300])
        valid = np.arange(S)[None, :] >= n_pad[:, None]
        pos = np.where(valid, np.cumsum(valid, axis=1) - 1, -1).astype(
            np.int32)
    return q, k, v, dout, pos, valid


def _torch(a, grad=False):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.requires_grad_() if grad else t


@pytest.mark.parametrize("window", [0, 257])
@pytest.mark.parametrize("valid_kind", ["none", "left_pad"])
def test_flash_forward_and_vjp_match_jax(window, valid_kind):
    q, k, v, dout, pos, valid = _inputs(valid_kind)

    def jfn(q_, k_, v_):
        return JL._flash_attn_train(
            q_, k_, v_, jnp.asarray(pos), CFG, window=window,
            valid=None if valid is None else jnp.asarray(valid))

    jout, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jdq, jdk, jdv = vjp(jnp.asarray(dout))

    tq, tk, tv = _torch(q, True), _torch(k, True), _torch(v, True)
    tout = TL._flash_attn_train(
        tq, tk, tv, _torch(pos), CFG, window=window,
        valid=None if valid is None else _torch(valid))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               **FWD_TOL)
    tdq, tdk, tdv = torch.autograd.grad(tout, (tq, tk, tv), _torch(dout))
    for name, got, want in (("dq", tdq, jdq), ("dk", tdk, jdk),
                            ("dv", tdv, jdv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("window", [0, 257])
def test_flash_vjp_matches_dense_autograd(window):
    q, k, v, dout, pos, valid = _inputs("left_pad", seed=1)
    # rows that see nothing differ by design (0 here, the mean of v in the
    # dense softmax): no cotangent flows into them
    dout = dout * valid[:, :, None, None]
    tq, tk, tv = _torch(q, True), _torch(k, True), _torch(v, True)
    tpos, tval = _torch(pos), _torch(valid)
    out = TL._flash_attn_train(tq, tk, tv, tpos, CFG, window=window,
                               valid=tval)
    grads = torch.autograd.grad(out, (tq, tk, tv), _torch(dout))
    qp, kp = tpos[:, :, None], tpos[:, None, :]
    mask = (kp <= qp) & tval[:, None, :]
    if window > 0:
        mask &= kp > qp - window
    dense = TL._attn_core(tq, tk, tv, mask[:, None], CFG)
    want = torch.autograd.grad(dense, (tq, tk, tv), _torch(dout))
    np.testing.assert_allclose(out.detach()[tval].numpy(),
                               dense.detach()[tval].numpy(), **FWD_TOL)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name,
                                   **GRAD_TOL)


def test_flash_saves_no_square_residual():
    q, k, v, _, pos, valid = _inputs("left_pad")
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        TL._flash_attn_train(_torch(q, True), _torch(k, True),
                             _torch(v, True), _torch(pos), CFG, window=0,
                             valid=_torch(valid))
    assert saved, "nothing saved for the backward"
    biggest = max(int(np.prod(s)) for s in saved)
    assert biggest < S * S, f"a residual of {biggest} elements: {saved}"
    assert not any(S in s and sum(d >= S for d in s) >= 2 for s in saved)


def test_long_prefill_matches_jax():
    """A 2,100-token prompt (left-padded row beside it) prefills through
    the flash path in every layer: last logits and caches equal JAX's."""
    jcfg = jax_smoke_variant(jax_get_config("qwen2-1.5b")).replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=128, vocab_pad_multiple=128)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jparams = make_params(jcfg, seed=4)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    rng = np.random.default_rng(5)
    Tp = 2100
    toks = rng.integers(2, cfg.vocab_size, size=(2, Tp)).astype(np.int32)
    mask = np.ones((2, Tp), bool)
    mask[1, :150] = False
    toks[1, :150] = 0
    max_len = 2304
    jlast, jcache = JM.prefill(jparams, jcfg, jnp.asarray(toks),
                               jnp.asarray(mask), max_len)
    with torch.inference_mode():
        tlast, tcache = TM.prefill(params, cfg, _torch(toks), _torch(mask),
                                   max_len=max_len)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast),
                               **PREFILL_TOL)
    _compare_caches(jcache, tcache, cfg, PREFILL_TOL)
