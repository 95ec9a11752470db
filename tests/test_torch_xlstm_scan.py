"""The xLSTM recurrence kernels' plain versions and autograd functions
(``repro_torch.kernels.xlstm``) on the CPU, float32, at small widths (2
heads of 8 to 16, T <= 24, checkpoint intervals that do not divide T):

* ``mlstm_scan_bwd_ref`` / ``slstm_scan_bwd_ref`` (the kernels' reverse
  walk: chunks recomputed from the forward's checkpoints) through
  ``MLSTMScan`` / ``SLSTMScan`` against ``torch.autograd.grad`` through
  the plain forward loops, from a fresh state (m at -inf), a carried
  one, with left pads and a frozen row, and with a tie in the
  stabilizer's max (m0 = 0.5 and i_0 = log σ(30) + 0.5 = 0.5 exactly):
  within 1e-5 (the two sum the adjoints in other orders; the
  stabilizer's max splits a tie's adjoint in half in both);
* ``apply_mlstm`` / ``apply_slstm`` gradients (every weight, the input
  and the carried state) through those functions against ``jax.grad`` of
  the JAX package's blocks on the same numpy weights and inputs, with an
  update mask: within atol/rtol 1e-4 (XLA and PyTorch round the
  transcendentals differently, and the difference grows over the steps,
  as for the forward's 2e-4 in tests/test_torch_xlstm.py);
* the meta branch: output shapes, nothing run, ``work`` reported;
* phase 3e of ``chip_smoke.py`` rehearsed with the wrappers' plain
  versions (the cases' plumbing: masks, commit_upto, collect, the saved
  tensors, the backward's arguments).
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
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import work as kwork
from repro_torch.kernels.xlstm import ops as xo
from repro_torch.kernels.xlstm import ref as xr
from repro_torch.models import layers as TL
from repro_torch.models.convert import tensor_from_numpy
from test_torch_chip_smoke import _chip_smoke, one_torch_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
JAX_TOL = dict(atol=1e-4, rtol=1e-4)
H = 2
# name -> (B, T, hd, state, masks, K)
CASES = {
    "fresh": (2, 11, 8, "fresh", None, 4),
    "carried_pads_frozen": (3, 13, 16, "carried", "left pads + frozen row",
                            5),
    "tie": (2, 9, 8, "tie", None, 4),
    "one_chunk": (2, 6, 8, "carried", "left pads", 8),
}


def _inputs(block, case, seed):
    cs = _chip_smoke()
    B, T, hd, state, masks, _ = CASES[case]
    if block == "mlstm":
        return cs.mlstm_inputs(torch, np, B, T, hd, "float32", state, masks,
                               seed, dev="cpu", H=H)
    return cs.slstm_inputs(torch, np, B, T, hd, state, masks, seed,
                           dev="cpu", H=H)


def _cotangents(outs, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=tuple(o.shape))
                             .astype(np.float32)) for o in outs]


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_scan_backward_matches_autograd(one_torch_thread, block, case):
    args = _inputs(block, case, 11 + len(case))
    *xs, upd = args
    K = CASES[case][-1]
    leaves = [x.clone().requires_grad_(True) for x in xs]
    plain = xr.mlstm_scan_ref if block == "mlstm" else xr.slstm_scan_ref
    scan = xo.mlstm_scan if block == "mlstm" else xo.slstm_scan
    want_out = plain(*leaves, upd)
    cots = _cotangents(want_out, 3)
    # -inf stays -inf (m of a fresh state never updated): no cotangent there
    cots = [torch.where(torch.isfinite(o.detach()), c, 0.0)
            for o, c in zip(want_out, cots)]
    want = torch.autograd.grad(want_out, leaves, cots, allow_unused=True)
    before = (xo.MLSTM_BWD_LAUNCHES, xo.SLSTM_BWD_LAUNCHES)
    leaves2 = [x.clone().requires_grad_(True) for x in xs]
    got_out = scan(*leaves2, upd, ckpt_every=K)
    for g, w in zip(got_out, want_out):
        np.testing.assert_array_equal(g.detach().numpy(), w.detach().numpy())
    got = torch.autograd.grad(got_out, leaves2, cots, allow_unused=True)
    assert (xo.MLSTM_BWD_LAUNCHES, xo.SLSTM_BWD_LAUNCHES) == before
    for i, (g, w) in enumerate(zip(got, want)):
        w = torch.zeros_like(xs[i]) if w is None else w
        assert g is not None and g.shape == xs[i].shape, i
        assert torch.isfinite(g).all(), i
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=str(i),
                                   **TOL)


def _port(jcfg):
    return ModelConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def xcfg():
    jcfg = jax_smoke_variant(jax_get_config("xlstm-125m")).replace(
        d_model=32, rnn_width=32, num_heads=H, num_kv_heads=H)
    return jcfg, _port(jcfg)


KEYS = {"mlstm": ("C", "n", "m"), "slstm": ("c", "n", "h", "m")}


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("carried", [False, True])
def test_block_grads_match_jax(one_torch_thread, xcfg, kind, carried):
    jcfg, cfg = xcfg
    B, T = 3, 10
    jp = JL.split_tree(getattr(JL, "init_" + kind)(jax.random.key(5),
                                                   jcfg))[0]
    jp = {k: jnp.asarray(v) for k, v in jp.items()}
    tp = {k: tensor_from_numpy(np.asarray(v), "cpu").requires_grad_(True)
          for k, v in jp.items()}
    japply, tapply = getattr(JL, "apply_" + kind), getattr(TL, "apply_" + kind)
    rng = np.random.default_rng(21 + carried)
    x = rng.normal(size=(B, T, cfg.d_model)).astype(np.float32)
    valid = np.ones((B, T), bool)
    valid[0, :3] = False  # left pads
    valid[2, 6:] = False  # frozen from step 6
    jstate = tstate = None
    if carried:  # the state after a 5-token prefix: m finite
        x0 = rng.normal(size=(B, 5, cfg.d_model)).astype(np.float32)
        _, jstate = japply(jp, jnp.asarray(x0), jcfg)
        tstate = {k: torch.from_numpy(np.array(a)).requires_grad_(True)
                  for k, a in zip(KEYS[kind], jstate)}
    cy = rng.normal(size=(B, T, cfg.d_model)).astype(np.float32)

    def jloss(p, xx, st):
        y, s = japply(p, xx, jcfg, st, update_mask=jnp.asarray(valid))
        tail = sum(jnp.sum(jnp.where(jnp.isfinite(a), a, 0.0) * (i + 1))
                   for i, a in enumerate(s))
        return jnp.sum(y * cy) + 0.1 * tail

    argn = (0, 1, 2) if carried else (0, 1)
    jg = jax.grad(jloss, argnums=argn)(jp, jnp.asarray(x), jstate)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, s = tapply(tp, tx, cfg, tstate, update_mask=torch.from_numpy(valid))
    tail = sum(torch.where(torch.isfinite(s[k]), s[k], 0.0).sum() * (i + 1)
               for i, k in enumerate(KEYS[kind]))
    loss = (y * torch.from_numpy(cy)).sum() + 0.1 * tail
    leaves = [*tp.values(), tx] + (list(tstate.values()) if carried else [])
    tg = torch.autograd.grad(loss, leaves, allow_unused=True)
    want = [np.asarray(jg[0][k]) for k in tp] + [np.asarray(jg[1])]
    if carried:
        want += [np.asarray(a) for a in jg[2]]
    names = [*tp, "x"] + ([f"state.{k}" for k in KEYS[kind]]
                          if carried else [])
    for name, g, w in zip(names, tg, want):
        assert g is not None, name
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **JAX_TOL)


def test_meta_branch_shapes_and_work():
    B, T, hd, K = 3, 10, 8, 4
    m = dict(device="meta")
    seen = []
    with kwork.collect(lambda n, f, b: seen.append((n, f, b))):
        q = torch.empty((T, B, H, hd), dtype=torch.bfloat16, **m)
        g = torch.empty((T, B, H), **m)
        C0 = torch.empty((B, H, hd, hd), **m)
        n0, m0 = torch.empty((B, H, hd), **m), torch.empty((B, H), **m)
        h, cn, mm = xo.mlstm_scan(q, q, q, g, g, C0, n0, m0)
        assert (h.shape, cn.shape, mm.shape) == (
            (T, B, H, hd), (B, H, hd, hd + 1), (B, H))
        _, cn, mm = xo.mlstm_scan(q, q, q, g, g, C0, n0, m0, collect=True)
        assert (cn.shape, mm.shape) == ((B, T + 1, H, hd, hd + 1),
                                        (B, T + 1, H))
        *_, (ck, mck, s) = xo.mlstm_scan_fwd(q, q, q, g, g, C0, n0, m0,
                                             ckpt_every=K)
        assert (ck.shape, mck.shape, s.shape) == (
            (3, B, H, hd, hd + 1), (3, B, H), (T, B, H))
        gr = xo.mlstm_scan_bwd(q, q, q, g, g, None, h, s, ck, mck, K, h,
                               cn[:, 0], mm[:, 0])
        assert [tuple(t.shape) for t in gr] == [
            (T, B, H, hd)] * 3 + [(T, B, H)] * 2 + [
            (B, H, hd, hd), (B, H, hd), (B, H)]
        z = torch.empty((T, H, B, hd), **m)
        R = torch.empty((H, hd, hd), **m)
        cnh0, sm0 = torch.empty((3, H, B, hd), **m), torch.empty((H, B, hd),
                                                                 **m)
        hs, cnh, sm = xo.slstm_scan(z, z, z, z, R, cnh0, sm0)
        assert (hs.shape, cnh.shape, sm.shape) == (
            (T, H, B, hd), (3, H, B, hd), (H, B, hd))
        *_, sck = xo.slstm_scan_fwd(z, z, z, z, R, cnh0, sm0, ckpt_every=K)
        assert sck.shape == (3, 3, H, B, hd)
        gr = xo.slstm_scan_bwd(z, z, z, z, R, sm0, None, hs, sck, K, hs,
                               cnh, sm)
        assert [tuple(t.shape) for t in gr] == [(T, H, B, hd)] * 4 + [
            (H, hd, hd), (3, H, B, hd), (H, B, hd)]
    names = [n for n, _, _ in seen]
    assert names == ["mlstm_scan"] * 3 + ["mlstm_scan_bwd", "slstm_scan",
                                          "slstm_scan", "slstm_scan_bwd"]
    assert seen[0][1:] == xo.mlstm_work(T, B, H, hd, 2)
    assert seen[1][1:] == xo.mlstm_work(T, B, H, hd, 2, collect=True)
    assert seen[3][1:] == xo.mlstm_bwd_work(T, B, H, hd, 2, K)
    assert seen[6][1:] == xo.slstm_bwd_work(T, B, H, hd, K)
    assert all(f > 0 and b > 0 for _, f, b in seen)
    # the forward's flops grow with T and hd² (the state's elements)
    f1, _ = xo.mlstm_work(T, B, H, hd, 2)
    f2, _ = xo.mlstm_work(2 * T, B, H, hd, 2)
    assert f2 == 2 * f1 == 2 * xo.MLSTM_OPS_PER_ELEM * T * B * H * hd * (
        hd + 1)


def test_phase3e_cases_on_cpu(one_torch_thread):
    """``chip_smoke.xl_case`` with the wrappers' plain versions: every
    kind of 3e case runs through (both blocks), and each comparison is
    exact (the plain version against itself); the autograd witness's
    case holds the plain walk to autograd within ``XLSTM_TOL``."""
    cs = _chip_smoke()
    small = [("verify", 3, 5, 8, "bfloat16", "carried", "frozen row", False,
              True, None),
             ("commit", 8, 5, 8, "bfloat16", "carried", "frozen row", True,
              False, None),
             ("edges", 3, 11, 8, "float32", "tie",
              "left pads + frozen row", False, False, 5),
             (cs.XLSTM_AUTOGRAD_CASE, 2, 9, 8, "float32", "carried",
              "left pads", False, False, 4)]
    for block in ("mlstm", "slstm"):
        for i, c in enumerate(small):
            r = cs.xl_case(torch, np, None, "cpu", block, c, i, dev="cpu")
            assert r["err"] == 0.0
            assert r["bwd_err"] in (None, 0.0)
            if c[0] == cs.XLSTM_AUTOGRAD_CASE:
                assert 0.0 <= r["autograd_err"] <= cs.XLSTM_TOL["bwd"]
