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
  tensors, the backward's arguments);
* the kernels' launch plans against the card's limits, and the
  decompositions of the mLSTM forward (its block-deferred read), the
  mLSTM backward and the sLSTM backward (the recompute, the walk's split
  product, dR's ranges) modelled in torch against the plain versions.
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


# ---------------------------------------------------------------------------
# the kernels' launch plans and the mLSTM backward's decomposition
# ---------------------------------------------------------------------------

N_SM = 132  # an H100's SMs
SM_SMEM = 233_472  # bytes of shared memory a SM holds (1 KB of it per CTA)


@pytest.mark.parametrize("hd", [40, 64, 192, 224])
def test_launch_plans_fit_the_card(hd):
    """Every plan at B 1..64 on 132 SMs: threads a CTA a multiple of 32 and
    at most 1,024, shared memory within a CTA's 227 KB, the sLSTM
    forward's grid and the sLSTM backward's three grids in one wave (one
    CTA a SM for the forward, the walk and the recompute) with the
    slices covering hd, the mLSTM forward's and backward's three CTAs a
    SM within the SM's shared memory and 13b's grids (B 16, 4 heads of
    192) in one wave."""
    for H in (1, 4):
        for B in range(1, 65):
            sp = xo.slstm_fwd_plan(B, H, hd, N_SM)
            assert sp["threads"] % 32 == 0 and sp["threads"] <= 1024
            assert sp["threads"] >= -(-hd // sp["cols"]) * sp["p"]
            assert sp["smem"] <= xo.SMEM_MAX
            assert sp["ctas"] == H * -(-B // sp["rows"]) <= N_SM
            assert sp["waves"] == 1 and sp["cluster"] == 1
            assert sp["len"] % 4 == 0 and sp["p"] * sp["len"] >= hd
            assert 1 <= sp["rows"] <= sp["rows_compiled"] <= xo.SLSTM_MAX_ROWS
            assert sp["rows_compiled"] in (1, 2, 4)
            for T, K in ((4096, 64), (37, 5)):
                bp = xo.slstm_bwd_plan(B, H, hd, T, K, N_SM)
                # the walk: the forward's split on R's rows and its grid
                assert (bp["p"], bp["cols"], bp["len"], bp["rows"],
                        bp["threads"]) == (sp["p"], sp["cols"], sp["len"],
                                           sp["rows"], sp["threads"])
                assert bp["ctas"] == sp["ctas"] and bp["waves"] == 1
                assert bp["cluster"] == 1
                for key in ("smem", "rec_smem", "dr_smem"):
                    assert 0 < bp[key] <= xo.SMEM_MAX, key
                assert bp["rec_ctas"] <= N_SM and bp["rec_waves"] == 1
                assert bp["rec_ctas"] % H == 0
                assert 1 <= bp["dr_splits"] <= xo.SLSTM_DR_MAX_SPLIT
                assert bp["dr_ctas"] == bp["dr_tiles"] * H * bp["dr_splits"]
                assert bp["dr_tiles"] == (-(-hd // xo.SLSTM_DR_TILE)) ** 2
                assert bp["scratch_floats"] == (
                    bp["ctas"] * K * xo.SLSTM_BWD_FIELDS * bp["rows"] * hd
                    + bp["dr_splits"] * H * hd * hd)
            if hd > xo.MLSTM_MAX_HD:
                continue
            fp = xo.mlstm_fwd_plan(B, H, hd, N_SM)
            assert fp["threads"] == xo.MLSTM_THREADS <= 1024
            assert fp["block"] == xo.MLSTM_THREADS // 32  # a warp a step
            assert fp["smem"] <= xo.SMEM_MAX
            assert fp["ctas_per_sm"] * (fp["smem"] + 1024) <= SM_SMEM
            assert fp["ring_bytes"] < fp["smem"]
            assert fp["ctas"] == -(-hd // xo.MLSTM_COLS) * B * H
            assert fp["waves"] == -(-fp["ctas"] // (fp["ctas_per_sm"] * N_SM))
            mp = xo.mlstm_bwd_plan(B, H, hd, xo.CKPT_EVERY, N_SM)
            assert mp["threads"] == xo.MLSTM_THREADS <= 1024
            assert mp["smem"] <= xo.SMEM_MAX
            assert mp["ctas_per_sm"] * (mp["smem"] + 1024) <= SM_SMEM
            assert mp["ctas"] == -(-hd // xo.MLSTM_COLS) * B * H
            assert mp["waves"] == -(-mp["ctas"] // (mp["ctas_per_sm"] * N_SM))
            assert mp["groups"] == -(-xo.CKPT_EVERY // mp["group"])
    tr = xo.mlstm_bwd_plan(16, 4, 192, xo.CKPT_EVERY, N_SM)
    assert tr["waves"] == 1 and tr["ctas"] == 384
    assert tr["scratch_bytes"] == 384 * 16 * xo.MLSTM_GROUP_FLOATS * 4
    tf = xo.mlstm_fwd_plan(16, 4, 192, N_SM)
    assert tf["waves"] == 1 and tf["ctas"] == 384 and tf["smem"] == 72_448
    # the staged rows (collect) pad hd + 1 to whole 32-byte sectors
    for d in (8, 40, 64, 191, 192):
        srs = xo.mlstm_staged_row(d)
        assert srs % 8 == 0 and d + 1 <= srs < d + 9
    tb = xo.slstm_bwd_plan(16, 4, 192, 4096, xo.CKPT_EVERY, N_SM)
    assert (tb["ctas"], tb["rec_ctas"], tb["dr_ctas"]) == (64, 132, 576)
    assert tb["dr_splits"] == 16


def test_launch_plans_refuse_what_the_kernels_refuse():
    with pytest.raises(ValueError):
        xo.slstm_split(xo.SLSTM_MAX_HD + 1)
    with pytest.raises(ValueError):
        xo.slstm_fwd_plan(4, 4, 0, N_SM)
    with pytest.raises(ValueError):
        xo.mlstm_bwd_plan(4, 4, xo.MLSTM_MAX_HD + 1, 16, N_SM)
    for hd in (0, xo.MLSTM_MAX_HD + 1):
        with pytest.raises(ValueError):
            xo.mlstm_fwd_plan(4, 4, hd, N_SM)
    for hd in (0, xo.SLSTM_MAX_HD + 1):
        with pytest.raises(ValueError):
            xo.slstm_bwd_plan(4, 4, hd, 64, 16, N_SM)
    for K in (0, xo.KMAX + 1):
        with pytest.raises(ValueError):
            xo.mlstm_bwd_plan(4, 4, 64, K, N_SM)
        with pytest.raises(ValueError):
            xo.slstm_bwd_plan(4, 4, 64, 64, K, N_SM)
    # the split reaches every k once: the slices tile [0, p len)
    for hd in (1, 9, 40, 64, 191, 192, 193, 224):
        p, c, L = xo.slstm_split(hd)
        ks = np.concatenate([np.arange(s * L, (s + 1) * L) for s in range(p)])
        assert np.array_equal(ks, np.arange(p * L)) and p * L >= hd
        assert (p, c) == ((8, 4) if hd <= 192 else (4, 2))


def _mlstm_bwd_model(q, k, v, i_pre, f_pre, upd, h, s, ckpt, mck, K, dh, dCn,
                     dm):
    """The mLSTM backward kernel's decomposition on the CPU (its plan from
    ``mlstm_bwd_plan``): chunks of K from the last; a chunk's gates from
    its checkpoint's m, then level 1 from its checkpoint keeping the state
    before each group's first step; groups walked from the last, a step's
    state re-formed from its group's. Per column block of 32 (the CTA):
    the partial row sums of dq and dk (a last block holds the n column's
    terms), dv over its rows a warp at a time then over the warps in
    order, and (dfg, dig, the denominator's dm) over its elements. The
    reduce pass sums the blocks in order and walks the stabilizer's chain
    back."""
    T, B, H, hd = q.shape
    plan = xo.mlstm_bwd_plan(B, H, hd, K, N_SM)
    grp, njb = plan["group"], plan["col_blocks"]
    rpt = -(-hd // 8)
    logf = torch.nn.functional.logsigmoid(f_pre)
    v1 = torch.cat([v, torch.ones_like(v[..., :1])], -1)
    G = dCn.clone()
    dq_part = torch.zeros((T, B, H, njb + 1, hd))
    dk_part = torch.zeros((T, B, H, njb + 1, hd))
    sc = torch.zeros((T, B, H, njb, 4))
    dv = torch.zeros((T, B, H, hd))
    ones = torch.ones((B, 1), dtype=torch.bool)

    def cols(x, jb):  # a CTA's columns of [C|n]'s first hd
        return x[..., jb * 32:min(hd, (jb + 1) * 32)]

    for c in range(xr.ckpt_count(T, K) - 1, -1, -1):
        t0, t1 = c * K, min(T, (c + 1) * K)
        mp, gates = mck[c], []
        for t in range(t0, t1):
            a = logf[t] + mp
            mx = torch.maximum(a, i_pre[t])
            mn = torch.where(torch.isfinite(mx), mx, i_pre[t])
            fg = torch.where(torch.isfinite(mp), torch.exp(a - mn), 0.0)
            u = ones if upd is None else upd[t][:, None]
            gates.append((fg, torch.exp(i_pre[t] - mn), mn, u))
            sc[t, :, :, 0, 3] = mp
            mp = torch.where(u, mn, mp)

        def kv_of(t):
            return (k[t, ..., :, None] * v1[t, ..., None, :]).float()

        def step(P, t):
            fg, ig, _, u = gates[t - t0]
            return torch.where(u[..., None, None], fg[..., None, None] * P
                               + ig[..., None, None] * kv_of(t), P)

        P, kept = ckpt[c], {}
        for t in range(t0, t1):
            if (t - t0) % grp == 0:
                kept[(t - t0) // grp] = P
            P = step(P, t)
        for g in range(-(-(t1 - t0) // grp) - 1, -1, -1):
            for t in range(min(t1, t0 + (g + 1) * grp) - 1, t0 + g * grp - 1,
                           -1):
                P = kept[g]
                for t2 in range(t0 + g * grp, t):
                    P = step(P, t2)
                fg, ig, mn, u = gates[t - t0]
                fg4, ig4 = fg[..., None, None], ig[..., None, None]
                kv = kv_of(t)
                new = fg4 * P + ig4 * kv
                e = torch.exp(-mn)
                sa = s[t].abs()
                den = torch.maximum(sa, e)
                ws = (sa > e).float() + 0.5 * (sa == e).float()
                dden = -(dh[t] * h[t]).sum(-1) / den
                dr = torch.cat([dh[t] / den[..., None],
                                (dden * ws * torch.sign(s[t]))[..., None]], -1)
                gnew = (torch.where(u[..., None, None], G, 0.0)
                        + q[t].float()[..., :, None] * dr[..., None, :])
                tq = new * dr[..., None, :]
                dkv = ig4 * gnew
                tk = torch.cat([dkv[..., :hd] * v[t].float()[..., None, :],
                                dkv[..., hd:]], -1)
                for jb in range(njb):
                    dq_part[t, :, :, jb] = cols(tq, jb).sum(-1)
                    dk_part[t, :, :, jb] = cols(tk, jb).sum(-1)
                    w_el = cols(gnew * P, jb).sum((-1, -2))
                    w_ig = cols(gnew * kv, jb).sum((-1, -2))
                    if jb == 0:  # the lead CTA carries the n column
                        w_el = w_el + (gnew * P)[..., hd].sum(-1)
                        w_ig = w_ig + (gnew * kv)[..., hd].sum(-1)
                    sc[t, :, :, jb, 0], sc[t, :, :, jb, 1] = w_el, w_ig
                dq_part[t, :, :, njb] = tq[..., hd]
                dk_part[t, :, :, njb] = tk[..., hd]
                terms = dkv[..., :hd] * k[t].float()[..., :, None]
                warps = [terms[..., w * rpt:(w + 1) * rpt, :].sum(-2)
                         for w in range(8)]
                acc = torch.zeros_like(warps[0])
                for x in warps:
                    acc = acc + x
                dv[t] = acc
                sc[t, :, :, 0, 2] = -(dden * (1.0 - ws)) * e
                G = torch.where(u[..., None, None], 0.0, G) + fg4 * gnew
    dq, dk = torch.zeros((T, B, H, hd)), torch.zeros((T, B, H, hd))
    for jb in range(njb + 1):
        dq, dk = dq + dq_part[:, :, :, jb], dk + dk_part[:, :, :, jb]
    sums = sc[..., :3].sum(-2)
    di, df = torch.zeros((T, B, H)), torch.zeros((T, B, H))
    gm = dm.clone()
    for t in range(T - 1, -1, -1):
        u = ones if upd is None else upd[t][:, None]
        a, mx, _, fin, fg, ig = xr._gates(logf[t], i_pre[t], sc[t, :, :, 0, 3])
        di[t], df[t], da = xr._gates_bwd(
            f_pre[t], i_pre[t], a, mx, fin, fg, ig, sums[t, ..., 0],
            sums[t, ..., 1], torch.where(u, gm, 0.0) + sums[t, ..., 2])
        gm = torch.where(u, 0.0, gm) + da
    return dq, dk, dv, di, df, G[..., :hd], G[..., hd], gm


# (B, T, hd, dtype, state, masks, K): T not a multiple of K, hd 40 (a
# column block half full), a tie in the stabilizer's max, m = -inf, pads
BWD_MODEL_CASES = {
    "tie_pads_hd40": (3, 13, 40, "float32", "tie", "left pads + frozen row",
                      5),
    "fresh": (2, 11, 8, "float32", "fresh", None, 4),
    "bf16_pads": (2, 10, 16, "bfloat16", "carried", "left pads", 6),
}


@pytest.mark.parametrize("case", sorted(BWD_MODEL_CASES))
def test_mlstm_bwd_decomposition_matches_the_walk(one_torch_thread, case):
    cs = _chip_smoke()
    B, T, hd, dtype, state, masks, K = BWD_MODEL_CASES[case]
    args = cs.mlstm_inputs(torch, np, B, T, hd, dtype, state, masks, 70,
                           dev="cpu", H=2)
    q, k, v, i_pre, f_pre, C0, n0, m0, upd = args
    h, cn, m, (ck, mck, s) = xr.mlstm_scan_ref(*args, ckpt_every=K)
    cots = _cotangents((h, cn, m), 8)
    cots[2] = torch.where(torch.isfinite(m), cots[2], 0.0)
    bargs = (q, k, v, i_pre, f_pre, upd, h, s, ck, mck, K, *cots)
    got = _mlstm_bwd_model(*bargs)
    want = xr.mlstm_scan_bwd_ref(*bargs)
    for name, g, w in zip(("dq", "dk", "dv", "di", "df", "dC0", "dn0", "dm0"),
                          got, want):
        _, rel = cs.xl_err(torch, g, w, name)
        assert rel <= cs.XLSTM_TOL["bwd"], (name, rel)


# ---------------------------------------------------------------------------
# the mLSTM forward's block-deferred read and the sLSTM backward's
# decomposition, modelled on the CPU
# ---------------------------------------------------------------------------

def _fma(a, b, c):
    """fmaf: a b + c rounded once (float64 holds the float32 product
    exactly)."""
    return (a.double() * b.double() + c.double()).float()


def _butterfly(x):
    """x's last axis (a lane each) summed by the kernels' xor shuffles:
    lane l plus lane l ^ o for o = n/2, ..., 1; every lane ends with the
    same sum."""
    n = x.shape[-1]
    idx = torch.arange(n)
    o = n // 2
    while o >= 1:
        x = x + x[..., idx ^ o]
        o //= 2
    return x[..., 0]


def _log_sigmoid(x):
    """The kernels' log sigmoid: min(0, x) - log1p(exp(-|x|))."""
    return torch.minimum(torch.zeros_like(x), x) - torch.log1p(
        torch.exp(-x.abs()))


def _mlstm_fwd_model(q, k, v, i_pre, f_pre, C0, n0, m0, upd=None, com=None,
                     collect=False, ckpt_every=None):
    """The mLSTM forward kernel's decomposition on the CPU (its plan from
    ``mlstm_fwd_plan``): the stabilizer's gates a block of ``block`` steps
    at a time (the chain through the block, as the kernel's gate() forms
    it); each element of [C|n] stepped as ``cell_update`` steps it; the
    read deferred to the block's end: a step's column partial a warp (its
    rpt rows, four fused accumulators by row mod 4) and q_i n_i a thread
    (lane l of warp w carrying row w rpt + l), folded once the block is
    done: the columns over the warps in order, q.n a lane over the warps
    in order and then a xor butterfly. Staged states go into rows padded
    to ``mlstm_staged_row`` and come back as the view of hd + 1 columns."""
    T, B, H, hd = q.shape
    plan = xo.mlstm_fwd_plan(B, H, hd, N_SM)
    S, warps = plan["block"], xo.MLSTM_THREADS // 32
    rpt = -(-hd // warps)
    ones = torch.ones((B, 1), dtype=torch.bool)
    logf = _log_sigmoid(f_pre)
    Cn = torch.cat([C0, n0[..., None]], -1).clone()
    m = m0.clone()
    out_at = xo._out_at(com, T, B, "cpu")
    h = torch.zeros((T, B, H, hd))
    s_hist = torch.zeros((T, B, H))
    srs = xo.mlstm_staged_row(hd)
    stage = torch.zeros((B, T + 1, H, hd, srs))[..., :hd + 1]
    m_stage = torch.zeros((B, T + 1, H))
    stage[:, 0], m_stage[:, 0] = Cn, m
    Cn_out, m_out = Cn.clone(), m.clone()
    ck, mck = [], []
    # lane l of warp w carries row w rpt + l of n (l < rpt)
    lane_row = torch.tensor([[w * rpt + lane if lane < rpt else hd
                              for lane in range(32)] for w in range(warps)])
    for blk in range(-(-T // S)):
        steps = range(blk * S, min(T, (blk + 1) * S))
        gates = []
        for t in steps:  # the block's gates at once
            a = logf[t] + m
            mx = torch.maximum(a, i_pre[t])
            mn = torch.where(torch.isfinite(mx), mx, i_pre[t])
            u = ones if upd is None else upd[t][:, None]
            gates.append((torch.where(torch.isfinite(m), torch.exp(a - mn),
                                      0.0), torch.exp(i_pre[t] - mn), u, m,
                          torch.exp(-mn)))
            m = torch.where(u, mn, m)
            gates[-1] += (m,)
        parts, tots = [], []
        for t, (fg, ig, u, mp, e, ma) in zip(steps, gates):
            if ckpt_every and t % ckpt_every == 0:
                ck.append(Cn.clone())
                mck.append(mp.clone())
            kv = (k[t][..., :, None] * v[t][..., None, :]).float()
            new = torch.cat([fg[..., None, None] * Cn[..., :hd]
                             + ig[..., None, None] * kv,
                             (fg[..., None] * Cn[..., hd]
                              + ig[..., None] * k[t].float())[..., None]], -1)
            qf = q[t].float()
            part = []
            for w in range(warps):
                acc = [torch.zeros((B, H, hd)) for _ in range(4)]
                for r in range(rpt):
                    kk = w * rpt + r
                    if kk < hd:
                        acc[r % 4] = _fma(qf[..., kk, None], new[..., kk, :hd],
                                          acc[r % 4])
                part.append((acc[0] + acc[1]) + (acc[2] + acc[3]))
            qn = torch.cat([qf * new[..., hd], torch.zeros((B, H, 1))], -1)
            lanes = torch.zeros((B, H, 32))
            for w in range(warps):
                lanes = lanes + qn[..., lane_row[w]]
            parts.append(part)
            tots.append(_butterfly(lanes))
            Cn = torch.where(u[..., None, None], new, Cn)
            if collect:
                stage[:, t + 1], m_stage[:, t + 1] = Cn, ma
            sel = (out_at == t)[:, None]
            Cn_out = torch.where(sel[..., None, None], Cn, Cn_out)
            m_out = torch.where(sel, ma, m_out)
        for t, part, tot, gate in zip(steps, parts, tots, gates):  # the fold
            rd = torch.zeros((B, H, hd))
            for x in part:
                rd = rd + x
            h[t] = rd / torch.maximum(tot.abs(), gate[4])[..., None]
            s_hist[t] = tot
    out = (h, stage, m_stage) if collect else (h, Cn_out, m_out)
    if ckpt_every:
        out += ((torch.stack(ck), torch.stack(mck), s_hist),)
    return out


# (B, T, hd, dtype, state, masks, collect, commit_upto?, K): T not a
# multiple of the block, hd 40 (5 rows a warp), a tie, m = -inf, pads, a
# frozen row, the staged states and the committed carry
FWD_MODEL_CASES = {
    "tie_pads_hd40_commit": (3, 13, 40, "float32", "tie",
                             "left pads + frozen row", False, True, 5),
    "fresh_collect_bf16": (2, 11, 16, "bfloat16", "fresh", None, True, False,
                           None),
    "carried_frozen_collect": (3, 9, 8, "float32", "carried", "frozen row",
                               True, False, None),
}


@pytest.mark.parametrize("case", sorted(FWD_MODEL_CASES))
def test_mlstm_fwd_block_deferred_read_matches_the_loop(one_torch_thread,
                                                         case):
    cs = _chip_smoke()
    B, T, hd, dtype, state, masks, collect, commit, K = FWD_MODEL_CASES[case]
    args = cs.mlstm_inputs(torch, np, B, T, hd, dtype, state, masks, 71,
                           dev="cpu", H=2)
    upd = args[-1]
    com = None
    if commit:
        com = cs.xl_commit(torch, B, T, upd if upd is not None else
                           torch.ones((T, B), dtype=torch.bool), "cpu")
    kw = dict(com=com, collect=collect, ckpt_every=K)
    got = _mlstm_fwd_model(*args, **kw)
    want = xr.mlstm_scan_ref(*args, **kw)
    assert got[1].shape == want[1].shape
    if collect:  # the view of padded rows
        assert got[1].stride(-2) == xo.mlstm_staged_row(hd) != hd + 1
    pairs = list(zip(("h", "[C|n]", "m"), got[:3], want[:3]))
    if K:
        pairs += list(zip(("ckpt", "mck", "q.n"), got[3], want[3]))
    for name, g, w in pairs:
        _, rel = cs.xl_err(torch, g, w, name)
        assert rel <= cs.XLSTM_TOL["fwd"], (name, rel)


def _split_product(x, W):
    """x (N, hd) W (hd, hd) as the sLSTM kernels split it (``slstm_split``):
    p slices of len k's, four fused accumulators a slice by k mod 4,
    combined (a0 + a1) + (a2 + a3), the slices met by a xor butterfly:
    the forward's h_{t-1} R_h, the backward's recompute of it and dz
    R_h^T."""
    hd = W.shape[0]
    p, _, L = xo.slstm_split(hd)
    parts = []
    for s in range(p):
        acc = [torch.zeros((x.shape[0], hd)) for _ in range(4)]
        for kk in range(s * L, min(hd, (s + 1) * L)):
            acc[kk % 4] = _fma(x[:, kk:kk + 1], W[kk:kk + 1], acc[kk % 4])
        parts.append((acc[0] + acc[1]) + (acc[2] + acc[3]))
    return _butterfly(torch.stack(parts, -1))


def _slstm_bwd_model(z_in, i_in, f_in, o_sig, R, h0, upd, hs, ckpt, K, dhs,
                     dcnh, dm):
    """The sLSTM backward's decomposition on the CPU (``slstm_bwd_plan``):
    z of every (t, b) recomputed at once by the forward's split product;
    the walk a chunk of K at a time from the last, each chunk's chain
    first (the gates, the max's case and the state before every step
    kept), then its steps back with dh_{t-1} = dz_t R_h^T by the split
    product on R's rows; dR over ``slstm_dr_splits`` fixed ranges of rows
    p = t B + b, each output summed over its range in order, then the
    ranges in order."""
    T, H, B, hd = z_in.shape
    hp = torch.cat([h0[None], hs[:-1]])  # h_{t-1}
    z = torch.stack([torch.tanh(z_in[:, hh] + _split_product(
        hp[:, hh].reshape(T * B, hd), R[hh]).reshape(T, B, hd))
        for hh in range(H)], 1)
    gc, gn, gh = (x.clone() for x in dcnh.unbind(0))
    gm = dm.clone()
    dz, di, df, do = (torch.zeros_like(z_in) for _ in range(4))
    for c in range(xr.ckpt_count(T, K) - 1, -1, -1):
        t0, t1 = c * K, min(T, (c + 1) * K)
        cc, nn, mp = ckpt[c].unbind(0)
        kept = []
        for t in range(t0, t1):  # the chunk's chain
            i = i_in[t]
            a = _log_sigmoid(f_in[t]) + mp
            mx = torch.maximum(a, i)
            mn = torch.where(torch.isfinite(mx), mx, i)
            fg = torch.where(torch.isfinite(mp), torch.exp(a - mn), 0.0)
            ig = torch.exp(i - mn)
            case = torch.where(torch.isfinite(mx), torch.where(
                a > i, 0, torch.where(a < i, 1, 2)), 3)
            u = (torch.ones((1, B, 1), dtype=torch.bool) if upd is None
                 else upd[t][None, :, None])
            kept.append((cc, nn, fg, ig, case, torch.isfinite(mp),
                         1.0 / (1.0 + torch.exp(f_in[t])), u))
            cc = torch.where(u, fg * cc + ig * z[t], cc)
            nn = torch.where(u, fg * nn + ig, nn)
            mp = torch.where(u, mn, mp)
        for t in range(t1 - 1, t0 - 1, -1):  # the walk back
            cp, np_, fg, ig, case, fin, sig, u = kept[t - t0]
            cn, nw = fg * cp + ig * z[t], fg * np_ + ig
            den = torch.clamp(nw, min=1e-6)
            oc = o_sig[t] * cn
            g = gh + dhs[t]
            da_ = g / den
            dc = gc + da_ * o_sig[t]
            dn = gn + torch.where(nw >= 1e-6, -g * oc / (den * den), 0.0)
            dfg, dig = dc * cp + dn * np_, dc * z[t] + dn
            dzz = dc * ig * (1 - z[t] * z[t])
            dii = dig * ig
            dmn = gm - dii
            da = torch.where(fin, dfg * fg, 0.0)
            dmn = dmn - da
            da = da + torch.where(case == 0, dmn, torch.where(
                case == 2, 0.5 * dmn, 0.0))
            dii = dii + torch.where(case == 1, dmn, torch.where(
                case == 2, 0.5 * dmn, torch.where(case == 3, dmn, 0.0)))
            dz[t] = torch.where(u, dzz, 0.0)
            di[t] = torch.where(u, dii, 0.0)
            df[t] = torch.where(u, da * sig, 0.0)
            do[t] = torch.where(u, da_ * cn, 0.0)
            gc = torch.where(u, fg * dc, gc)
            gn = torch.where(u, fg * dn, gn)
            gm = torch.where(u, da, gm)
            rt = torch.stack([_split_product(dz[t, hh], R[hh].T)
                              for hh in range(H)])
            gh = torch.where(u, rt, g)
    nsplit = xo.slstm_dr_splits(T, B)
    per = -(-T * B // nsplit)
    dR = torch.zeros_like(R)
    for hh in range(H):
        X = hp[:, hh].reshape(T * B, hd)
        D = dz[:, hh].reshape(T * B, hd)
        for q in range(nsplit):
            acc = torch.zeros((hd, hd))
            for p in range(q * per, min(T * B, (q + 1) * per)):
                acc = _fma(X[p][:, None], D[p][None, :], acc)
            dR[hh] = dR[hh] + acc
    return dz, di, df, do, dR, torch.stack([gc, gn, gh]), gm


# 3e's edges, ragged and rows cases cut to a few steps, (B, T, hd, state,
# masks, K): a tie, m = -inf, left pads and a frozen row, hd 40, T not a
# multiple of K, and 64 rows (two a walk's CTA at 4 heads)
BWD_SLSTM_MODEL_CASES = {
    "edges": (3, 9, 64, "tie", "left pads + frozen row", 4),
    "ragged": (2, 9, 40, "fresh", None, 4),
    "rows": (64, 3, 192, "carried", "left pads", 2),
}


@pytest.mark.parametrize("case", sorted(BWD_SLSTM_MODEL_CASES))
def test_slstm_bwd_decomposition_matches_the_walk(one_torch_thread, case):
    cs = _chip_smoke()
    B, T, hd, state, masks, K = BWD_SLSTM_MODEL_CASES[case]
    H = cs.XLSTM_HEADS
    if case == "rows":
        assert xo.slstm_bwd_plan(B, H, hd, T, K, N_SM)["rows"] == 2
    args = cs.slstm_inputs(torch, np, B, T, hd, state, masks, 72, dev="cpu",
                           H=H)
    z_in, i_in, f_in, o_sig, R, cnh0, m0, upd = args
    hs, cnh, m, ck = xr.slstm_scan_ref(*args, ckpt_every=K)
    cots = _cotangents((hs, cnh, m), 9)
    cots[2] = torch.where(torch.isfinite(m), cots[2], 0.0)
    bargs = (z_in, i_in, f_in, o_sig, R, cnh0[2].contiguous(), upd, hs, ck,
             K, *cots)
    got = _slstm_bwd_model(*bargs)
    want = xr.slstm_scan_bwd_ref(*bargs)
    for name, g, w in zip(("dz", "di", "df", "do", "dR", "dcnh0", "dm0"),
                          got, want):
        _, rel = cs.xl_err(torch, g, w, name)
        assert rel <= cs.XLSTM_TOL["bwd"], (name, rel)
