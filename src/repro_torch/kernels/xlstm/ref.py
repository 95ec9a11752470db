"""Plain PyTorch versions of the xLSTM recurrence kernels
(``csrc/mlstm.cu``, ``csrc/slstm.cu``): the reference's ``lax.scan`` of
``repro.models.layers.apply_mlstm`` / ``apply_slstm`` stepped in Python,
and the reverse walks of their backward kernels.

The forwards are the loops the model ran before the kernels, moved here
with their arithmetic unchanged; ``ckpt_every`` K adds what the backward
walk starts from (the state before every K-th step, and for the mLSTM
the per-step q·n). The backwards follow the kernels' walk: chunks of K
steps from the last to the first, each recomputed from its checkpoint
(the states before its steps kept), then walked in reverse. Nothing is
divided back out of the recurrence (the forget gate can be ~0).

Layouts are the model's time-major ones. mLSTM: q, k, v (T, B, H, hd) in
the model dtype, i_pre and f_pre (T, B, H) float32, the state C (B, H,
hd, hd), n (B, H, hd), m (B, H) float32, and [C|n] carried as one (B, H,
hd, hd+1) tensor. sLSTM: z_in, i_in, f_in and o_sig (T, H, B, hd)
float32 (o_sig after its sigmoid), R (H, hd, hd), [c, n, h] as one (3, H,
B, hd) tensor and m (H, B, hd). ``upd`` and ``com`` are
``_gate_masks``' (T, B) masks, ``com`` None when nothing but the dynamic
state is asked for.

The CPU tests run these; ``chip_smoke.py`` holds the kernels against
them. Nothing on the card path calls them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _finite(x: torch.Tensor) -> torch.Tensor:
    """``isfinite`` in two ops, not four: x - x is 0 exactly when x is
    finite (inf - inf and NaN - NaN are NaN)."""
    return (x - x) == 0


def stabilizer_chain(logf: torch.Tensor, i_pre: torch.Tensor,
                     m0: torch.Tensor, upd, com):
    """The xLSTM blocks' exponential-gate stabilizer m, stepped over T as
    the reference steps it: m_new = max(log σ(f_t) + m, i_t), replaced by
    i_t where not finite, and m advancing only on updated steps. m does
    not depend on the cell, so its chain runs alone, on time-major (T, B,
    ...) gate pre-activations, and the gates come out for every step at
    once: fg_t = exp(log σ(f_t) + m_{t-1} - m_new_t), 0 where m_{t-1} is
    not finite (-inf before the first update: the reference's guard), and
    ig_t = exp(i_t - m_new_t).

    Returns (m_new (T, ...), fg, ig, m_dyn (T, ...) the dynamic m after
    each step, m_com the committed m, or None when ``com`` is ``upd``).
    ``upd``/``com`` are ``_gate_masks``' (T, B) masks shaped to broadcast
    over m's layout, or ``upd`` None (every step updates)."""
    m, m_com = m0, (m0 if com is not upd else None)
    m_new, m_prev, m_dyn = [], [], []
    for t in range(logf.shape[0]):
        mn = torch.maximum(logf[t] + m, i_pre[t])
        mn = torch.where(_finite(mn), mn, i_pre[t])
        m_prev.append(m)
        m = mn if upd is None else torch.where(upd[t], mn, m)
        if m_com is not None:
            m_com = torch.where(com[t], m, m_com)
        m_new.append(mn)
        m_dyn.append(m)
    m_new = torch.stack(m_new)
    m_prev = torch.stack(m_prev)
    fg = torch.where(_finite(m_prev), torch.exp(logf + m_prev - m_new), 0.0)
    ig = torch.exp(i_pre - m_new)
    return m_new, fg, ig, torch.stack(m_dyn), m_com


def _n_chunks(T: int, K: int) -> int:
    return (T + K - 1) // K


def mlstm_scan_ref(q, k, v, i_pre, f_pre, C0, n0, m0,
                   upd: Optional[torch.Tensor] = None,
                   com: Optional[torch.Tensor] = None,
                   collect: bool = False, ckpt_every: Optional[int] = None):
    """The mLSTM recurrence. Returns (h (T, B, H, hd) float32, [C|n], m):
    h_t = (q_t [C|n]_t)[:hd] / max(|q_t · n_t|, exp(-m_new_t)), read from
    the would-be new state also where a step does not update (a pad, a
    frozen row), as in the reference; [C|n] (B, H, hd, hd+1) and m (B, H)
    the dynamic state after the last step, the committed carry with
    ``com``, or with ``collect`` the staged states (B, T+1, H, hd, hd+1)
    and (B, T+1, H), index 0 the state before the block.

    With ``ckpt_every`` K, also (ckpt (NC, B, H, hd, hd+1), mck (NC, B,
    H), s (T, B, H)): the dynamic state before steps 0, K, 2K, ... and
    each step's q·n, what ``mlstm_scan_bwd_ref`` walks from.

    The reference's dtypes step for step: the outer product k_t ⊗ v_t
    formed in the model dtype before the float32 gate multiplies it, q
    upcast only where it meets the float32 state. n_t = fg n + ig k_t is
    the last column of fg [C|n] + ig (k_t ⊗ [v_t, 1]) (k_t · 1 is exact),
    and one product q_t [C|n] gives q_t C and q_t · n. The stabilizer
    steps first (``stabilizer_chain``), the denominators after the loop:
    what is left in the loop is five ops a step (one more to hold frozen
    steps, one more for the committed carry)."""
    T, B, H, hd = q.shape
    upd3 = None if upd is None else upd[..., None]  # (T, B, 1): over m
    com3 = upd3 if com is None else com[..., None]
    m_new, fg, ig, m_dyn, m_com = stabilizer_chain(
        F.logsigmoid(f_pre), i_pre, m0, upd3, com3)
    q32 = q.float()[..., None, :]  # (T, B, H, 1, hd)
    v1 = torch.cat([v, torch.ones_like(v[..., :1])], -1)  # [v_t, 1]
    fg, ig = fg[..., None, None], ig[..., None, None]
    Cn = torch.cat([C0, n0[..., None]], -1)  # (B, H, hd, hd+1)
    Cn_com = Cn if com is not None else None
    reads, staged, ckpt = [], [Cn], []
    for t in range(T):
        if ckpt_every and t % ckpt_every == 0:
            ckpt.append(Cn)
        new = fg[t] * Cn + ig[t] * (k[t, :, :, :, None] * v1[t, :, :, None])
        reads.append(q32[t] @ new)  # (B, H, 1, hd+1)
        Cn = new if upd is None else torch.where(upd3[t, ..., None, None],
                                                 new, Cn)
        if Cn_com is not None:
            Cn_com = torch.where(com3[t, ..., None, None], Cn, Cn_com)
        if collect:
            staged.append(Cn)
    reads = torch.stack(reads)[:, :, :, 0]  # (T, B, H, hd+1)
    denom = torch.maximum(reads[..., hd].abs(), torch.exp(-m_new))
    h = reads[..., :hd] / denom[..., None]
    if collect:
        Cn = torch.stack(staged, 1)
        m = torch.cat([m0[None], m_dyn]).transpose(0, 1)
    elif Cn_com is not None:
        Cn, m = Cn_com, m_com
    else:
        m = m_dyn[-1]
    if not ckpt_every:
        return h, Cn, m
    mck = torch.cat([m0[None], m_dyn[:-1]])[::ckpt_every]
    return h, Cn, m, (torch.stack(ckpt), mck, reads[..., hd])


def _gates(logf, i, mp):
    """One step of the stabilizer from the m before it, as
    ``stabilizer_chain`` forms it: (a = log σ(f) + m, the max, m_new, fin
    = m finite, fg, ig)."""
    a = logf + mp
    mx = torch.maximum(a, i)
    mn = torch.where(_finite(mx), mx, i)
    fin = _finite(mp)
    fg = torch.where(fin, torch.exp(a - mn), 0.0)
    ig = torch.exp(i - mn)
    return a, mx, mn, fin, fg, ig


def _gates_bwd(f, i, a, mx, fin, fg, ig, dfg, dig, dmn):
    """The stabilizer's step backward: from the adjoints of fg, ig and
    m_new to those of i, f and the m before the step. The max hands its
    adjoint to the larger side, half to each on a tie (as torch's and
    JAX's maximum do), and all to i where the max was not finite (the
    guard's ``where``)."""
    dii = dig * ig
    dmn = dmn - dii
    da = torch.where(fin, dfg * fg, 0.0)
    dmn = dmn - da
    fm = _finite(mx)
    wa = torch.where(fm, (a > i).float() + 0.5 * (a == i).float(), 0.0)
    wi = torch.where(fm, (a < i).float() + 0.5 * (a == i).float(), 1.0)
    da = da + wa * dmn
    dii = dii + wi * dmn
    return dii, da * torch.sigmoid(-f), da


def mlstm_scan_bwd_ref(q, k, v, i_pre, f_pre, upd, h, s, ckpt, mck,
                       ckpt_every: int, dh, dCn, dm):
    """Cotangents (dq, dk, dv (T, B, H, hd) float32, di, df (T, B, H),
    dC0 (B, H, hd, hd), dn0 (B, H, hd), dm0 (B, H)) of ``mlstm_scan_ref``'s
    inputs from those of its dynamic outputs: ``dh`` (T, B, H, hd), ``dCn``
    (B, H, hd, hd+1) and ``dm`` (B, H). ``h``, ``s``, ``ckpt`` and ``mck``
    are the forward's (``ckpt_every``).

    A step t (G the adjoint of [C|n]_t, g_m that of m_t, P = [C|n]_{t-1}):

      den = max(|s_t|, e), e = exp(-m_new); dr = [dh_t / den, ds] with
      dden = -Σ_j dh_t,j h_t,j / den, ds = dden·w_s·sign(s_t)
      G_new = (u ? G : 0) + q_t ⊗ dr        new = fg P + ig (k_t ⊗ [v_t, 1])
      dq_t = new · dr,  dfg = Σ G_new ∘ P,  dig = Σ G_new ∘ (k_t ⊗ [v_t, 1])
      dk_t = (ig G_new)[:, :hd] v_t + (ig G_new)[:, hd],  dv_t = k_t (ig G_new)
      G ← (u ? 0 : G) + fg G_new
      dm_new = (u ? g_m : 0) - dden·w_e·e;  the stabilizer (``_gates_bwd``)
      g_m ← (u ? 0 : g_m) + da

    w_s, w_e split max(|s|, e)'s adjoint (half each on a tie). The matrix
    adjoint G does not depend on g_m, so the kernel sums dfg and dig over
    its column blocks and walks the scalar chain in a second pass."""
    T, B, H, hd = q.shape
    K = ckpt_every
    logf = F.logsigmoid(f_pre)
    q32, k32 = q.float(), k.float()
    v1 = torch.cat([v, torch.ones_like(v[..., :1])], -1)
    G, gm = dCn.clone(), dm.clone()
    f32 = dict(dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.zeros((T, B, H, hd), **f32) for _ in range(3))
    di, df = torch.zeros((T, B, H), **f32), torch.zeros((T, B, H), **f32)
    for c in range(_n_chunks(T, K) - 1, -1, -1):
        t0, t1 = c * K, min(T, (c + 1) * K)
        P, mp, kept = ckpt[c], mck[c], []
        for t in range(t0, t1):  # recompute the chunk from its checkpoint
            kept.append((P, mp))
            _, _, mn, _, fg, ig = _gates(logf[t], i_pre[t], mp)
            new = (fg[..., None, None] * P + ig[..., None, None]
                   * (k[t, ..., :, None] * v1[t, ..., None, :]))
            if upd is None:
                P, mp = new, mn
            else:
                u = upd[t][:, None]
                P = torch.where(u[..., None, None], new, P)
                mp = torch.where(u, mn, mp)
        for t in range(t1 - 1, t0 - 1, -1):
            P, mp = kept[t - t0]
            a, mx, mn, fin, fg, ig = _gates(logf[t], i_pre[t], mp)
            kv = (k[t, ..., :, None] * v1[t, ..., None, :]).float()
            new = fg[..., None, None] * P + ig[..., None, None] * kv
            e = torch.exp(-mn)
            sa = s[t].abs()
            den = torch.maximum(sa, e)
            ws = (sa > e).float() + 0.5 * (sa == e).float()
            dden = -(dh[t] * h[t]).sum(-1) / den
            ds = dden * ws * torch.sign(s[t])
            dr = torch.cat([dh[t] / den[..., None], ds[..., None]], -1)
            u = (torch.ones((B, 1), dtype=torch.bool, device=q.device)
                 if upd is None else upd[t][:, None])
            Gn = (torch.where(u[..., None, None], G, 0.0)
                  + q32[t, ..., :, None] * dr[..., None, :])
            dq[t] = (new * dr[..., None, :]).sum(-1)
            dfg = (Gn * P).sum((-1, -2))
            dig = (Gn * kv).sum((-1, -2))
            dkv = ig[..., None, None] * Gn
            dk[t] = (dkv[..., :hd] * v[t, ..., None, :].float()).sum(-1) \
                + dkv[..., hd]
            dv[t] = (dkv[..., :hd] * k32[t, ..., :, None]).sum(-2)
            G = torch.where(u[..., None, None], 0.0, G) \
                + fg[..., None, None] * Gn
            dmn = torch.where(u, gm, 0.0) - (dden * (1.0 - ws)) * e
            di[t], df[t], da = _gates_bwd(f_pre[t], i_pre[t], a, mx, fin,
                                          fg, ig, dfg, dig, dmn)
            gm = torch.where(u, 0.0, gm) + da
    return dq, dk, dv, di, df, G[..., :hd], G[..., hd], gm


def slstm_scan_ref(z_in, i_in, f_in, o_sig, R, cnh0, m0,
                   upd: Optional[torch.Tensor] = None,
                   com: Optional[torch.Tensor] = None,
                   collect: bool = False, ckpt_every: Optional[int] = None):
    """The sLSTM recurrence, head-major so that h R is one batched product
    with no copy. Returns (hs (T, H, B, hd) the gated h after each step (a
    step that does not update repeats the last h), [c, n, h] (3, H, B, hd)
    and m (H, B, hd): the dynamic state, the committed carry with
    ``com``, or with ``collect`` the staged states (3, T+1, H, B, hd) and
    (T+1, H, B, hd), index 0 the state before the block).

    With ``ckpt_every`` K, also ckpt (NC, 3, H, B, hd): [c, n, m] before
    steps 0, K, 2K, ... (h_{t-1} is hs[t-1]), what ``slstm_scan_bwd_ref``
    walks from.

    z = tanh(z_t + h R) in float32 with a float32 R; n clamped at 1e-6 in
    the division. The stabilizer steps first (``stabilizer_chain``); c, n
    and h step together, as one (3, H, B, hd) tensor."""
    T = z_in.shape[0]
    upd4 = None if upd is None else upd[:, None, :, None]  # (T, 1, B, 1)
    com4 = upd4 if com is None else com[:, None, :, None]
    _, fg, ig, m_dyn, m_com = stabilizer_chain(
        F.logsigmoid(f_in), i_in, m0, upd4, com4)
    cnh = cnh0
    cnh_com = cnh if com is not None else None
    hs, staged, ckpt = [], [cnh], []
    m_before = torch.cat([m0[None], m_dyn[:-1]])
    for t in range(T):
        if ckpt_every and t % ckpt_every == 0:
            ckpt.append(torch.stack([cnh[0], cnh[1], m_before[t]]))
        c, n, h = cnh.unbind(0)
        z = torch.tanh(z_in[t] + torch.bmm(h, R))
        c_new = fg[t] * c + ig[t] * z
        n_new = fg[t] * n + ig[t]
        h_new = o_sig[t] * c_new / torch.clamp(n_new, min=1e-6)
        new = torch.stack([c_new, n_new, h_new])
        cnh = new if upd is None else torch.where(upd4[t], new, cnh)
        if cnh_com is not None:
            cnh_com = torch.where(com4[t], cnh, cnh_com)
        hs.append(cnh[2])
        if collect:
            staged.append(cnh)
    hs = torch.stack(hs)
    if collect:
        cnh = torch.stack(staged, 1)
        m = torch.cat([m0[None], m_dyn])
    elif cnh_com is not None:
        cnh, m = cnh_com, m_com
    else:
        m = m_dyn[-1]
    if not ckpt_every:
        return hs, cnh, m
    return hs, cnh, m, torch.stack(ckpt)


def slstm_scan_bwd_ref(z_in, i_in, f_in, o_sig, R, h0, upd, hs, ckpt,
                       ckpt_every: int, dhs, dcnh, dm):
    """Cotangents (dz_in, di, df, do (T, H, B, hd), dR (H, hd, hd), dcnh0
    (3, H, B, hd), dm0 (H, B, hd)) of ``slstm_scan_ref``'s inputs from
    those of its dynamic outputs: ``dhs`` (T, H, B, hd), ``dcnh`` (3, H,
    B, hd) and ``dm`` (H, B, hd). ``hs`` and ``ckpt`` are the forward's
    (``ckpt_every``); ``h0`` the h before the block.

    A step t that updates, carrying the adjoints (g_c, g_n, g_h, g_m) of
    the state after it, with h_t = (o c_t) / max(n_t, 1e-6):

      g = g_h + dhs_t;  da = g / den;  do = da c_t;  dc = g_c + da o
      dn = g_n + [n_t >= 1e-6] (-g (o c_t) / den²)
      dfg = dc c_{t-1} + dn n_{t-1};  dig = dc z_t + dn
      dz_in = dc ig (1 - z_t²);  dR += h_{t-1} ⊗ dz_in
      g_c ← fg dc,  g_n ← fg dn,  g_h ← dz_in R^T,  the stabilizer as the
      mLSTM's (``_gates_bwd``, dm_new = g_m),  g_m ← da

    A step that does not update passes (g_c, g_n, g + ..., g_m) to the
    state before it (g_h ← g) and gives its inputs 0."""
    T = z_in.shape[0]
    K = ckpt_every
    gc, gn, gh = (x.clone() for x in dcnh.unbind(0))
    gm = dm.clone()
    dz, di, df, do = (torch.zeros_like(z_in) for _ in range(4))
    dR = torch.zeros_like(R)
    Rt = R.transpose(1, 2)
    logf = F.logsigmoid(f_in)

    def hp(t):
        return h0 if t == 0 else hs[t - 1]

    for c in range(_n_chunks(T, K) - 1, -1, -1):
        t0, t1 = c * K, min(T, (c + 1) * K)
        cc, nn, mp = ckpt[c].unbind(0)
        kept = []
        for t in range(t0, t1):  # recompute the chunk from its checkpoint
            z = torch.tanh(z_in[t] + torch.bmm(hp(t), R))
            kept.append((cc, nn, mp, z))
            _, _, mn, _, fg, ig = _gates(logf[t], i_in[t], mp)
            c_new, n_new = fg * cc + ig * z, fg * nn + ig
            if upd is None:
                cc, nn, mp = c_new, n_new, mn
            else:
                u = upd[t][None, :, None]
                cc = torch.where(u, c_new, cc)
                nn = torch.where(u, n_new, nn)
                mp = torch.where(u, mn, mp)
        for t in range(t1 - 1, t0 - 1, -1):
            cc, nn, mp, z = kept[t - t0]
            a, mx, mn, fin, fg, ig = _gates(logf[t], i_in[t], mp)
            c_new, n_new = fg * cc + ig * z, fg * nn + ig
            den = torch.clamp(n_new, min=1e-6)
            oc = o_sig[t] * c_new
            g = gh + dhs[t]
            u = (torch.ones((1, z.shape[1], 1), dtype=torch.bool,
                            device=z.device)
                 if upd is None else upd[t][None, :, None])
            dhn = torch.where(u, g, 0.0)
            da_ = dhn / den
            do[t] = da_ * c_new
            dc = torch.where(u, gc, 0.0) + da_ * o_sig[t]
            dn = torch.where(u, gn, 0.0) + torch.where(
                n_new >= 1e-6, -dhn * oc / (den * den), 0.0)
            dfg = dc * cc + dn * nn
            dig = dc * z + dn
            dzz = dc * ig * (1 - z * z)
            dz[t] = dzz
            dR += torch.bmm(hp(t).transpose(1, 2), dzz)
            di[t], df[t], da = _gates_bwd(f_in[t], i_in[t], a, mx, fin, fg,
                                          ig, dfg, dig,
                                          torch.where(u, gm, 0.0))
            di[t] = torch.where(u, di[t], 0.0)
            df[t] = torch.where(u, df[t], 0.0)
            gc = torch.where(u, fg * dc, gc)
            gn = torch.where(u, fg * dn, gn)
            gm = torch.where(u, da, gm)
            gh = torch.where(u, torch.bmm(dzz, Rt), g)
    return dz, di, df, do, dR, torch.stack([gc, gn, gh]), gm


def ckpt_count(T: int, ckpt_every: int) -> int:
    """Checkpoints a forward of T steps keeps every ``ckpt_every``."""
    return _n_chunks(T, ckpt_every)

