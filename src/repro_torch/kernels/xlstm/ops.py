"""Wrappers of the xLSTM recurrence kernels (``csrc/mlstm.cu``,
``csrc/slstm.cu``), and the autograd functions that join each forward
to its backward.

For CUDA tensors each wrapper checks what its kernel takes, allocates the
outputs and scratch, and launches on the current stream; for CPU tensors
it runs the plain version (``ref.py``); for meta tensors it returns
outputs of the right shapes and reports the kernel's ``work``
(``kernels.work``). There is no fallback between them: a CUDA tensor a
kernel cannot take raises.

``mlstm_scan`` and ``slstm_scan`` are what the model calls. Where
autograd records (grad enabled and an input that requires grad) they go
through ``MLSTMScan`` / ``SLSTMScan``: the forward launch keeps a
checkpoint of the state every ``CKPT_EVERY`` steps, and the backward
launch walks T in reverse from them, recomputing each chunk. Only the
dynamic state has a backward: ``collect`` and a committed carry (``com``)
serve the engine, which runs under ``inference_mode``; on the CPU they
differentiate through the plain loops, on the card they raise.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import work as _work
from repro_torch.kernels.xlstm.ref import (
    ckpt_count,
    mlstm_scan_bwd_ref,
    mlstm_scan_ref,
    slstm_scan_bwd_ref,
    slstm_scan_ref,
)

# Launches of the CUDA kernels by these wrappers (one per call on CUDA),
# in all and by (B, T).
MLSTM_LAUNCHES = 0
MLSTM_LAUNCHES_BY_SHAPE: Counter = Counter()
MLSTM_BWD_LAUNCHES = 0
SLSTM_LAUNCHES = 0
SLSTM_LAUNCHES_BY_SHAPE: Counter = Counter()
SLSTM_BWD_LAUNCHES = 0

# Steps between the forward's checkpoints under autograd: the backward
# recomputes a chunk of this many steps from each (at most the kernels'
# KMAX). At B 16, T 4,096 and xLSTM-125M's 4 heads of 192 an mLSTM layer
# keeps 64 checkpoints of 9.5 MB and its backward 64 steps of scratch.
CKPT_EVERY = 64
KMAX = 64
# the mLSTM kernels' CTA: 32 columns of [C|n] (a lane each) by 8 warps of
# rows, at most MLSTM_ROWS rows a thread (hd <= 192). The backward keeps
# the state before every MLSTM_BWD_GROUP-th step of a chunk in scratch (a
# thread's rows and its row of n: MLSTM_GROUP_FLOATS a CTA) and stages one
# group's inputs at a time in shared memory.
MLSTM_COLS = 32
MLSTM_THREADS = 256
MLSTM_MAX_HD = 192
MLSTM_ROWS = MLSTM_MAX_HD // (MLSTM_THREADS // 32)
MLSTM_BWD_GROUP = 4
MLSTM_GROUP_FLOATS = (MLSTM_ROWS + 1) * MLSTM_THREADS
MLSTM_BWD_CTAS_PER_SM = 3  # the kernel's __launch_bounds__
# the mLSTM forward: blocks of MLSTM_FWD_BLOCK steps (one a warp folds at
# the block's end), three CTAs a SM (its __launch_bounds__)
MLSTM_FWD_BLOCK = MLSTM_THREADS // 32
MLSTM_FWD_CTAS_PER_SM = 3
# the sLSTM kernels: at most this many batch rows a CTA; the forward
# splits each group of columns' dot products over p threads (R's slices
# in registers) and copies z, i, f, o a block of steps ahead into shared
# memory; the backward's walk splits dz R^T the same way (R's row slices
# in registers) and keeps SLSTM_BWD_FIELDS floats an element a step of a
# chunk in scratch; its recompute of z copies SLSTM_REC_BLOCK rows a
# ring half; its dR pass sums 64 x 64 tiles over at most
# SLSTM_DR_MAX_SPLIT ranges of SLSTM_DR_ROWS (t, b) rows or more
SLSTM_MAX_ROWS = 4
SLSTM_MAX_HD = 224
SLSTM_BWD_FIELDS = 7
SLSTM_REC_BLOCK = 8
SLSTM_DR_TILE = 64
SLSTM_DR_MAX_SPLIT = 16
SLSTM_DR_ROWS = 4096
SMEM_MAX = 232_448  # bytes of shared memory a CTA can have on sm_90

_P = ctypes.c_void_p
_I = ctypes.c_int
_MLSTM_SIG = {
    "mlstm_fwd": (_P,) * 15 + (_I,) * 7 + (_P,),
    "mlstm_bwd": (_P,) * 24 + (_I,) * 6 + (_P,),
    "mlstm_bwd_layout": (),
    "mlstm_staged_row": (_I,),
}
_SLSTM_SIG = {
    "slstm_fwd": (_P,) * 13 + (_I,) * 7 + (_P,),
    "slstm_bwd": (_P,) * 20 + (_I,) * 6 + (_P,),
    "slstm_bwd_layout": (),
    "slstm_dr": (_P,) * 5 + (_I,) * 4 + (_P,),
    "slstm_rec": (_P,) * 5 + (_I,) * 4 + (_P,),
}


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _need(cond: bool, what: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{what}: {msg}")


def _on_card(what: str, dev, **tensors) -> None:
    """One CUDA device, contiguity, for every tensor given (None skipped)."""
    for name, t in tensors.items():
        if t is None:
            continue
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{what}: {name} is not on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")


def _f32(what: str, **tensors) -> None:
    for name, t in tensors.items():
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} is {t.dtype}, not float32")


def _masks(what, upd, com, T, B):
    for name, t in (("upd", upd), ("com", com)):
        if t is not None:
            _need(tuple(t.shape) == (T, B) and t.dtype == torch.bool, what,
                  f"{name} must be ({T}, {B}) bool, is {tuple(t.shape)} "
                  f"{t.dtype}")


def _out_at(com, T: int, B: int, dev) -> torch.Tensor:
    """(B,) int32: the step after which the state out is taken, -1 for the
    state before the block. Without ``com`` the last step (the dynamic
    state); with it the last committed step (the committed carry equals
    the dynamic state there: ``com`` is ``upd`` on a prefix of steps)."""
    if com is None:
        return torch.full((B,), T - 1, dtype=torch.int32, device=dev)
    steps = torch.arange(T, dtype=torch.int32, device=dev)[:, None]
    return torch.where(com, steps, -1).amax(0).to(torch.int32)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mlstm_check(what, q, k, v, i_pre, f_pre, upd, com):
    _need(q.dim() == 4 and k.shape == q.shape and v.shape == q.shape, what,
          f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
          "must be one (T, B, H, hd) shape")
    T, B, H, hd = q.shape
    _need(min(T, B, H, hd) >= 1, what, f"empty shape {tuple(q.shape)}")
    _need(hd <= MLSTM_MAX_HD, what, f"hd {hd} > {MLSTM_MAX_HD}")
    _need(q.dtype in (torch.bfloat16, torch.float32)
          and k.dtype == q.dtype and v.dtype == q.dtype, what,
          f"q, k, v must be one of bfloat16 / float32, are {q.dtype}, "
          f"{k.dtype}, {v.dtype}")
    for name, t in (("i_pre", i_pre), ("f_pre", f_pre)):
        _need(tuple(t.shape) == (T, B, H), what,
              f"{name} {tuple(t.shape)} must be ({T}, {B}, {H})")
    _f32(what, i_pre=i_pre, f_pre=f_pre)
    _masks(what, upd, com, T, B)
    return T, B, H, hd


def mlstm_scan_cuda(q, k, v, i_pre, f_pre, C0, n0, m0,
                    upd: Optional[torch.Tensor] = None,
                    com: Optional[torch.Tensor] = None,
                    collect: bool = False,
                    ckpt_every: Optional[int] = None):
    """Launch the mLSTM forward kernel (CUDA tensors only); returns what
    ``mlstm_scan_ref`` returns."""
    global MLSTM_LAUNCHES
    what = "mlstm_scan"
    T, B, H, hd = _mlstm_check(what, q, k, v, i_pre, f_pre, upd, com)
    _need(tuple(C0.shape) == (B, H, hd, hd) and tuple(n0.shape) == (B, H, hd)
          and tuple(m0.shape) == (B, H), what,
          f"state C {tuple(C0.shape)}, n {tuple(n0.shape)}, m "
          f"{tuple(m0.shape)} must be ({B}, {H}, {hd}, {hd}), ({B}, {H}, "
          f"{hd}), ({B}, {H})")
    _f32(what, C0=C0, n0=n0, m0=m0)
    _need(ckpt_every is None or 1 <= ckpt_every <= KMAX, what,
          f"ckpt_every {ckpt_every} not in [1, {KMAX}]")
    _need(not (collect and ckpt_every), what, "collect keeps no checkpoints")
    dev = q.device
    q, k, v, i_pre, f_pre = (t.contiguous() for t in (q, k, v, i_pre, f_pre))
    cn0 = torch.cat([C0, n0[..., None]], -1).contiguous()
    m0 = m0.contiguous()
    _on_card(what, dev, q=q, k=k, v=v, i_pre=i_pre, f_pre=f_pre, cn0=cn0,
             m0=m0, upd=upd, com=com)
    lib = _build.load("mlstm", _MLSTM_SIG)
    f32 = dict(dtype=torch.float32, device=dev)
    h = torch.empty((T, B, H, hd), **f32)
    if collect:  # rows padded to whole sectors (csrc/mlstm.cu staged_row)
        srs = mlstm_staged_row(hd)
        _need(lib.mlstm_staged_row(hd) == srs, what,
              f"the library's staged row {lib.mlstm_staged_row(hd)} is not "
              f"{srs}")
        cn = torch.empty((B, T + 1, H, hd, srs), **f32)[..., :hd + 1]
        m = torch.empty((B, T + 1, H), **f32)
    else:
        cn = torch.empty((B, H, hd, hd + 1), **f32)
        m = torch.empty((B, H), **f32)
    saved = None
    if ckpt_every:
        nc = ckpt_count(T, ckpt_every)
        saved = (torch.empty((nc, B, H, hd, hd + 1), **f32),
                 torch.empty((nc, B, H), **f32), torch.empty((T, B, H), **f32))
    out_at = _out_at(com, T, B, dev)
    err = lib.mlstm_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), i_pre.data_ptr(),
        f_pre.data_ptr(), cn0.data_ptr(), m0.data_ptr(), _ptr(upd),
        out_at.data_ptr(), h.data_ptr(), cn.data_ptr(), m.data_ptr(),
        *((None,) * 3 if saved is None else (t.data_ptr() for t in saved)),
        T, B, H, hd, int(q.dtype == torch.bfloat16), int(collect),
        ckpt_every or 0, _build.cuda_stream_ptr(dev))
    _build.check(err, "mlstm_scan launch")
    MLSTM_LAUNCHES += 1
    MLSTM_LAUNCHES_BY_SHAPE[(B, T)] += 1
    return (h, cn, m) if saved is None else (h, cn, m, saved)


def mlstm_scan_bwd_cuda(q, k, v, i_pre, f_pre, upd, h, s, ckpt, mck,
                        ckpt_every: int, dh, dCn, dm):
    """Launch the mLSTM backward kernel and its reduction pass (CUDA
    tensors only); returns what ``mlstm_scan_bwd_ref`` returns."""
    global MLSTM_BWD_LAUNCHES
    what = "mlstm_scan_bwd"
    T, B, H, hd = _mlstm_check(what, q, k, v, i_pre, f_pre, upd, None)
    nc = ckpt_count(T, ckpt_every)
    _need(1 <= ckpt_every <= KMAX, what, f"ckpt_every {ckpt_every}")
    for name, t, want in (("h", h, (T, B, H, hd)), ("s", s, (T, B, H)),
                          ("ckpt", ckpt, (nc, B, H, hd, hd + 1)),
                          ("mck", mck, (nc, B, H)), ("dh", dh, (T, B, H, hd)),
                          ("dCn", dCn, (B, H, hd, hd + 1)), ("dm", dm, (B, H))):
        _need(tuple(t.shape) == want, what,
              f"{name} {tuple(t.shape)} must be {want}")
    _f32(what, h=h, s=s, ckpt=ckpt, mck=mck, dh=dh, dCn=dCn, dm=dm)
    dev = q.device
    _on_card(what, dev, q=q, k=k, v=v, i_pre=i_pre, f_pre=f_pre, upd=upd,
             h=h, s=s, ckpt=ckpt, mck=mck, dh=dh, dCn=dCn, dm=dm)
    lib = _build.load("mlstm", _MLSTM_SIG)
    _need(lib.mlstm_bwd_layout() == MLSTM_BWD_GROUP, what,
          f"the library's group size {lib.mlstm_bwd_layout()} is not "
          f"{MLSTM_BWD_GROUP}")
    plan = mlstm_bwd_plan(B, H, hd, ckpt_every, _sm_count(dev))
    f32 = dict(dtype=torch.float32, device=dev)
    njb = plan["col_blocks"]
    scratch = torch.empty((plan["ctas"], plan["groups"], MLSTM_GROUP_FLOATS),
                          **f32)
    dq_part = torch.empty((T, B, H, njb + 1, hd), **f32)
    dk_part = torch.empty((T, B, H, njb + 1, hd), **f32)
    sc_part = torch.empty((T, B, H, njb, 4), **f32)
    dq, dk, dv = (torch.empty((T, B, H, hd), **f32) for _ in range(3))
    di, df = torch.empty((T, B, H), **f32), torch.empty((T, B, H), **f32)
    dcn0 = torch.empty((B, H, hd, hd + 1), **f32)
    dm0 = torch.empty((B, H), **f32)
    err = lib.mlstm_bwd(
        *(_ptr(t) for t in (q, k, v, i_pre, f_pre, upd, h, s, ckpt, mck, dh,
                            dCn, dm, scratch, dq_part, dk_part, sc_part, dq,
                            dk, dv, di, df, dcn0, dm0)),
        T, B, H, hd, int(q.dtype == torch.bfloat16), ckpt_every,
        _build.cuda_stream_ptr(dev))
    _build.check(err, "mlstm_scan_bwd launch")
    MLSTM_BWD_LAUNCHES += 1
    return dq, dk, dv, di, df, dcn0[..., :hd], dcn0[..., hd], dm0


def mlstm_staged_row(hd: int) -> int:
    """Floats between two rows of the mLSTM forward's staged states
    (collect): hd + 1 rounded up to a 32-byte sector, so that the
    kernel's row stores fill every sector they touch (``staged_row`` in
    ``csrc/mlstm.cu``); the wrapper returns the view of the first hd + 1
    columns."""
    return -(-(hd + 1) // 8) * 8


def mlstm_fwd_plan(B: int, H: int, hd: int, n_sm: int) -> dict:
    """The mLSTM forward kernel's launch for a shape on ``n_sm`` SMs: a CTA
    per (b, h) and 32 columns of [C|n] (``col_blocks`` a head) of
    ``MLSTM_THREADS``; T stepped in blocks of ``block`` steps, the read
    folded once a block; a two-block ring of the raw inputs
    (``ring_bytes``: q and k rows, v of the CTA's columns, room for
    float32); dynamic shared memory (bytes; ``csrc/mlstm.cu``'s
    ``kFsFloats``), resident CTAs a SM and waves. The C entry launches
    this grid itself; the CPU tests hold the plan to the card's limits."""
    _need(1 <= hd <= MLSTM_MAX_HD, "mlstm_fwd_plan", f"hd {hd} not in [1, "
          f"{MLSTM_MAX_HD}]")
    njb = -(-hd // MLSTM_COLS)
    ctas = njb * B * H
    warps, cols, s = MLSTM_THREADS // 32, MLSTM_COLS, MLSTM_FWD_BLOCK
    ring = 2 * (2 * s * MLSTM_MAX_HD + s * cols)
    # the ring, each warp's rows of the block as float, three blocks of
    # gates (8 a step), two blocks of partials (warp column sums, q_i n_i)
    floats = (ring + warps * s * 2 * MLSTM_ROWS + 3 * s * 8
              + 2 * s * warps * cols + 2 * s * MLSTM_THREADS)
    return dict(col_blocks=njb, ctas=ctas, threads=MLSTM_THREADS, block=s,
                ring_bytes=4 * ring, smem=4 * floats,
                ctas_per_sm=MLSTM_FWD_CTAS_PER_SM,
                waves=-(-ctas // (MLSTM_FWD_CTAS_PER_SM * n_sm)))


def mlstm_bwd_plan(B: int, H: int, hd: int, ckpt_every: int, n_sm: int
                   ) -> dict:
    """The mLSTM backward kernel's launch for a shape on ``n_sm`` SMs: a
    CTA per (b, h) and 32 columns (``col_blocks`` a head) of
    ``MLSTM_THREADS``; a chunk of ``ckpt_every`` steps walked in groups of
    ``group`` steps, each staged in shared memory in turn (the state
    before each kept in scratch: ``groups`` a chunk, ``scratch_bytes`` in
    all); dynamic shared memory (bytes; ``csrc/mlstm.cu``'s
    ``kSmFloats``), resident CTAs a SM and waves. The reduce pass sums
    ``col_blocks + 1`` partial rows of dq and dk (the last the n
    column's)."""
    _need(1 <= hd <= MLSTM_MAX_HD, "mlstm_bwd_plan", f"hd {hd} not in [1, "
          f"{MLSTM_MAX_HD}]")
    _need(1 <= ckpt_every <= KMAX, "mlstm_bwd_plan",
          f"ckpt_every {ckpt_every} not in [1, {KMAX}]")
    njb = -(-hd // MLSTM_COLS)
    ctas = njb * B * H
    groups = -(-ckpt_every // MLSTM_BWD_GROUP)
    warps, cols, g = MLSTM_THREADS // 32, MLSTM_COLS, MLSTM_BWD_GROUP
    # the group's state, G, two staged groups (q, k rows; v, dh columns;
    # q.n), two groups' per-warp sums, the chunk's per-step scalars
    staged = -(-(2 * g * MLSTM_MAX_HD + 2 * g * cols + g) // 4) * 4
    floats = (MLSTM_GROUP_FLOATS + MLSTM_ROWS * MLSTM_THREADS + 2 * staged
              + 2 * g * warps * cols + 2 * g * warps * 2 + 2 * g + 7 * KMAX)
    return dict(col_blocks=njb, ctas=ctas, threads=MLSTM_THREADS,
                group=g, groups=groups,
                smem=4 * floats, ctas_per_sm=MLSTM_BWD_CTAS_PER_SM,
                waves=-(-ctas // (MLSTM_BWD_CTAS_PER_SM * n_sm)),
                scratch_bytes=4 * ctas * groups * MLSTM_GROUP_FLOATS)


# float32 operations of one (b, h) step, per element of [C|n], each
# counted once (derived in csrc/mlstm.cu's note): the forward's 6 and the
# backward's 19
MLSTM_OPS_PER_ELEM = 6
MLSTM_BWD_OPS_PER_ELEM = 19


def mlstm_work(T: int, B: int, H: int, hd: int, in_bytes: int,
               collect: bool = False, ckpt_every: Optional[int] = None
               ) -> Tuple[float, float]:
    """(flops, bytes) of one forward launch from shapes alone: q, k, v
    read once, i and f once, h written once, the state in and out once
    (every staged state with ``collect``), the checkpoints and q·n when
    kept."""
    st = B * H * hd * (hd + 1) * 4
    nbytes = 3 * T * B * H * hd * in_bytes + 2 * T * B * H * 4
    nbytes += T * B * H * hd * 4 + st + B * H * 4
    nbytes += (T + 1) * (st + B * H * 4) if collect else st + B * H * 4
    if ckpt_every:
        nbytes += ckpt_count(T, ckpt_every) * (st + B * H * 4) + T * B * H * 4
    return float(MLSTM_OPS_PER_ELEM * T * B * H * hd * (hd + 1)), float(nbytes)


def mlstm_bwd_work(T: int, B: int, H: int, hd: int, in_bytes: int,
                   ckpt_every: int) -> Tuple[float, float]:
    """(flops, bytes) of one backward launch: q, k, v, i, f, h, q·n, dh
    and the checkpoints read once, dq, dk, dv, di, df written once, the
    state's adjoint in and out once (scratch and the reduction's partials
    left out: they are the design's, not the function's)."""
    st = B * H * hd * (hd + 1) * 4
    nbytes = 3 * T * B * H * hd * in_bytes + 3 * T * B * H * 4
    nbytes += 2 * T * B * H * hd * 4 + 3 * T * B * H * hd * 4
    nbytes += 2 * T * B * H * 4 + 2 * (st + B * H * 4)
    nbytes += ckpt_count(T, ckpt_every) * (st + B * H * 4)
    return (float(MLSTM_BWD_OPS_PER_ELEM * T * B * H * hd * (hd + 1)),
            float(nbytes))


def mlstm_scan_fwd(q, k, v, i_pre, f_pre, C0, n0, m0, upd=None, com=None,
                   collect=False, ckpt_every=None):
    """The mLSTM scan's forward, with the checkpoints of ``ckpt_every``:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors;
    for meta tensors outputs of the shapes and ``mlstm_work`` reported."""
    if q.is_cuda:
        return mlstm_scan_cuda(q, k, v, i_pre, f_pre, C0, n0, m0, upd, com,
                               collect, ckpt_every)
    if q.is_meta:
        T, B, H, hd = q.shape
        _work.report("mlstm_scan", *mlstm_work(T, B, H, hd, q.element_size(),
                                               collect, ckpt_every))
        e = dict(dtype=torch.float32, device="meta")
        lead = (B, T + 1) if collect else (B,)
        out = (torch.empty((T, B, H, hd), **e),
               torch.empty((*lead, H, hd, hd + 1), **e),
               torch.empty((*lead, H), **e))
        if not ckpt_every:
            return out
        nc = ckpt_count(T, ckpt_every)
        return (*out, (torch.empty((nc, B, H, hd, hd + 1), **e),
                       torch.empty((nc, B, H), **e),
                       torch.empty((T, B, H), **e)))
    return mlstm_scan_ref(q, k, v, i_pre, f_pre, C0, n0, m0, upd, com,
                          collect, ckpt_every)


def mlstm_scan_bwd(q, k, v, i_pre, f_pre, upd, h, s, ckpt, mck,
                   ckpt_every, dh, dCn, dm):
    """The mLSTM scan's backward: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors; for meta tensors outputs of the
    shapes, nothing launched, and ``mlstm_bwd_work`` reported."""
    if q.is_cuda:
        return mlstm_scan_bwd_cuda(q, k, v, i_pre, f_pre, upd, h, s, ckpt,
                                   mck, ckpt_every, dh, dCn, dm)
    T, B, H, hd = q.shape
    if q.is_meta:
        _work.report("mlstm_scan_bwd", *mlstm_bwd_work(
            T, B, H, hd, q.element_size(), ckpt_every))
        e = dict(dtype=torch.float32, device="meta")
        return (*(torch.empty((T, B, H, hd), **e) for _ in range(3)),
                torch.empty((T, B, H), **e), torch.empty((T, B, H), **e),
                torch.empty((B, H, hd, hd), **e), torch.empty((B, H, hd), **e),
                torch.empty((B, H), **e))
    return mlstm_scan_bwd_ref(q, k, v, i_pre, f_pre, upd, h, s, ckpt, mck,
                              ckpt_every, dh, dCn, dm)


def _zeros_if_none(g, like):
    return torch.zeros_like(like) if g is None else g.contiguous()


class MLSTMScan(torch.autograd.Function):
    """The mLSTM scan under autograd (dynamic state only): the forward
    launch with checkpoints every ``ckpt_every`` steps, then the backward
    launch walking back from them."""

    @staticmethod
    def forward(ctx, q, k, v, i_pre, f_pre, C0, n0, m0, upd, ckpt_every):
        h, cn, m, (ckpt, mck, s) = mlstm_scan_fwd(
            q, k, v, i_pre, f_pre, C0, n0, m0, upd, None, False, ckpt_every)
        ctx.ckpt_every = ckpt_every
        ctx.save_for_backward(q, k, v, i_pre, f_pre, upd, h, s, ckpt, mck)
        return h, cn, m

    @staticmethod
    def backward(ctx, dh, dcn, dm):
        q, k, v, i_pre, f_pre, upd, h, s, ckpt, mck = ctx.saved_tensors
        dq, dk, dv, di, df, dC0, dn0, dm0 = mlstm_scan_bwd(
            q, k, v, i_pre, f_pre, upd, h, s, ckpt, mck, ctx.ckpt_every,
            _zeros_if_none(dh, h), _zeros_if_none(dcn, ckpt[0]),
            _zeros_if_none(dm, mck[0]))
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), di, df, dC0,
                dn0, dm0, None, None)


def mlstm_scan(q, k, v, i_pre, f_pre, C0, n0, m0,
               upd: Optional[torch.Tensor] = None,
               com: Optional[torch.Tensor] = None, collect: bool = False,
               ckpt_every: int = CKPT_EVERY):
    """(h (T, B, H, hd) float32, [C|n], m) of the mLSTM recurrence (see
    ``mlstm_scan_ref``): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors, the kernel's reported ``work`` for meta
    tensors; differentiable through ``MLSTMScan`` where autograd
    records (the dynamic state)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, i_pre, f_pre, C0, n0, m0)):
        if collect or com is not None:
            if q.is_cuda:
                raise NotImplementedError(
                    "mlstm_scan: the backward kernel takes the dynamic state"
                    " only (no collect, no committed carry)")
            return mlstm_scan_fwd(q, k, v, i_pre, f_pre, C0, n0, m0, upd, com,
                              collect)
        return MLSTMScan.apply(q, k, v, i_pre, f_pre, C0, n0, m0, upd,
                               ckpt_every)
    return mlstm_scan_fwd(q, k, v, i_pre, f_pre, C0, n0, m0, upd, com, collect)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def _slstm_check(what, z_in, i_in, f_in, o_sig, R, upd, com):
    _need(z_in.dim() == 4, what, f"z_in {tuple(z_in.shape)} must be (T, H, "
          "B, hd)")
    T, H, B, hd = z_in.shape
    _need(min(T, H, B, hd) >= 1, what, f"empty shape {tuple(z_in.shape)}")
    _need(hd <= SLSTM_MAX_HD, what, f"hd {hd} > {SLSTM_MAX_HD}")
    for name, t in (("i_in", i_in), ("f_in", f_in), ("o_sig", o_sig)):
        _need(t.shape == z_in.shape, what,
              f"{name} {tuple(t.shape)} must be {tuple(z_in.shape)}")
    _need(tuple(R.shape) == (H, hd, hd), what,
          f"R {tuple(R.shape)} must be ({H}, {hd}, {hd})")
    _f32(what, z_in=z_in, i_in=i_in, f_in=f_in, o_sig=o_sig, R=R)
    _masks(what, upd, com, T, B)
    return T, H, B, hd


def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _rows_per_cta(B: int, H: int, n_sm: int) -> int:
    """The fewest batch rows a CTA that keep every CTA of a (rows, head)
    grid resident at once, one a SM, at most ``SLSTM_MAX_ROWS``."""
    return min(SLSTM_MAX_ROWS, max(1, -(-B // max(1, n_sm // H))))


def slstm_split(hd: int) -> Tuple[int, int, int]:
    """(p, c, len) of the forward kernel (``split_of`` in
    ``csrc/slstm.cu``): p threads a group of c columns of h, each over a
    slice of len k's of the dot product h_{t-1} R_h (a multiple of 4, zero
    past hd). The backward's recompute sums in the same order."""
    _need(1 <= hd <= SLSTM_MAX_HD, "slstm_split", f"hd {hd} not in [1, "
          f"{SLSTM_MAX_HD}]")
    p, c = (8, 4) if hd <= 192 else (4, 2)
    return p, c, (-(-hd // p) + 3) // 4 * 4


def slstm_fwd_plan(B: int, H: int, hd: int, n_sm: int) -> dict:
    """The sLSTM forward kernel's launch for a shape on ``n_sm`` SMs: the
    split (p threads a group of ``cols`` columns, slices of len), rows a
    CTA (``rows``; the kernel is compiled for 1, 2 or 4 and
    ``rows_compiled`` is the one launched), threads a CTA, the input
    ring's block in steps (two blocks of 6 fields a step), dynamic shared
    memory (bytes), CTAs and waves (one CTA a SM). No cluster: a step's
    product is not what bounds it."""
    p, c, L = slstm_split(hd)
    rb = _rows_per_cta(B, H, n_sm)
    rbt = rb if rb <= 2 else SLSTM_MAX_ROWS
    blk = 8 if rbt <= 2 else 4
    threads = -(-(-(-hd // c) * p) // 32) * 32
    smem = 4 * (2 * rbt * p * (L + 4) + 2 * blk * 6 * rbt * hd)
    ctas = H * -(-B // rb)
    return dict(p=p, cols=c, len=L, rows=rb, rows_compiled=rbt,
                threads=threads, ring_block=blk, smem=smem, cluster=1,
                ctas=ctas, waves=-(-ctas // n_sm))


def slstm_dr_splits(T: int, B: int) -> int:
    """Ranges of (t, b) rows the dR pass sums apart (``dr_splits`` in
    ``csrc/slstm.cu``): one per ``SLSTM_DR_ROWS`` rows, at most
    ``SLSTM_DR_MAX_SPLIT``; a last pass sums them in order."""
    return max(1, min(SLSTM_DR_MAX_SPLIT, -(-T * B // SLSTM_DR_ROWS)))


def slstm_bwd_plan(B: int, H: int, hd: int, T: int, ckpt_every: int,
                   n_sm: int) -> dict:
    """The sLSTM backward's launches for a shape on ``n_sm`` SMs. The
    recompute of z: ``rec_ctas`` CTAs (a head's (t, b) rows in
    ``rec_ctas / H`` ranges, one wave) of ``threads``, the forward's
    split, ``rec_smem`` bytes. The walk: a CTA per head and group of
    ``rows`` batch rows (the forward's rule; compiled for
    ``rows_compiled``), the forward's split on R's rows (p threads a
    group of ``cols`` outputs over slices of len), ``smem`` bytes (dz
    double-buffered), ``ctas`` and ``waves`` (one CTA a SM). dR: 64 x 64
    tiles (``dr_tiles`` a head) over ``dr_splits`` ranges of rows,
    ``dr_ctas`` of 256 threads. ``scratch_floats``: the walk's chunk
    (``SLSTM_BWD_FIELDS`` floats an element a step) and dR's partials.
    No cluster: the passes that need no step before them (the recompute,
    dR) fill the card; a walk's step is one row's chain, of which a
    split over two SMs would shorten only the product's share, at a
    cluster barrier a step."""
    p, c, L = slstm_split(hd)
    _need(1 <= ckpt_every <= KMAX, "slstm_bwd_plan",
          f"ckpt_every {ckpt_every} not in [1, {KMAX}]")
    rb = _rows_per_cta(B, H, n_sm)
    rbt = rb if rb <= 2 else SLSTM_MAX_ROWS
    threads = -(-(-(-hd // c) * p) // 32) * 32
    ctas = H * -(-B // rb)
    rows = T * B
    rec_parts = max(1, min(max(1, n_sm // H), -(-rows // SLSTM_REC_BLOCK)))
    nsplit = slstm_dr_splits(T, B)
    nt = -(-hd // SLSTM_DR_TILE)
    walk = ctas * ckpt_every * SLSTM_BWD_FIELDS * rb * hd
    return dict(p=p, cols=c, len=L, rows=rb, rows_compiled=rbt,
                threads=threads, smem=4 * 2 * rbt * p * (L + 4), cluster=1,
                ctas=ctas, waves=-(-ctas // n_sm),
                rec_ctas=H * rec_parts, rec_waves=-(-H * rec_parts // n_sm),
                rec_smem=4 * 2 * SLSTM_REC_BLOCK * (p * (L + 4) + hd),
                dr_splits=nsplit, dr_tiles=nt * nt, dr_ctas=nt * nt * H * nsplit,
                dr_smem=4 * 2 * 2 * 32 * SLSTM_DR_TILE,
                scratch_floats=walk + nsplit * H * hd * hd)


def slstm_scan_cuda(z_in, i_in, f_in, o_sig, R, cnh0, m0,
                    upd: Optional[torch.Tensor] = None,
                    com: Optional[torch.Tensor] = None,
                    collect: bool = False,
                    ckpt_every: Optional[int] = None):
    """Launch the sLSTM forward kernel (CUDA tensors only); returns what
    ``slstm_scan_ref`` returns."""
    global SLSTM_LAUNCHES
    what = "slstm_scan"
    T, H, B, hd = _slstm_check(what, z_in, i_in, f_in, o_sig, R, upd, com)
    _need(tuple(cnh0.shape) == (3, H, B, hd) and tuple(m0.shape) == (H, B, hd),
          what, f"state {tuple(cnh0.shape)}, m {tuple(m0.shape)} must be "
          f"(3, {H}, {B}, {hd}), ({H}, {B}, {hd})")
    _f32(what, cnh0=cnh0, m0=m0)
    _need(ckpt_every is None or 1 <= ckpt_every <= KMAX, what,
          f"ckpt_every {ckpt_every} not in [1, {KMAX}]")
    _need(not (collect and ckpt_every), what, "collect keeps no checkpoints")
    dev = z_in.device
    z_in, i_in, f_in, o_sig, R, cnh0, m0 = (
        t.contiguous() for t in (z_in, i_in, f_in, o_sig, R, cnh0, m0))
    _on_card(what, dev, z_in=z_in, i_in=i_in, f_in=f_in, o_sig=o_sig, R=R,
             cnh0=cnh0, m0=m0, upd=upd, com=com)
    lib = _build.load("slstm", _SLSTM_SIG)
    rb = slstm_fwd_plan(B, H, hd, _sm_count(dev))["rows"]
    f32 = dict(dtype=torch.float32, device=dev)
    hs = torch.empty((T, H, B, hd), **f32)
    if collect:
        cnh = torch.empty((3, T + 1, H, B, hd), **f32)
        m = torch.empty((T + 1, H, B, hd), **f32)
    else:
        cnh = torch.empty((3, H, B, hd), **f32)
        m = torch.empty((H, B, hd), **f32)
    ckpt = (torch.empty((ckpt_count(T, ckpt_every), 3, H, B, hd), **f32)
            if ckpt_every else None)
    out_at = _out_at(com, T, B, dev)
    err = lib.slstm_fwd(
        *(_ptr(t) for t in (z_in, i_in, f_in, o_sig, R, cnh0, m0, upd, out_at,
                            hs, cnh, m, ckpt)),
        T, B, H, hd, rb, int(collect), ckpt_every or 0,
        _build.cuda_stream_ptr(dev))
    _build.check(err, "slstm_scan launch")
    SLSTM_LAUNCHES += 1
    SLSTM_LAUNCHES_BY_SHAPE[(B, T)] += 1
    return (hs, cnh, m) if ckpt is None else (hs, cnh, m, ckpt)


def slstm_scan_bwd_cuda(z_in, i_in, f_in, o_sig, R, h0, upd, hs, ckpt,
                        ckpt_every: int, dhs, dcnh, dm):
    """Launch the sLSTM backward: the recompute of z, the walk and the dR
    passes (CUDA tensors only); returns what ``slstm_scan_bwd_ref``
    returns."""
    global SLSTM_BWD_LAUNCHES
    what = "slstm_scan_bwd"
    T, H, B, hd = _slstm_check(what, z_in, i_in, f_in, o_sig, R, upd, None)
    _need(1 <= ckpt_every <= KMAX, what, f"ckpt_every {ckpt_every}")
    nc = ckpt_count(T, ckpt_every)
    for name, t, want in (("h0", h0, (H, B, hd)), ("hs", hs, (T, H, B, hd)),
                          ("ckpt", ckpt, (nc, 3, H, B, hd)),
                          ("dhs", dhs, (T, H, B, hd)),
                          ("dcnh", dcnh, (3, H, B, hd)), ("dm", dm, (H, B, hd))):
        _need(tuple(t.shape) == want, what,
              f"{name} {tuple(t.shape)} must be {want}")
    _f32(what, h0=h0, hs=hs, ckpt=ckpt, dhs=dhs, dcnh=dcnh, dm=dm)
    dev = z_in.device
    _on_card(what, dev, z_in=z_in, i_in=i_in, f_in=f_in, o_sig=o_sig, R=R,
             h0=h0, upd=upd, hs=hs, ckpt=ckpt, dhs=dhs, dcnh=dcnh, dm=dm)
    lib = _build.load("slstm", _SLSTM_SIG)
    _need(lib.slstm_bwd_layout() == SLSTM_BWD_FIELDS, what,
          f"the library's scratch fields {lib.slstm_bwd_layout()} are not "
          f"{SLSTM_BWD_FIELDS}")
    plan = slstm_bwd_plan(B, H, hd, T, ckpt_every, _sm_count(dev))
    rb = plan["rows"]
    f32 = dict(dtype=torch.float32, device=dev)
    scratch = torch.empty((plan["scratch_floats"],), **f32)
    dz, di, df, do = (torch.empty((T, H, B, hd), **f32) for _ in range(4))
    dR = torch.empty((H, hd, hd), **f32)
    dcnh0 = torch.empty((3, H, B, hd), **f32)
    dm0 = torch.empty((H, B, hd), **f32)
    err = lib.slstm_bwd(
        *(_ptr(t) for t in (z_in, i_in, f_in, o_sig, R, h0, upd, hs, ckpt,
                            dhs, dcnh, dm, scratch, dz, di, df, do, dR, dcnh0,
                            dm0)),
        T, B, H, hd, rb, ckpt_every, _build.cuda_stream_ptr(dev))
    _build.check(err, "slstm_scan_bwd launch")
    SLSTM_BWD_LAUNCHES += 1
    return dz, di, df, do, dR, dcnh0, dm0


# float32 operations of one (b, element) step as (a, b): a hd + b, each
# counted once (derived in csrc/slstm.cu's note): the forward's 2 hd + 18
# and the backward's 6 hd + 45
SLSTM_OPS = (2, 18)
SLSTM_BWD_OPS = (6, 45)


def slstm_work(T: int, B: int, H: int, hd: int, collect: bool = False,
               ckpt_every: Optional[int] = None) -> Tuple[float, float]:
    """(flops, bytes) of one forward launch from shapes alone: z, i, f, o
    read once, hs written once, R read once, the state in and out once
    (every staged state with ``collect``), the checkpoints when kept."""
    n = T * B * H * hd
    st = 4 * B * H * hd * 4
    nbytes = 5 * n * 4 + H * hd * hd * 4 + st
    nbytes += (T + 1) * st if collect else st
    if ckpt_every:
        nbytes += ckpt_count(T, ckpt_every) * 3 * B * H * hd * 4
    a, b = SLSTM_OPS
    return float(n * (a * hd + b)), float(nbytes)


def slstm_bwd_work(T: int, B: int, H: int, hd: int, ckpt_every: int
                   ) -> Tuple[float, float]:
    """(flops, bytes) of one backward launch: z, i, f, o, hs, dhs and the
    checkpoints read once, dz, di, df, do written once, R and dR once,
    the state's adjoint in and out once."""
    n = T * B * H * hd
    nbytes = 6 * n * 4 + 4 * n * 4 + 2 * H * hd * hd * 4
    nbytes += 2 * 4 * B * H * hd * 4 + B * H * hd * 4
    nbytes += ckpt_count(T, ckpt_every) * 3 * B * H * hd * 4
    a, b = SLSTM_BWD_OPS
    return float(n * (a * hd + b)), float(nbytes)


def slstm_scan_fwd(z_in, i_in, f_in, o_sig, R, cnh0, m0, upd=None,
                   com=None, collect=False, ckpt_every=None):
    """The sLSTM scan's forward, with the checkpoints of ``ckpt_every``:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors;
    for meta tensors outputs of the shapes and ``slstm_work`` reported."""
    if z_in.is_cuda:
        return slstm_scan_cuda(z_in, i_in, f_in, o_sig, R, cnh0, m0, upd, com,
                               collect, ckpt_every)
    if z_in.is_meta:
        T, H, B, hd = z_in.shape
        _work.report("slstm_scan", *slstm_work(T, B, H, hd, collect,
                                               ckpt_every))
        e = dict(dtype=torch.float32, device="meta")
        lead = (T + 1,) if collect else ()
        out = (torch.empty((T, H, B, hd), **e),
               torch.empty((3, *lead, H, B, hd), **e),
               torch.empty((*lead, H, B, hd), **e))
        if not ckpt_every:
            return out
        return (*out, torch.empty((ckpt_count(T, ckpt_every), 3, H, B, hd),
                                  **e))
    return slstm_scan_ref(z_in, i_in, f_in, o_sig, R, cnh0, m0, upd, com,
                          collect, ckpt_every)


def slstm_scan_bwd(z_in, i_in, f_in, o_sig, R, h0, upd, hs, ckpt, ckpt_every,
                   dhs, dcnh, dm):
    """The sLSTM scan's backward: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors; for meta tensors outputs of the
    shapes, nothing launched, and ``slstm_bwd_work`` reported."""
    if z_in.is_cuda:
        return slstm_scan_bwd_cuda(z_in, i_in, f_in, o_sig, R, h0, upd, hs,
                                   ckpt, ckpt_every, dhs, dcnh, dm)
    if z_in.is_meta:
        T, H, B, hd = z_in.shape
        _work.report("slstm_scan_bwd", *slstm_bwd_work(T, B, H, hd,
                                                       ckpt_every))
        e = dict(dtype=torch.float32, device="meta")
        return (*(torch.empty_like(z_in, **e) for _ in range(4)),
                torch.empty_like(R, **e), torch.empty((3, H, B, hd), **e),
                torch.empty((H, B, hd), **e))
    return slstm_scan_bwd_ref(z_in, i_in, f_in, o_sig, R, h0, upd, hs, ckpt,
                              ckpt_every, dhs, dcnh, dm)


class SLSTMScan(torch.autograd.Function):
    """The sLSTM scan under autograd (dynamic state only): the forward
    launch with checkpoints of [c, n, m] every ``ckpt_every`` steps (h_t
    is the output), then the backward launch walking back from them."""

    @staticmethod
    def forward(ctx, z_in, i_in, f_in, o_sig, R, cnh0, m0, upd, ckpt_every):
        hs, cnh, m, ckpt = slstm_scan_fwd(z_in, i_in, f_in, o_sig, R, cnh0, m0,
                                      upd, None, False, ckpt_every)
        ctx.ckpt_every = ckpt_every
        ctx.save_for_backward(z_in, i_in, f_in, o_sig, R, cnh0, upd, hs,
                              ckpt)
        return hs, cnh, m

    @staticmethod
    def backward(ctx, dhs, dcnh, dm):
        z_in, i_in, f_in, o_sig, R, cnh0, upd, hs, ckpt = ctx.saved_tensors
        dz, di, df, do, dR, dcnh0, dm0 = slstm_scan_bwd(
            z_in, i_in, f_in, o_sig, R, cnh0[2].contiguous(), upd, hs, ckpt,
            ctx.ckpt_every, _zeros_if_none(dhs, hs),
            _zeros_if_none(dcnh, cnh0), _zeros_if_none(dm, hs[0]))
        return dz, di, df, do, dR, dcnh0, dm0, None, None


def slstm_scan(z_in, i_in, f_in, o_sig, R, cnh0, m0,
               upd: Optional[torch.Tensor] = None,
               com: Optional[torch.Tensor] = None, collect: bool = False,
               ckpt_every: int = CKPT_EVERY):
    """(hs (T, H, B, hd), [c, n, h], m) of the sLSTM recurrence (see
    ``slstm_scan_ref``): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors, the kernel's reported ``work`` for meta
    tensors; differentiable through ``SLSTMScan`` where autograd
    records (the dynamic state)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (z_in, i_in, f_in, o_sig, R, cnh0, m0)):
        if collect or com is not None:
            if z_in.is_cuda:
                raise NotImplementedError(
                    "slstm_scan: the backward kernel takes the dynamic state"
                    " only (no collect, no committed carry)")
            return slstm_scan_fwd(z_in, i_in, f_in, o_sig, R, cnh0, m0, upd, com,
                              collect)
        return SLSTMScan.apply(z_in, i_in, f_in, o_sig, R, cnh0, m0, upd,
                               ckpt_every)
    return slstm_scan_fwd(z_in, i_in, f_in, o_sig, R, cnh0, m0, upd, com, collect)
