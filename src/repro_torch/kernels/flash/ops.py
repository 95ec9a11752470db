"""Wrappers of the flash attention kernels (``csrc/flash_attn.cu``), and
the autograd function that joins the forward to its backward.

``flash_fwd`` and ``flash_bwd`` take the kernel for CUDA tensors and
raise on what it does not take (device, dtype, contiguity, a head dim
past 256); for CPU tensors they run the plain version (``ref.py``); for
meta tensors they return outputs of the right shapes and report the
kernel's ``work`` (``kernels.work``). There is no fallback between them.

The kernels are built for head dims 64, 128 and 256 (``FLASH_HDS``);
any other head dim up to 256 is zero-padded to the next built one at
each launch (zero columns add nothing to q.k, the padded output columns
are cut, and the scale is the true head dim's). A (q tile, k tile) pair
with no visible pair is skipped: ``flash_tile_live`` is the kernels'
test, on the (min, max) positions of each ``RANGE_ROWS`` rows (the
kernels' pre-pass). The launch plans (threads, shared memory, tiles)
live in ``csrc/flash_attn.cu`` alone; its ``flash_plan`` export reads
them out.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels import work as _work
from repro_torch.kernels.flash.ref import flash_bwd_ref, flash_fwd_ref

# Launches of the kernels by these wrappers (one per call on CUDA; the
# backward's C entry runs its pre-pass, the dK/dV pass, the sum of its
# head groups' partials where there are several, and the dQ pass)
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

FLASH_HDS = (64, 128, 256)
RANGE_ROWS = 32  # query rows / keys of a tile-range entry
# CTAs the dK/dV pass aims for (a few waves of the card's 132 SMs): below
# it a key tile's G query heads are split over head groups (dkdv_parts)
DKDV_CTAS = 1024
KEY_TILE = 64  # keys a CTA of the dK/dV pass
# operations a visible (q, k) pair and head-dim column: q.k and p.v
# forward; q.k, dO.v, p dO, dS K and dS^T Q backward
FWD_OPS = 4
BWD_OPS = 10

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {
    "flash_fwd": (_P,) * 10 + (_I,) * 7 + (ctypes.c_float, _I, _P),
    "flash_bwd": (_P,) * 16 + (_I,) * 8 + (ctypes.c_float, _I, _P),
    "flash_plan": (_I, _I, _P),
}
PLAN_KERNELS = ("fwd", "dkdv", "dq")
PLAN_KEYS = ("threads", "smem", "rows", "cols", "stages")


def built_hd(hd: int) -> int:
    """The built head dim a head dim of ``hd`` runs at (zero-padded)."""
    for h in FLASH_HDS:
        if hd <= h:
            return h
    raise ValueError(f"flash attention: head dim {hd} > {FLASH_HDS[-1]}, "
                     "the largest the kernels are built for")


def dkdv_parts(B: int, Sk: int, Hkv: int, G: int) -> int:
    """Head groups of the dK/dV pass a (b, kv head, key tile): enough for
    ``DKDV_CTAS`` CTAs, at most G. With more than one, each group's CTA
    writes float32 partial sums that a last pass adds in group order."""
    base = B * Hkv * -(-Sk // KEY_TILE)
    return max(1, min(G, -(-DKDV_CTAS // base)))


# ---------------------------------------------------------------------------
# tile skipping and the work it leaves
# ---------------------------------------------------------------------------

def flash_tile_live(q_rng, k_rng, window: int):
    """Whether a (q tile, k tile) pair may hold a visible pair, from the
    tiles' (min, max) positions (``tile_live`` in the kernels): the keys'
    min at or below the queries' max and, with a window, the keys' max
    above the queries' min less the window. Broadcasts over leading
    dimensions; float32 arithmetic, as the kernels'."""
    q_rng = torch.as_tensor(q_rng, dtype=torch.float32)
    k_rng = torch.as_tensor(k_rng, dtype=torch.float32)
    live = k_rng[..., 0] <= q_rng[..., 1]
    if window > 0:
        live &= k_rng[..., 1] > q_rng[..., 0] - window
    return live


def visible_pairs(qpos, kpos, kval, window: int, rows: int = 1024) -> int:
    """Visible (q, k) pairs of one head summed over the batch, from the
    positions (a dense mask ``rows`` query rows at a time)."""
    n = 0
    for q0 in range(0, qpos.shape[1], rows):
        qp = qpos[:, q0:q0 + rows].float()[:, :, None]
        kp = kpos.float()[:, None, :]
        m = (kp <= qp) & (kval.float()[:, None, :] > 0)
        if window > 0:
            m &= kp > qp - window
        n += int(m.sum())
    return n


def causal_pairs(S: int, window: int) -> int:
    """Visible pairs of positions 0..S-1 (causal, with the window)."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def flash_work(B: int, Sq: int, Sk: int, Hkv: int, G: int, hd: int,
               esz: int, pairs: int, backward: bool = False
               ) -> Tuple[float, float]:
    """(flops, bytes) of one launch: ``FWD_OPS`` (``BWD_OPS``) x hd
    operations a visible pair and query head (``pairs`` counted over the
    batch for one head); bytes with each input read once and each output
    written once: q, k, v and the positions, then out and lse (forward),
    or out, dout and lse read and dq, dk, dv written (backward)."""
    nq, nk = B * Sq * Hkv * G * hd, B * Sk * Hkv * hd
    nbytes = (nq + 2 * nk) * esz + 4 * B * (Sq + 2 * Sk)
    nlse = 4 * B * Hkv * G * Sq
    if backward:
        nbytes += 2 * nq * esz + nlse + (nq + 2 * nk) * esz
        ops = BWD_OPS
    else:
        nbytes += nq * esz + nlse
        ops = FWD_OPS
    return float(ops * hd * pairs * Hkv * G), float(nbytes)


# ---------------------------------------------------------------------------
# the CUDA wrappers
# ---------------------------------------------------------------------------

def _check(what, q, k, v, qpos, kpos, kval):
    if q.dim() != 5 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{what}: q {tuple(q.shape)} must be (B, Sq, Hkv, "
                         f"G, hd), k {tuple(k.shape)} and v {tuple(v.shape)} "
                         "(B, Sk, Hkv, hd)")
    B, Sq, Hkv, G, hd = q.shape
    Sk = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, Hkv, hd):
        raise ValueError(f"{what}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree")
    if min(B, Sq, Sk, Hkv, G, hd) < 1:
        raise ValueError(f"{what}: empty shape q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    built_hd(hd)
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: q, k, v must be one of bfloat16 / float32, "
                        f"are {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t, want in (("qpos", qpos, (B, Sq)), ("kpos", kpos, (B, Sk)),
                          ("kval", kval, (B, Sk))):
        if tuple(t.shape) != want or t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} {t.dtype} "
                             f"must be {want} float32")
    _on_card(what, q.device, q=q, k=k, v=v, qpos=qpos, kpos=kpos, kval=kval)
    return B, Sq, Sk, Hkv, G, hd


def _on_card(what, dev, **tensors):
    for name, t in tensors.items():
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{what}: {name} is not on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned")


def _pad(t: torch.Tensor, hd: int) -> torch.Tensor:
    return t if t.shape[-1] == hd else F.pad(t, (0, hd - t.shape[-1]))


def _cut(t: torch.Tensor, hd: int) -> torch.Tensor:
    return t if t.shape[-1] == hd else t[..., :hd].contiguous()


def _load():
    return _build.load("flash_attn", _SIG)


def flash_plan(hd: int, dtype: torch.dtype) -> dict:
    """The three kernels' launches at a built head dim, as the library
    has them (``Plan`` in ``csrc/flash_attn.cu``): per kernel its threads,
    dynamic shared memory (bytes), the rows it owns, the rows it steps
    over (keys for the forward and dQ, queries for dK/dV) and the stages
    of its copy ring. Builds the library."""
    got = (ctypes.c_int * (len(PLAN_KERNELS) * len(PLAN_KEYS)))()
    _build.check(_load().flash_plan(hd, int(dtype == torch.bfloat16),
                                    ctypes.cast(got, _P)), "flash_plan")
    it = iter(got)
    return {kernel: {key: next(it) for key in PLAN_KEYS}
            for kernel in PLAN_KERNELS}


def flash_fwd_cuda(q, k, v, qpos, kpos, kval, window: int):
    """Launch the forward (CUDA tensors only); returns (out, lse) as
    ``flash_fwd_ref`` does."""
    global FWD_LAUNCHES
    what = "flash_fwd"
    B, Sq, Sk, Hkv, G, hd = _check(what, q, k, v, qpos, kpos, kval)
    HD = built_hd(hd)
    dev = q.device
    q, k, v = (_pad(t, HD) for t in (q, k, v))
    lib = _load()
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    lse = torch.empty((B, Hkv, G, Sq), **f32)
    qr = torch.empty((B, -(-Sq // RANGE_ROWS), 2), **f32)
    kr = torch.empty((B, -(-Sk // RANGE_ROWS), 2), **f32)
    err = lib.flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qpos.data_ptr(),
        kpos.data_ptr(), kval.data_ptr(), qr.data_ptr(), kr.data_ptr(),
        out.data_ptr(), lse.data_ptr(), B, Sq, Sk, Hkv, G, HD,
        int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(hd), int(window),
        _build.cuda_stream_ptr(dev))
    _build.check(err, "flash_fwd launch")
    FWD_LAUNCHES += 1
    return _cut(out, hd), lse


def flash_bwd_cuda(q, k, v, qpos, kpos, kval, out, lse, dout, window: int):
    """Launch the backward (CUDA tensors only); returns (dq, dk, dv) as
    ``flash_bwd_ref`` does."""
    global BWD_LAUNCHES
    what = "flash_bwd"
    B, Sq, Sk, Hkv, G, hd = _check(what, q, k, v, qpos, kpos, kval)
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} {t.dtype} must "
                             f"be q's {tuple(q.shape)} {q.dtype}")
    if tuple(lse.shape) != (B, Hkv, G, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"{what}: lse {tuple(lse.shape)} {lse.dtype} must "
                         f"be {(B, Hkv, G, Sq)} float32")
    dev = q.device
    _on_card(what, dev, out=out, dout=dout, lse=lse)
    HD = built_hd(hd)
    q, k, v, out, dout = (_pad(t, HD) for t in (q, k, v, out, dout))
    lib = _load()
    f32 = dict(dtype=torch.float32, device=dev)
    qr = torch.empty((B, -(-Sq // RANGE_ROWS), 2), **f32)
    kr = torch.empty((B, -(-Sk // RANGE_ROWS), 2), **f32)
    D = torch.empty((B, Hkv, G, Sq), **f32)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    parts = dkdv_parts(B, Sk, Hkv, G)
    part = (torch.empty((2, parts) + tuple(k.shape), **f32) if parts > 1
            else None)
    err = lib.flash_bwd(
        *(t.data_ptr() for t in (q, k, v, qpos, kpos, kval, out, dout, lse,
                                 qr, kr, D, dq, dk, dv)),
        None if part is None else part.data_ptr(),
        B, Sq, Sk, Hkv, G, HD, parts, int(q.dtype == torch.bfloat16),
        1.0 / math.sqrt(hd), int(window), _build.cuda_stream_ptr(dev))
    _build.check(err, "flash_bwd launch")
    BWD_LAUNCHES += 1
    return _cut(dq, hd), _cut(dk, hd), _cut(dv, hd)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def _chunk(n: int, c: Optional[int], default: int) -> int:
    """The plain version's tile chunk along a length of n: ``c`` when
    given, else ``default`` where it divides n, else n."""
    if c is None:
        c = min(default, n)
        return c if n % c == 0 else n
    if n % c:
        raise ValueError(f"flash attention: chunk {c} does not divide {n}")
    return c


def _on_cpu(what, *tensors):
    for t in tensors:
        if t.device.type != "cpu":
            raise ValueError(f"{what}: a {t.device} tensor: the kernels take "
                             "CUDA tensors, the plain version CPU tensors")


def _meta_work(q, k, window, backward, length):
    """The kernel's work on meta tensors, whose positions have no values:
    positions 0..S-1, causal, with the window, no key masked, S being
    ``length`` (the sequence before any chunk padding, whose pads see no
    key) or else the shorter of Sq and Sk; bytes at that length too."""
    B, Sq, Hkv, G, hd = q.shape
    S = length if length is not None else min(Sq, k.shape[1])
    pairs = B * causal_pairs(S, window)
    return flash_work(B, S, S, Hkv, G, hd, q.element_size(), pairs,
                      backward)


def flash_fwd(q, k, v, qpos, kpos, kval, window: int,
              qc: Optional[int] = None, kc: Optional[int] = None,
              length: Optional[int] = None):
    """(out (B, Sq, Hkv, G, hd) in q's dtype, lse (B, Hkv, G, Sq) float32)
    of the flash forward: the kernel for CUDA tensors, the plain version
    (tiles of ``qc`` x ``kc``) for CPU tensors, outputs of the shapes and
    the kernel's reported ``work`` for meta tensors (counted at
    ``length``, see ``_meta_work``)."""
    if q.is_cuda:
        return flash_fwd_cuda(q, k, v, qpos, kpos, kval, window)
    B, Sq, Hkv, G, _ = q.shape
    if q.is_meta:
        _work.report("flash_attn_fwd",
                     *_meta_work(q, k, window, False, length))
        return (torch.empty_like(q),
                torch.empty((B, Hkv, G, Sq), dtype=torch.float32,
                            device="meta"))
    _on_cpu("flash_fwd", q, k, v, qpos, kpos, kval)
    return flash_fwd_ref(q, k, v, qpos, kpos, kval, window,
                         _chunk(Sq, qc, 512), _chunk(k.shape[1], kc, 1024))


def flash_bwd(q, k, v, qpos, kpos, kval, out, lse, dout, window: int,
              qc: Optional[int] = None, kc: Optional[int] = None,
              length: Optional[int] = None):
    """(dq, dk, dv) in the inputs' dtypes: the kernels for CUDA tensors,
    the plain version for CPU tensors, gradients of the shapes and the
    kernels' reported ``work`` for meta tensors."""
    if q.is_cuda:
        return flash_bwd_cuda(q, k, v, qpos, kpos, kval, out, lse, dout,
                              window)
    if q.is_meta:
        _work.report("flash_attn_bwd",
                     *_meta_work(q, k, window, True, length))
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _on_cpu("flash_bwd", q, k, v, qpos, kpos, kval, out, lse, dout)
    return flash_bwd_ref(q, k, v, qpos, kpos, kval, out, lse, dout, window,
                         _chunk(q.shape[1], qc, 512),
                         _chunk(k.shape[1], kc, 1024))


class FlashAttention(torch.autograd.Function):
    """Flash attention with a hand-written backward (O(S) memory forward
    AND backward), the counterpart of the reference's ``custom_vjp``
    ``_flash``. q: (B, Sq, Hkv, G, hd); k/v: (B, Sk, Hkv, hd);
    qpos/kpos/kval are float tensors; ``length``, the sequence before
    chunk padding, only sizes the work counted on meta tensors. Saved
    residuals: the inputs plus ``out`` and ``lse`` only — the backward
    recomputes P per tile, so no (Sq, Sk) tensor outlives a tile."""

    @staticmethod
    def forward(ctx, q, k, v, qpos, kpos, kval, window, qc, kc, length=None):
        out, lse = flash_fwd(q, k, v, qpos, kpos, kval, window, qc, kc,
                             length)
        ctx.save_for_backward(q, k, v, qpos, kpos, kval, out, lse)
        ctx.cfg = (window, qc, kc, length)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, qpos, kpos, kval, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, qpos, kpos, kval, out, lse,
                               dout.contiguous(), *ctx.cfg)
        return dq, dk, dv, None, None, None, None, None, None, None
