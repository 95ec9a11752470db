#!/usr/bin/env python3
"""Builds of the xLSTM recurrence kernels, held to their plain versions
and timed in turns in one call.

    python3 scripts/xlstm_ab.py [--slstm OLD.cu ...] [--mlstm OLD.cu ...]
        [--unchecked X.cu ...] [--kernels LIST] [--sweep] [--cases LIST]
        [--out FILE]

Needs one CUDA card. Each ``--slstm`` source is another version of
``src/repro_torch/csrc/slstm.cu`` with the same C entries, each
``--mlstm`` source one of ``src/repro_torch/csrc/mlstm.cu`` (for example
the parent commit's: ``git show HEAD~1:src/repro_torch/csrc/slstm.cu >
build/ab/slstm_old.cu``). The script builds each beside the checkout's
own source (``nvcc`` with ``_build.NVCC_FLAGS``; the ptxas report of
every build is printed: registers, spills, shared memory) and times the
four kernels of every build in turns (the first given, the others, the
checkout's, then back: each build twice, ``chip_smoke.Timer``: L2
flushed and a device-side lead before each launch), at
``chip_smoke.XLSTM_CASES``:

* the sLSTM forward (``slstm_fwd``) at ``verify`` (B 8, T 17, staged
  states), ``rows`` (B 64: two rows a CTA), ``edges`` (hd 64, a tie,
  pads, K 5), ``ragged`` (hd 40) and ``train_4k`` (13b's B 16, T 4,096,
  checkpoints every 64);
* the sLSTM backward (``slstm_bwd``, its recompute and dR passes
  included) at ``train`` (B 16, T 256), ``edges``, ``ragged``, ``rows``
  and ``train_4k``, on the checkout's forward's saved tensors and seeded
  cotangents;
* the mLSTM forward (``mlstm_fwd``) at ``verify``, ``prefill`` (B 8, T
  256, left pads), ``train``, ``edges``, ``ragged`` and ``train_4k``;
* the mLSTM backward (``mlstm_bwd``, its reduce pass included) at
  ``train``, ``edges``, ``ragged`` and ``train_4k``.

``--kernels`` keeps only the named kernels (``slstm_fwd``, ``slstm_bwd``,
``mlstm_fwd``, ``mlstm_bwd``); by default every kernel of a kind whose
sources are given. Every checked build is held to the plain version at
``chip_smoke.XLSTM_TOL`` (a forward's outputs and saved tensors at
``fwd``, a backward's cotangents at ``bwd``, and a backward
bit-identical over two launches). A source's layouts follow what it
exports: an mLSTM source without ``mlstm_bwd_layout`` gets the first
backward's scratch, one with it scratch for the group size it reports;
one without ``mlstm_staged_row`` gets staged states with unpadded rows;
an sLSTM source without ``slstm_bwd_layout`` gets the earlier walk's
scratch (4 floats an element a step of a chunk), one with it the
wrapper's plan for the fields it reports.

A build that exports ``slstm_dr`` (the dR pass alone: as ``(h0, hs, dz,
dR, T, B, H, hd, stream)``, or with split partials before dR where it
also exports ``slstm_bwd_layout``) has that pass timed alone at each sLSTM
backward case, beside ``torch.matmul`` of the same product (h_{t-1} by
dz over (t, b), the heads batched): a yardstick for that pass, not a
port; one that exports ``slstm_rec`` has its recompute of z timed alone
too.

``--unchecked`` sources (an instrumented build: ``clock64()`` stamps, a
build that skips a part) are timed in the same turns without the check;
the kind is the one whose entries they export. A build that exports
``xlstm_stamps(dst, n, reset)`` and ``xlstm_stamp_names()`` (a
comma-separated list of region names) has its stamps read after one
launch of each case: cycles summed over the region's visits by one
thread of one CTA, printed per visit in cycles and in microseconds at the
SM clock the timer measured.

``--sweep`` times the builds at more (B, T) to split a launch into a
fixed cost and a cost a step (a least-squares line in T for each B).
``--cases`` keeps only the named cases.

Prints a line per case with the card line and, last, one JSON object of
every time (ms), also written to ``--out`` (default
``build/xlstm_ab.json``).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.xlstm import ops as xo  # noqa: E402
from repro_torch.kernels.xlstm import ref as xr  # noqa: E402

# kernel -> (source kind, cases)
KERNELS = {
    "slstm_fwd": ("slstm", ("verify", "rows", "edges", "ragged", "train_4k")),
    "slstm_bwd": ("slstm", ("train", "edges", "ragged", "rows", "train_4k")),
    "mlstm_fwd": ("mlstm", ("verify", "prefill", "train", "edges", "ragged",
                            "train_4k")),
    "mlstm_bwd": ("mlstm", ("train", "edges", "ragged", "train_4k")),
}
# (B, T) of the sweep: the verify and training shapes and their neighbours
SWEEP = {"slstm_fwd": [(8, 17), (8, 256), (16, 17), (16, 256), (16, 1024),
                       (16, 4096), (64, 256)],
         "slstm_bwd": [(16, 256), (16, 1024), (8, 1024), (16, 4096)],
         "mlstm_fwd": [(8, 17), (8, 256), (16, 17), (16, 256), (16, 1024),
                       (16, 4096)],
         "mlstm_bwd": [(16, 64), (16, 256), (16, 1024), (8, 1024),
                       (16, 4096)]}
FWD_NAMES = {"slstm": ("hs", "[c,n,h]", "m"), "mlstm": ("h", "[C|n]", "m")}
BWD_NAMES = {"slstm": ("dz", "di", "df", "do", "dR", "dcnh0", "dm0"),
             "mlstm": ("dq", "dk", "dv", "di", "df", "dC0", "dn0", "dm0")}


def build(src: Path, kind: str, tag: str):
    """``src`` built with the wrapper's flags and loaded behind the
    wrapper's C signatures; returns (library, compiler log)."""
    sigs = xo._SLSTM_SIG if kind == "slstm" else xo._MLSTM_SIG
    text = src.read_bytes()
    h = hashlib.sha256(text + " ".join(_build.NVCC_FLAGS).encode())
    out = _build.BUILD_DIR / f"{kind}_{tag}-{h.hexdigest()[:16]}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)],
        capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise _build.KernelBuildError(f"nvcc failed for {src}:\n{log}")
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in sigs.items():
        if hasattr(lib, fn):
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
    if hasattr(lib, "xlstm_stamps"):
        lib.xlstm_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int]
        lib.xlstm_stamps.restype = ctypes.c_int
        lib.xlstm_stamp_names.restype = ctypes.c_char_p
    if hasattr(lib, "slstm_dr"):
        lib.slstm_dr.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        lib.slstm_dr.restype = ctypes.c_int
    return lib, log


def kind_of(src: Path) -> str:
    text = src.read_text()
    if 'extern "C" int slstm_fwd' in text:
        return "slstm"
    if 'extern "C" int mlstm_fwd' in text:
        return "mlstm"
    raise SystemExit(f"{src}: exports neither slstm_fwd nor mlstm_fwd")


def parent_mlstm_bwd(lib, q, k, v, i_pre, f_pre, upd, h, s, ckpt, mck, K,
                     dh, dCn, dm):
    """The mLSTM backward of a build with the first layout: scratch of 25
    floats a thread a step for K steps, one partial row of dq and dk a
    column block and step, (dfg, dig, the denominator's dm) a block."""
    T, B, H, hd = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    njb = (hd + 31) // 32
    scratch = torch.empty((njb * B * H, K, 25, 256), **f32)
    dq_part = torch.empty((T, B, H, njb, hd), **f32)
    dk_part = torch.empty((T, B, H, njb, hd), **f32)
    sc_part = torch.empty((T, B, H, njb, 3), **f32)
    dq, dk, dv = (torch.empty((T, B, H, hd), **f32) for _ in range(3))
    di, df = torch.empty((T, B, H), **f32), torch.empty((T, B, H), **f32)
    dcn0 = torch.empty((B, H, hd, hd + 1), **f32)
    dm0 = torch.empty((B, H), **f32)
    err = lib.mlstm_bwd(
        *(xo._ptr(t) for t in (q, k, v, i_pre, f_pre, upd, h, s, ckpt, mck,
                               dh, dCn, dm, scratch, dq_part, dk_part,
                               sc_part, dq, dk, dv, di, df, dcn0, dm0)),
        T, B, H, hd, int(q.dtype == torch.bfloat16), K,
        _build.cuda_stream_ptr(q.device))
    _build.check(err, "mlstm_bwd (the earlier layout) launch")
    return dq, dk, dv, di, df, dcn0[..., :hd], dcn0[..., hd], dm0


def parent_slstm_bwd(lib, z_in, i_in, f_in, o_sig, R, h0, upd, hs, ckpt, K,
                     dhs, dcnh, dm):
    """The sLSTM backward of a build with the earlier walk's layout:
    scratch of 4 floats (c, n, m, z) an element a step of a chunk, rows a
    CTA by the forward's rule."""
    T, H, B, hd = z_in.shape
    f32 = dict(dtype=torch.float32, device=z_in.device)
    rb = xo._rows_per_cta(B, H, xo._sm_count(z_in.device))
    scratch = torch.empty((H * -(-B // rb), K, rb, 4, hd), **f32)
    dz, di, df, do = (torch.empty((T, H, B, hd), **f32) for _ in range(4))
    dR = torch.empty((H, hd, hd), **f32)
    dcnh0 = torch.empty((3, H, B, hd), **f32)
    dm0 = torch.empty((H, B, hd), **f32)
    err = lib.slstm_bwd(
        *(xo._ptr(t) for t in (z_in, i_in, f_in, o_sig, R, h0, upd, hs, ckpt,
                               dhs, dcnh, dm, scratch, dz, di, df, do, dR,
                               dcnh0, dm0)),
        T, B, H, hd, rb, K, _build.cuda_stream_ptr(z_in.device))
    _build.check(err, "slstm_bwd (the earlier layout) launch")
    return dz, di, df, do, dR, dcnh0, dm0


def launcher(kernel: str, lib):
    """The call of ``lib``'s ``kernel`` on a case's arguments."""
    kind = KERNELS[kernel][0]
    if kernel.endswith("_fwd"):
        scan = xo.slstm_scan_cuda if kind == "slstm" else xo.mlstm_scan_cuda
        # an mLSTM build without mlstm_staged_row stages states unpadded
        unpadded = kind == "mlstm" and not hasattr(lib, "mlstm_staged_row")
        if unpadded:
            lib.mlstm_staged_row = lambda hd: hd + 1

        def run(args, kw):
            _build._LIBS[kind] = lib
            if not unpadded:
                return scan(*args, **kw)
            keep = xo.mlstm_staged_row
            xo.mlstm_staged_row = lambda hd: hd + 1
            try:
                return scan(*args, **kw)
            finally:
                xo.mlstm_staged_row = keep
        return run
    if kernel == "slstm_bwd":
        new = hasattr(lib, "slstm_bwd_layout")
        if new:
            lib.slstm_bwd_layout.argtypes = []
            lib.slstm_bwd_layout.restype = ctypes.c_int

        def run(args, kw):
            _build._LIBS["slstm"] = lib
            if not new:
                return parent_slstm_bwd(lib, *args)
            # a build's own scratch fields size its scratch
            keep = xo.SLSTM_BWD_FIELDS
            xo.SLSTM_BWD_FIELDS = lib.slstm_bwd_layout()
            try:
                return xo.slstm_scan_bwd_cuda(*args)
            finally:
                xo.SLSTM_BWD_FIELDS = keep
        return run
    new = hasattr(lib, "mlstm_bwd_layout")
    if new:
        lib.mlstm_bwd_layout.argtypes = []
        lib.mlstm_bwd_layout.restype = ctypes.c_int

    def run(args, kw):
        _build._LIBS["mlstm"] = lib
        if not new:
            return parent_mlstm_bwd(lib, *args)
        # a build's own group size sizes its scratch
        keep = xo.MLSTM_BWD_GROUP
        xo.MLSTM_BWD_GROUP = lib.mlstm_bwd_layout()
        try:
            return xo.mlstm_scan_bwd_cuda(*args)
        finally:
            xo.MLSTM_BWD_GROUP = keep
    return run


def case_args(kernel: str, case, seed: int):
    """(arguments, keywords, work) of one case: a forward's inputs, or a
    backward's (the checkout's forward's saved tensors and seeded
    cotangents)."""
    tag, B, T, hd, dtype, state, masks, commit, collect, K = case
    H = cs.XLSTM_HEADS
    kind = KERNELS[kernel][0]
    if kind == "slstm":
        args = cs.slstm_inputs(torch, np, B, T, hd, state, masks, seed)
    else:
        args = cs.mlstm_inputs(torch, np, B, T, hd, dtype, state, masks,
                               seed)
    upd = args[-1]
    in_bytes = 2 if dtype == "bfloat16" else 4
    if kernel.endswith("_fwd"):
        com = None
        if commit:
            com = cs.xl_commit(torch, B, T, (
                upd if upd is not None else
                torch.ones((T, B), dtype=torch.bool, device="cuda")), "cuda")
        kw = dict(com=com, collect=collect, ckpt_every=K)
        work = (xo.slstm_work(T, B, H, hd, collect, K) if kind == "slstm"
                else xo.mlstm_work(T, B, H, hd, in_bytes, collect, K))
        return args, kw, work
    rng = np.random.default_rng(seed + 7)

    def cot(x):
        return torch.tensor(rng.normal(size=tuple(x.shape))
                            .astype(np.float32), device="cuda")

    if kind == "slstm":
        z_in, i_in, f_in, o_sig, R, cnh0, m0, upd = args
        hs, cnh, m, ck = xo.slstm_scan_fwd(*args, ckpt_every=K)
        bargs = (z_in, i_in, f_in, o_sig, R, cnh0[2].contiguous(), upd, hs,
                 ck, K, cot(hs), cot(cnh), cot(m))
        return bargs, {}, xo.slstm_bwd_work(T, B, H, hd, K)
    q, k, v, i_pre, f_pre, C0, n0, m0, upd = args
    h, cn, m, (ck, mck, s) = xo.mlstm_scan_fwd(
        q, k, v, i_pre, f_pre, C0, n0, m0, upd, ckpt_every=K)
    bargs = (q, k, v, i_pre, f_pre, upd, h, s, ck, mck, K, cot(h),
             cot(cn), cot(m))
    return bargs, {}, xo.mlstm_bwd_work(T, B, H, hd, in_bytes, K)


def plain(kernel, args, kw):
    return {"slstm_fwd": lambda: xr.slstm_scan_ref(*args, **kw),
            "mlstm_fwd": lambda: xr.mlstm_scan_ref(*args, **kw),
            "slstm_bwd": lambda: xr.slstm_scan_bwd_ref(*args),
            "mlstm_bwd": lambda: xr.mlstm_scan_bwd_ref(*args)}[kernel]()


def check_build(kernel, tag, run, args, kw, want, what):
    kind = KERNELS[kernel][0]
    got = run(args, kw)
    torch.cuda.synchronize()
    if kernel.endswith("_fwd"):
        err, _ = cs.xl_compare(torch, FWD_NAMES[kind], got[:3], want[:3],
                               f"{what} [{tag}]", cs.XLSTM_TOL["fwd"])
        if len(want) == 4:  # the saved tensors
            sk = got[3] if kind == "mlstm" else (got[3],)
            sp = want[3] if kind == "mlstm" else (want[3],)
            e2, _ = cs.xl_compare(torch, ("ckpt", "mck", "q.n")[:len(sk)],
                                  sk, sp, f"{what} saved [{tag}]",
                                  cs.XLSTM_TOL["fwd"])
            err = max(err, e2)
        return err
    err, _ = cs.xl_compare(torch, BWD_NAMES[kind], got, want,
                           f"{what} [{tag}]", cs.XLSTM_TOL["bwd"])
    again = run(args, kw)
    torch.cuda.synchronize()
    cs.check(all(torch.equal(a, b) for a, b in zip(got, again)),
             f"{what} [{tag}]: two launches differ (not deterministic)")
    return err


def turns(timer, runs, fn_of, reps):
    """Each build timed twice, in the order a, b, ..., b, a; returns the
    turns and each build's mean."""
    tags = list(runs)
    got = []
    for tag in tags + tags[::-1]:
        got.append((tag, timer.ms(fn_of(runs[tag]), reps)))
    return got, {t: sum(v for u, v in got if u == t) / 2 for t in tags}


def stamps(lib, run, args, kw, cyc_per_us):
    """One launch's stamps of an instrumented build: {region: (visits,
    cycles a visit, us a visit)}."""
    n = 32
    buf = (ctypes.c_ulonglong * (2 * n))()
    lib.xlstm_stamps(ctypes.addressof(buf), n, 1)  # reset
    run(args, kw)
    torch.cuda.synchronize()
    lib.xlstm_stamps(ctypes.addressof(buf), n, 0)
    names = lib.xlstm_stamp_names().decode().split(",")
    out = {}
    for r, nm in enumerate(names):
        cyc, cnt = buf[r], buf[n + r]
        if cnt:
            out[nm] = (int(cnt), cyc / cnt, cyc / cnt / cyc_per_us)
    return out


def dr_times(timer, libs, args, reps, card):
    """The dR pass alone of every build that exports ``slstm_dr``, and
    ``torch.matmul`` of the same product, on the case's h_{t-1} and a dz
    from the checkout's backward: {name: ms}."""
    z_in, R, h0, hs = args[0], args[4], args[5], args[7]
    T, H, B, hd = z_in.shape
    _build._LIBS["slstm"] = libs["new"]
    dz = xo.slstm_scan_bwd_cuda(*args)[0]
    hp = torch.cat([h0[None], hs[:-1]])  # (T, H, B, hd): h_{t-1}
    a = hp.permute(1, 3, 0, 2).reshape(H, hd, T * B).contiguous()
    b = dz.permute(1, 0, 2, 3).reshape(H, T * B, hd).contiguous()
    out = {"torch.matmul": timer.ms(lambda: torch.matmul(a, b), reps)}
    want = torch.matmul(a, b)
    for tag, lib in libs.items():
        if not hasattr(lib, "slstm_dr"):
            continue
        dR = torch.empty((H, hd, hd), dtype=torch.float32, device="cuda")
        # a build with the plan's layout sums split partials in a last pass
        ptrs = [h0.data_ptr(), hs.data_ptr(), dz.data_ptr(), dR.data_ptr()]
        if hasattr(lib, "slstm_bwd_layout"):
            part = torch.empty((xo.slstm_dr_splits(T, B), H, hd, hd),
                               dtype=torch.float32, device="cuda")
            ptrs[3:3] = [part.data_ptr()]
            lib.slstm_dr.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] \
                * 4 + [ctypes.c_void_p]

        def go(lib=lib, ptrs=ptrs):
            _build.check(lib.slstm_dr(*ptrs, T, B, H, hd,
                                      _build.cuda_stream_ptr(dz.device)),
                         "slstm_dr launch")
        go()
        torch.cuda.synchronize()
        d, rel = cs.xl_err(torch, dR, want, f"dR [{tag}]")
        out[tag] = timer.ms(go, reps)
        cs.log(f"  dR pass alone [{tag}] {out[tag]:.4f} ms (against "
               f"torch.matmul: max |err| {d:.2e}, {rel:.2e} of the scale)"
               f"  [{card}]")
        if hasattr(lib, "slstm_rec"):  # the recompute of z alone
            zb = torch.empty_like(z_in)
            lib.slstm_rec.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] \
                * 4 + [ctypes.c_void_p]
            lib.slstm_rec.restype = ctypes.c_int

            def rec(lib=lib, zb=zb):
                _build.check(lib.slstm_rec(
                    z_in.data_ptr(), R.data_ptr(), h0.data_ptr(),
                    hs.data_ptr(), zb.data_ptr(), T, B, H, hd,
                    _build.cuda_stream_ptr(zb.device)), "slstm_rec launch")
            out[f"{tag} recompute"] = timer.ms(rec, reps)
            cs.log(f"  the recompute of z alone [{tag}] "
                   f"{out[f'{tag} recompute']:.4f} ms  [{card}]")
    cs.log(f"  torch.matmul of the same product {out['torch.matmul']:.4f} "
           f"ms (a yardstick, not a port)  [{card}]")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--slstm", type=Path, nargs="*", default=[])
    ap.add_argument("--mlstm", type=Path, nargs="*", default=[])
    ap.add_argument("--unchecked", type=Path, nargs="*", default=[])
    ap.add_argument("--kernels", default="")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--cases", default="")
    ap.add_argument("--reps", type=int, default=0,
                    help="launches a turn (default 20 below T 1024, 3 above)")
    ap.add_argument("--out", type=Path, default=ROOT / "build" /
                    "xlstm_ab.json")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: needs a CUDA card")
    card = cs.card_line()
    cs.log(f"card: {card} | torch {torch.__version__} cuda "
           f"{torch.version.cuda}")
    srcs = {"slstm": [(p, True) for p in a.slstm],
            "mlstm": [(p, True) for p in a.mlstm]}
    for p in a.unchecked:
        srcs[kind_of(p)].append((p, False))
    only = set(filter(None, a.cases.split(",")))
    kernels = [k for k in (a.kernels.split(",") if a.kernels else KERNELS)
               if srcs[KERNELS[k][0]]]
    by_tag = {c[0]: c for c in cs.XLSTM_CASES}
    timer = cs.Timer(torch)
    result = {"card": card, "sm_cycles_per_us": timer.cycles_per_us,
              "kernels": {}}
    _build.build_all(["slstm", "mlstm"])
    libs, checked = {"slstm": {}, "mlstm": {}}, {"slstm": {}, "mlstm": {}}
    for kind in ("slstm", "mlstm"):
        if not srcs[kind]:
            continue
        sigs = xo._SLSTM_SIG if kind == "slstm" else xo._MLSTM_SIG
        for p, chk in srcs[kind]:
            tag = p.stem
            libs[kind][tag], _build.BUILD_LOG[f"{kind}_{tag}"] = build(
                p, kind, tag)
            checked[kind][tag] = chk
        _build._LIBS.pop(kind, None)
        libs[kind]["new"] = _build.load(kind, sigs)
        checked[kind]["new"] = True
        for tag in libs[kind]:
            for ln in _build.ptxas_lines(kind if tag == "new"
                                         else f"{kind}_{tag}"):
                cs.log(f"  [{kind} {tag}] {ln}")
    for kernel in kernels:
        kind = KERNELS[kernel][0]
        runs = {t: launcher(kernel, lib) for t, lib in libs[kind].items()}
        res = result["kernels"][kernel] = {"cases": {}, "sweep": {}}
        cases = [by_tag[t] for t in KERNELS[kernel][1]
                 if not only or t in only]
        for ci, case in enumerate(cases):
            tag0, B, T, hd = case[:4]
            args, kw, (fl, nb) = case_args(kernel, case, 500 + 11 * ci)
            what = f"{kernel} {tag0} (B={B} T={T} hd={hd} {case[4]})"
            want = plain(kernel, args, kw)
            torch.cuda.synchronize()
            errs = {t: check_build(kernel, t, runs[t], args, kw, want, what)
                    for t in runs if checked[kind][t]}
            del want
            reps = a.reps or (3 if T >= 1024 else 20)
            got, ms = turns(timer, runs,
                            lambda r: (lambda: r(args, kw)), reps)
            bound_ms, bound_by = cs.roofline_ms(nb, fl, "float32")
            st = {t: stamps(libs[kind][t], runs[t], args, kw,
                            timer.cycles_per_us)
                  for t in runs if hasattr(libs[kind][t], "xlstm_stamps")}
            res["cases"][tag0] = dict(B=B, T=T, hd=hd, dtype=case[4], ms=ms,
                                      turns=got, max_abs_err=errs,
                                      bound_ms=bound_ms, bound_by=bound_by,
                                      stamps=st)
            base = next(iter(ms))
            tol = cs.XLSTM_TOL["fwd" if kernel.endswith("_fwd") else "bwd"]
            cs.log(f"{what}: checked builds within {tol} (max |err| "
                   + ", ".join(f"{t} {e:.2e}" for t, e in errs.items())
                   + "); " + ", ".join(f"{t} {v:.4f} ms" for t, v in
                                        ms.items())
                   + "; " + ", ".join(f"{base} / {t} {ms[base] / v:.2f}x"
                                      for t, v in ms.items() if t != base)
                   + "; turns " + ", ".join(f"{t} {v:.4f}" for t, v in got)
                   + f"; bound {bound_ms:.4f} ms ({bound_by})  [{card}]")
            for t, regs in st.items():
                cs.log(f"  stamps [{t}] {tag0}: " + "; ".join(
                    f"{nm} {c} visits, {cy:.0f} cycles = {us:.3f} us a visit"
                    for nm, (c, cy, us) in regs.items()))
            if kernel == "slstm_bwd":
                res["cases"][tag0]["dr_ms"] = dr_times(timer, libs[kind],
                                                       args, reps, card)
            del args
            torch.cuda.empty_cache()
        if a.sweep:
            base = by_tag["train_4k"]
            for B, T in SWEEP[kernel]:
                case = ("sweep", B, T, *base[3:])
                args, kw, _ = case_args(kernel, case, 900 + B + T)
                reps = a.reps or (3 if T >= 1024 else 20)
                got, ms = turns(timer, runs,
                                lambda r: (lambda: r(args, kw)), reps)
                res["sweep"][f"{B},{T}"] = ms
                cs.log(f"{kernel} sweep B={B} T={T}: " + ", ".join(
                    f"{t} {v:.4f} ms" for t, v in ms.items()) + f"  [{card}]")
                del args
                torch.cuda.empty_cache()
            fits = {}
            for t in runs:
                for B in sorted({b for b, _ in SWEEP[kernel]}):
                    pts = [(T, res["sweep"][f"{b},{T}"][t])
                           for b, T in SWEEP[kernel] if b == B]
                    if len(pts) < 2:
                        continue
                    Ts = np.array([p[0] for p in pts], float)
                    ys = np.array([p[1] for p in pts], float)
                    slope, icpt = np.polyfit(Ts, ys, 1)
                    fits[f"{t} B={B}"] = dict(fixed_ms=icpt,
                                              us_a_step=slope * 1e3)
                    cs.log(f"{kernel} [{t}] B={B}: {icpt:.4f} ms fixed + "
                           f"{slope * 1e3:.3f} us a step (T "
                           f"{', '.join(str(int(x)) for x in Ts)})  [{card}]")
            res["fits"] = fits
        _build._LIBS[kind] = libs[kind]["new"]
    a.out.parent.mkdir(parents=True, exist_ok=True)
    a.out.write_text(json.dumps(result, indent=1))
    cs.log(json.dumps(result))


if __name__ == "__main__":
    main()
