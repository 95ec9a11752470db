#!/usr/bin/env python3
"""Builds of the sLSTM forward and the mLSTM backward kernels, held to
their plain versions and timed in turns in one call.

    python3 scripts/xlstm_ab.py [--slstm OLD.cu ...] [--mlstm OLD.cu ...]
        [--unchecked X.cu ...] [--sweep] [--cases LIST] [--out FILE]

Needs one CUDA card. Each ``--slstm`` source is another version of
``src/repro_torch/csrc/slstm.cu`` with the same C entries, each
``--mlstm`` source one of ``src/repro_torch/csrc/mlstm.cu`` (for example
the parent commit's: ``git show HEAD~1:src/repro_torch/csrc/slstm.cu >
build/ab/slstm_old.cu``). The script builds each beside the checkout's
own source (``nvcc`` with ``_build.NVCC_FLAGS``; the ptxas report of
every build is printed: registers, spills, shared memory) and times the
sLSTM forward (``slstm_fwd``) and the mLSTM backward (``mlstm_bwd``, its
reduce pass included) of every build in turns (the first given, the
others, the checkout's, then back: each build twice, ``chip_smoke.Timer``:
L2 flushed and a device-side lead before each launch), at
``chip_smoke.XLSTM_CASES``:

* the sLSTM forward at ``verify`` (B 8, T 17, staged states), ``rows``
  (B 64: two rows a CTA), ``edges`` (hd 64, a tie, pads, K 5), ``ragged``
  (hd 40) and ``train_4k`` (13b's B 16, T 4,096, checkpoints every 64);
* the mLSTM backward at ``train`` (B 16, T 256), ``edges``, ``ragged``
  and ``train_4k``, on the checkout's forward's saved tensors and seeded
  cotangents.

Every checked build is held to the plain version at
``chip_smoke.XLSTM_TOL`` (the forward's outputs and checkpoints at
``fwd``, the backward's eight cotangents at ``bwd``, and the backward
bit-identical over two launches). An mLSTM source that does not export
``mlstm_bwd_layout`` is called with the scratch and partials of the
layout before the redesign (25 floats a thread a step of scratch, a
partial row a column block); one that does gets scratch for the group
size it reports.

``--unchecked`` sources (an instrumented build: ``clock64()`` stamps, a
build that skips a part) are timed in the same turns without the check.
Their kernel is the entry they export (``slstm_fwd`` or ``mlstm_bwd``).
A build that exports ``xlstm_stamps(dst, n, reset)`` and
``xlstm_stamp_names()`` (a comma-separated list of region names) has its
stamps read after one launch of each case: cycles summed over the
region's visits by one thread of one CTA, printed per visit in cycles
and in microseconds at the SM clock the timer measured.

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

SLSTM_CASES = ("verify", "rows", "edges", "ragged", "train_4k")
MLSTM_CASES = ("train", "edges", "ragged", "train_4k")
# (B, T) of the sweep: the verify and training shapes and their neighbours
SWEEP = {"slstm": [(8, 17), (8, 256), (16, 17), (16, 256), (16, 1024),
                   (16, 4096), (64, 256)],
         "mlstm": [(16, 64), (16, 256), (16, 1024), (8, 1024), (16, 4096)]}


def build(src: Path, name: str, tag: str):
    """``src`` built with the wrapper's flags and loaded behind the
    wrapper's C signatures; returns (library, compiler log)."""
    sigs = xo._SLSTM_SIG if name == "slstm" else xo._MLSTM_SIG
    text = src.read_bytes()
    h = hashlib.sha256(text + " ".join(_build.NVCC_FLAGS).encode())
    out = _build.BUILD_DIR / f"{name}_{tag}-{h.hexdigest()[:16]}.so"
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
    return lib, log


def kind_of(src: Path) -> str:
    text = src.read_text()
    if 'extern "C" int slstm_fwd' in text:
        return "slstm"
    if 'extern "C" int mlstm_bwd' in text:
        return "mlstm"
    raise SystemExit(f"{src}: exports neither slstm_fwd nor mlstm_bwd")


def parent_mlstm_bwd(lib, q, k, v, i_pre, f_pre, upd, h, s, ckpt, mck, K,
                     dh, dCn, dm):
    """The mLSTM backward of a build with the layout before the redesign:
    scratch of 25 floats a thread a step for K steps, one partial row of
    dq and dk a column block and step, (dfg, dig, the denominator's dm) a
    block."""
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


def launcher(name: str, lib):
    """The call of ``lib``'s kernel under test on a case's arguments."""
    if name == "slstm":
        def run(args, kw):
            _build._LIBS["slstm"] = lib
            return xo.slstm_scan_cuda(*args, **kw)
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


def case_args(name: str, case, seed: int):
    """(arguments, keywords, plain version's outputs or None, work) of one
    case: the sLSTM forward's inputs, or the mLSTM backward's (the
    checkout's forward's saved tensors and seeded cotangents)."""
    tag, B, T, hd, dtype, state, masks, commit, collect, K = case
    H = cs.XLSTM_HEADS
    if name == "slstm":
        args = cs.slstm_inputs(torch, np, B, T, hd, state, masks, seed)
        kw = dict(collect=collect, ckpt_every=K)
        work = xo.slstm_work(T, B, H, hd, collect, K)
        return args, kw, work
    args = cs.mlstm_inputs(torch, np, B, T, hd, dtype, state, masks, seed)
    q, k, v, i_pre, f_pre, C0, n0, m0, upd = args
    h, cn, m, (ck, mck, s) = xo.mlstm_scan_fwd(
        q, k, v, i_pre, f_pre, C0, n0, m0, upd, ckpt_every=K)
    rng = np.random.default_rng(seed + 7)

    def cot(x):
        return torch.tensor(rng.normal(size=tuple(x.shape))
                            .astype(np.float32), device="cuda")

    bargs = (q, k, v, i_pre, f_pre, upd, h, s, ck, mck, K, cot(h),
             cot(cn), cot(m))
    work = xo.mlstm_bwd_work(T, B, H, hd, 2 if dtype == "bfloat16" else 4,
                             K)
    return bargs, {}, work


def plain(name, args, kw):
    if name == "slstm":
        return xr.slstm_scan_ref(*args, **kw)
    return xr.mlstm_scan_bwd_ref(*args)


def check_build(name, tag, run, args, kw, want, what):
    got = run(args, kw)
    torch.cuda.synchronize()
    if name == "slstm":
        names = ("hs", "[c,n,h]", "m", "ckpt")
        got = got if len(got) == 4 else (*got, None)
        want = want if len(want) == 4 else (*want, None)
        pairs = [(n, g, w) for n, g, w in zip(names, got, want)
                 if g is not None]
        err, rel = cs.xl_compare(torch, [p[0] for p in pairs],
                                 [p[1] for p in pairs], [p[2] for p in pairs],
                                 f"{what} [{tag}]", cs.XLSTM_TOL["fwd"])
        return err
    names = ("dq", "dk", "dv", "di", "df", "dC0", "dn0", "dm0")
    err, rel = cs.xl_compare(torch, names, got, want, f"{what} [{tag}]",
                             cs.XLSTM_TOL["bwd"])
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--slstm", type=Path, nargs="*", default=[])
    ap.add_argument("--mlstm", type=Path, nargs="*", default=[])
    ap.add_argument("--unchecked", type=Path, nargs="*", default=[])
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
    by_tag = {c[0]: c for c in cs.XLSTM_CASES}
    timer = cs.Timer(torch)
    result = {"card": card, "sm_cycles_per_us": timer.cycles_per_us,
              "kernels": {}}
    _build.build_all(["slstm", "mlstm"])
    for name in ("slstm", "mlstm"):
        if not srcs[name]:
            continue
        sigs = xo._SLSTM_SIG if name == "slstm" else xo._MLSTM_SIG
        libs, checked = {}, {}
        for p, chk in srcs[name]:
            tag = p.stem
            libs[tag], _build.BUILD_LOG[f"{name}_{tag}"] = build(p, name, tag)
            checked[tag] = chk
        _build._LIBS.pop(name, None)
        libs["new"] = _build.load(name, sigs)
        checked["new"] = True
        for tag in libs:
            for ln in _build.ptxas_lines(name if tag == "new"
                                         else f"{name}_{tag}"):
                cs.log(f"  [{name} {tag}] {ln}")
        runs = {t: launcher(name, lib) for t, lib in libs.items()}
        res = result["kernels"][name] = {"cases": {}, "sweep": {}}
        cases = [by_tag[t] for t in (SLSTM_CASES if name == "slstm"
                                     else MLSTM_CASES)
                 if not only or t in only]
        for ci, case in enumerate(cases):
            tag0, B, T, hd = case[:4]
            args, kw, (fl, nb) = case_args(name, case, 500 + 11 * ci)
            what = (f"{name} {'forward' if name == 'slstm' else 'backward'}"
                    f" {tag0} (B={B} T={T} hd={hd} {case[4]})")
            want = plain(name, args, kw)
            torch.cuda.synchronize()
            errs = {t: check_build(name, t, runs[t], args, kw, want, what)
                    for t in runs if checked[t]}
            del want
            reps = a.reps or (3 if T >= 1024 else 20)
            got, ms = turns(timer, runs,
                            lambda r: (lambda: r(args, kw)), reps)
            bound_ms, bound_by = cs.roofline_ms(nb, fl, "float32")
            st = {t: stamps(libs[t], runs[t], args, kw, timer.cycles_per_us)
                  for t in runs if hasattr(libs[t], "xlstm_stamps")}
            res["cases"][tag0] = dict(B=B, T=T, hd=hd, dtype=case[4], ms=ms,
                                      turns=got, max_abs_err=errs,
                                      bound_ms=bound_ms, bound_by=bound_by,
                                      stamps=st)
            base = next(iter(ms))
            cs.log(f"{what}: checked builds within "
                   f"{cs.XLSTM_TOL['fwd' if name == 'slstm' else 'bwd']} "
                   "(max |err| " + ", ".join(f"{t} {e:.2e}"
                                            for t, e in errs.items())
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
            del args
            torch.cuda.empty_cache()
        if a.sweep:
            base = by_tag["train_4k"]
            for B, T in SWEEP[name]:
                case = ("sweep", B, T, *base[3:])
                args, kw, _ = case_args(name, case, 900 + B + T)
                reps = a.reps or (3 if T >= 1024 else 20)
                got, ms = turns(timer, runs,
                                lambda r: (lambda: r(args, kw)), reps)
                res["sweep"][f"{B},{T}"] = ms
                cs.log(f"{name} sweep B={B} T={T}: " + ", ".join(
                    f"{t} {v:.4f} ms" for t, v in ms.items()) + f"  [{card}]")
                del args
                torch.cuda.empty_cache()
            fits = {}
            for t in runs:
                for B in sorted({b for b, _ in SWEEP[name]}):
                    pts = [(T, res["sweep"][f"{b},{T}"][t])
                           for b, T in SWEEP[name] if b == B]
                    if len(pts) < 2:
                        continue
                    Ts = np.array([p[0] for p in pts], float)
                    ys = np.array([p[1] for p in pts], float)
                    slope, icpt = np.polyfit(Ts, ys, 1)
                    fits[f"{t} B={B}"] = dict(fixed_ms=icpt,
                                              us_a_step=slope * 1e3)
                    cs.log(f"{name} [{t}] B={B}: {icpt:.4f} ms fixed + "
                           f"{slope * 1e3:.3f} us a step (T "
                           f"{', '.join(str(int(x)) for x in Ts)})  [{card}]")
            res["fits"] = fits
        _build._LIBS[name] = libs["new"]
    a.out.parent.mkdir(parents=True, exist_ok=True)
    a.out.write_text(json.dumps(result, indent=1))
    cs.log(json.dumps(result))


if __name__ == "__main__":
    main()
