#!/usr/bin/env python3
"""Builds of the RG-LRU scan kernel or of its backward, timed in turns in
one call.

    python3 scripts/rglru_ab.py OLD.cu [OTHER.cu ...] [--unchecked X.cu ...]
        [--admission B,T] [--out FILE]
    python3 scripts/rglru_ab.py --bwd OLD.cu [OTHER.cu ...] [--out FILE]

Needs one CUDA card. ``OLD.cu`` (and any ``OTHER.cu``) is another version
of ``src/repro_torch/csrc/rglru.cu`` with the same C entry (for example
the parent commit's: ``git show HEAD~1:src/repro_torch/csrc/rglru.cu >
build/ab/old.cu``). The script builds each beside the checkout's own
source (``nvcc`` with ``_build.NVCC_FLAGS``, ptxas report printed) and,
for each case, holds every build to the plain version bit for bit and
times them in turns (old, new, ..., new, old: each build twice, 50
launches a turn; ``chip_smoke.Timer``: L2 flushed and a device-side lead
before each launch):

* ``floor``: an empty kernel (``torch.cuda._sleep(0)``) and each build at
  (B 1, T 1, W 1): the timer's floor;
* at every case, a bandwidth yardstick: ``torch.addcmul`` over three
  (B, T, W) float32 arrays into a fourth, the 16 bytes an element the
  scan moves at every step (another function: what this card's memory
  gives such a stream under the same timer);
* ``chip_smoke.py``'s phase 3d cases: the verify block (B 8, T 17, W
  4096, frozen rows masked), the prefill batch (B 8, T 256, left pads),
  the longest prompt (B 1, T 2047), a ragged width (B 3, T 40, W 4000)
  and a width not a multiple of 4;
* ``admission``: phase 7's most frequent admission prefill (``B,T``, W
  4096, pads of a 16-token bucket), as ``chip_smoke.py`` logs it.

``--unchecked`` builds (say, a build that only copies, to see the copy
pattern's own time) are timed in the same turns without the check.
With ``--bwd`` the sources are versions of
``src/repro_torch/csrc/rglru_bwd.cu`` with the same C entry (``git show
HEAD~1:src/repro_torch/csrc/rglru_bwd.cu > build/ab/rglru_bwd_old.cu``),
and the cases are ``chip_smoke.py``'s ``RGLRU_BWD_CASES`` (the GRPO
step's shape (B 4, T 2272, W 4096), with left pads, a ragged width and a
width not a multiple of 4) on the forward kernel's hs: every build's dx,
dr, di, dΛ and dh0 bit-identical to ``rglru_scan_bwd_ref``, the builds
timed in turns after the same floor, beside a bandwidth yardstick of the
same 32 bytes a (b, t, w) (``Tensor.copy_`` of four (B, T, W) float32
arrays into four others), and each build's resident CTAs a SM at the
training shape where it has the occupancy query.

Prints a line per case with the card line and, last, one JSON object of
every time (ms), also written to ``--out``.
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
from repro_torch.kernels.rglru import ops as rg_ops  # noqa: E402
from repro_torch.kernels.rglru.ref import (  # noqa: E402
    rglru_scan_bwd_ref,
    rglru_scan_ref,
)

REPS = 50  # launches timed per turn


def build(src: Path, tag: str, name: str = "rglru",
          signatures=rg_ops._SIGNATURES):
    """``src`` built with the wrapper's flags and loaded behind its C
    signatures; returns (library, compiler log)."""
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
    for fn, argtypes in signatures.items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib, log


def turns(timer, builds, fn, name="rglru"):
    """Each build timed twice, in the order a, b, ..., b, a; returns the
    turns and each build's mean."""
    tags = list(builds)
    got = []
    for tag in tags + tags[::-1]:
        _build._LIBS[name] = builds[tag]
        got.append((tag, timer.ms(fn, REPS)))
    return got, {t: sum(v for u, v in got if u == t) / 2 for t in tags}


def main_bwd(a, card) -> dict:
    """The backward's builds at RGLRU_BWD_CASES (see the module's text)."""
    name, sigs = "rglru_bwd", rg_ops._BWD_SIGNATURES
    builds = {}
    for j, src in enumerate(a.others):
        tag = "old" if j == 0 else src.stem
        builds[tag], _build.BUILD_LOG[f"{name}_{tag}"] = build(
            src, tag, name, sigs)
        for ln in _build.ptxas_lines(f"{name}_{tag}"):
            cs.log(f"  [{tag}] {ln}")
    builds["new"] = _build.load(name, sigs)
    for ln in _build.ptxas_lines(name):
        cs.log(f"  [new] {ln}")
    _, B, T, W, _ = cs.RGLRU_BWD_CASES[0]  # the training shape
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    residency = {}
    for tag, lib in builds.items():
        if hasattr(lib, rg_ops._BWD_RESIDENCY[0]):
            _build._LIBS[name] = lib
            ctas, smem = rg_ops.rglru_scan_bwd_residency(T)
            residency[tag] = dict(ctas_per_sm=ctas, smem_bytes=smem,
                                  waves=cs.rglru_bwd_waves(B, W, ctas, n_sm))
            cs.log(f"[{tag}] at (B={B} T={T} W={W}): {smem} B of dynamic "
                   f"shared memory a CTA, {ctas} CTAs resident a SM on "
                   f"{n_sm} SMs: {residency[tag]['waves']} wave(s)")
    timer = cs.Timer(torch)
    result = {"card": card, "reps": REPS, "residency": residency,
              "cases": {}}
    empty = timer.ms(lambda: torch.cuda._sleep(0), REPS)
    tiny = cs.rglru_inputs(torch, np, 1, 1, 1, 0)
    tiny_hs, _ = rg_ops.rglru_scan_cuda(*tiny)
    tiny_args = (*tiny, tiny_hs, tiny_hs.clone(), tiny[4].clone())
    got, ms = turns(timer, builds,
                    lambda: rg_ops.rglru_scan_bwd_cuda(*tiny_args), name)
    result["floor"] = dict(empty_kernel_ms=empty, bwd_1x1x1_ms=ms,
                           turns=got)
    cs.log(f"timer floor: empty kernel {empty * 1e3:.2f} us; backward at "
           "(1, 1, 1) " + ", ".join(f"{t} {v * 1e3:.2f} us"
                                    for t, v in ms.items()) + f"  [{card}]")
    for ci, (label, B, T, W, mk) in enumerate(cs.RGLRU_BWD_CASES):
        seed = 90 + 4 * ci
        x, r, i, lam, h0 = cs.rglru_inputs(torch, np, B, T, W, seed)
        mask = cs.rglru_mask(torch, np, mk, B, T)
        hs, _ = rg_ops.rglru_scan_cuda(x, r, i, lam, h0, mask)
        rng = np.random.default_rng(seed + 1)
        dhs = torch.tensor(rng.normal(size=(B, T, W)), dtype=torch.float32,
                           device="cuda")
        dhf = torch.tensor(rng.normal(size=(B, W)), dtype=torch.float32,
                           device="cuda")
        args = (x, r, i, lam, h0, hs, dhs, dhf, mask)
        want = rglru_scan_bwd_ref(*args)
        for tag, lib in builds.items():
            _build._LIBS[name] = lib
            out = rg_ops.rglru_scan_bwd_cuda(*args)
            torch.cuda.synchronize()
            for what, g, w in zip(("dx", "dr", "di", "dlam", "dh0"), out,
                                  want):
                cs.check(torch.equal(g, w), f"{label}: the {tag} build's "
                         f"{what} is not bit-identical to the plain version "
                         f"(max |err| {float((g - w).abs().max())})")
        got, ms = turns(timer, builds,
                        lambda: rg_ops.rglru_scan_bwd_cuda(*args), name)
        src = torch.randn(4, B, T, W, device="cuda")
        dst = torch.empty_like(src)
        yard = timer.ms(lambda: dst.copy_(src), REPS)
        del src, dst
        bound_ms, bound_by = cs.rglru_bwd_bound_ms(B, T, W, mask)
        result["cases"][label] = dict(
            B=B, T=T, W=W, mask=mk, ms=ms, turns=got, copy_32B_ms=yard,
            bound_ms=bound_ms, bound_by=bound_by)
        cs.log(f"{label} (B={B} T={T} W={W}, mask: {mk}): every build's "
               "dx, dr, di, dΛ, dh0 bit-identical to the plain version; "
               + ", ".join(f"{t} {v * 1e3:.2f} us" for t, v in ms.items())
               + f" (old / new {ms['old'] / ms['new']:.2f}x; turns "
               + ", ".join(f"{t} {v * 1e3:.2f}" for t, v in got)
               + f"), 32-byte copy {yard * 1e3:.2f} us, bound "
               f"{bound_ms * 1e3:.2f} us ({bound_by})  [{card}]")
    _build._LIBS[name] = builds["new"]
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", type=Path, nargs="+")
    ap.add_argument("--bwd", action="store_true",
                    help="builds of csrc/rglru_bwd.cu (the backward)")
    ap.add_argument("--unchecked", type=Path, nargs="*", default=[])
    ap.add_argument("--admission", default="1,256",
                    help="B,T of phase 7's most frequent admission prefill")
    ap.add_argument("--out", type=Path)
    a = ap.parse_args()
    if a.out is None:
        a.out = ROOT / "build" / ("rglru_bwd_ab.json" if a.bwd
                                  else "rglru_ab.json")
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: needs a CUDA card")
    card = cs.card_line()
    cs.log(f"card: {card} | torch {torch.__version__} cuda "
           f"{torch.version.cuda}")
    if a.bwd:
        result = main_bwd(a, card)
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(result, indent=1))
        cs.log(json.dumps(result))
        return
    builds = {}
    for j, src in enumerate(a.others + a.unchecked):
        tag = "old" if j == 0 else src.stem
        builds[tag], _build.BUILD_LOG[f"rglru_{tag}"] = build(src, tag)
        for ln in _build.ptxas_lines(f"rglru_{tag}"):
            cs.log(f"  [{tag}] {ln}")
    builds["new"] = _build.load("rglru", rg_ops._SIGNATURES)
    for ln in _build.ptxas_lines("rglru"):
        cs.log(f"  [new] {ln}")
    # old first and last in every round of turns
    builds = {"old": builds.pop("old"), **builds}
    timer = cs.Timer(torch)
    result = {"card": card, "reps": REPS, "cases": {}}

    empty = timer.ms(lambda: torch.cuda._sleep(0), REPS)
    tiny = cs.rglru_inputs(torch, np, 1, 1, 1, 0)
    got, ms = turns(timer, builds, lambda: rg_ops.rglru_scan_cuda(*tiny))
    result["floor"] = dict(empty_kernel_ms=empty, scan_1x1x1_ms=ms,
                           turns=got)
    cs.log(f"timer floor: empty kernel {empty * 1e3:.2f} us; scan at "
           "(1, 1, 1) " + ", ".join(f"{t} {v * 1e3:.2f} us"
                                    for t, v in ms.items()) + f"  [{card}]")

    aB, aT = (int(v) for v in a.admission.split(","))
    cases = [*cs.RGLRU_CASES, ("admission", aB, aT, 4096, "bucket pads")]
    for ci, (label, B, T, W, mk) in enumerate(cases):
        copies = [cs.rglru_inputs(torch, np, B, T, W, 40 + 4 * ci + j)
                  for j in range(4)]
        mask = cs.rglru_mask(torch, np, mk, B, T)
        want = rglru_scan_ref(*copies[0], mask)
        for tag, lib in builds.items():
            if tag in {u.stem for u in a.unchecked}:
                continue
            _build._LIBS["rglru"] = lib
            got = rg_ops.rglru_scan_cuda(*copies[0], mask)
            torch.cuda.synchronize()
            for name, g, w in zip(("hs", "h_final"), got, want):
                cs.check(torch.equal(g, w), f"{label}: the {tag} build's "
                         f"{name} is not bit-identical to the plain version")
        it = {"i": 0}

        def nxt():
            it["i"] += 1
            return copies[it["i"] % len(copies)]

        got, ms = turns(timer, builds,
                        lambda: rg_ops.rglru_scan_cuda(*nxt(), mask))
        out = torch.empty_like(copies[0][0])
        yard = timer.ms(lambda: torch.addcmul(*nxt()[:3], out=out), REPS)
        bound_ms, bound_by = cs.rglru_bound_ms(copies[0][0], mask)
        every_ms, _ = cs.rglru_bound_ms(copies[0][0], mask,
                                        skip_masked=False)
        kept = B * T if mask is None else int(mask.sum())
        result["cases"][label] = dict(
            B=B, T=T, W=W, mask=mk, steps_kept=kept, ms=ms, turns=got,
            addcmul_ms=yard, bound_ms=bound_ms, bound_by=bound_by,
            bound_every_step_ms=every_ms)
        cs.log(f"{label} (B={B} T={T} W={W}, mask: {mk}, {kept} of {B * T} "
               "steps kept): every checked build bit-identical to the plain "
               "version; "
               + ", ".join(f"{t} {v * 1e3:.2f} us" for t, v in ms.items())
               + f" (old / new {ms['old'] / ms['new']:.2f}x; turns "
               + ", ".join(f"{t} {v * 1e3:.2f}" for t, v in got)
               + f"), addcmul {yard * 1e3:.2f} us, bound "
               f"{bound_ms * 1e3:.2f} us ({bound_by}; "
               f"{every_ms * 1e3:.2f} us reading every step)  [{card}]")
    _build._LIBS["rglru"] = builds["new"]
    a.out.parent.mkdir(parents=True, exist_ok=True)
    a.out.write_text(json.dumps(result, indent=1))
    cs.log(json.dumps(result))


if __name__ == "__main__":
    main()
