#!/usr/bin/env python3
"""Builds of the RG-LRU scan kernel, timed in turns in one call.

    python3 scripts/rglru_ab.py OLD.cu [OTHER.cu ...] [--unchecked X.cu ...]
        [--admission B,T] [--out FILE]

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
from repro_torch.kernels.rglru.ref import rglru_scan_ref  # noqa: E402

REPS = 50  # launches timed per turn


def build(src: Path, tag: str):
    """``src`` built with the wrapper's flags and loaded behind its C
    signature; returns (library, compiler log)."""
    text = src.read_bytes()
    h = hashlib.sha256(text + " ".join(_build.NVCC_FLAGS).encode())
    out = _build.BUILD_DIR / f"rglru_{tag}-{h.hexdigest()[:16]}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)],
        capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise _build.KernelBuildError(f"nvcc failed for {src}:\n{log}")
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in rg_ops._SIGNATURES.items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib, log


def turns(timer, builds, fn):
    """Each build timed twice, in the order a, b, ..., b, a; returns the
    turns and each build's mean."""
    tags = list(builds)
    got = []
    for tag in tags + tags[::-1]:
        _build._LIBS["rglru"] = builds[tag]
        got.append((tag, timer.ms(fn, REPS)))
    return got, {t: sum(v for u, v in got if u == t) / 2 for t in tags}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", type=Path, nargs="+")
    ap.add_argument("--unchecked", type=Path, nargs="*", default=[])
    ap.add_argument("--admission", default="1,256",
                    help="B,T of phase 7's most frequent admission prefill")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "rglru_ab.json")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: needs a CUDA card")
    card = cs.card_line()
    cs.log(f"card: {card} | torch {torch.__version__} cuda "
           f"{torch.version.cuda}")
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
