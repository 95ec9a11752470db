#!/usr/bin/env python3
"""Builds of the suffix-match drafting kernels, timed in one call.

    python3 scripts/suffix_match_ab.py OLD.cu [OTHER.cu ...]
        [--cases idle,3b,3c,path] [--out FILE]

Needs one CUDA card. ``OLD.cu`` (and any ``OTHER.cu``) is another
version of ``src/repro_torch/csrc/suffix_match.cu`` (for example the
parent commit's: ``git show HEAD~1:src/repro_torch/csrc/suffix_match.cu
> build/old.cu``); its C entries may take the binary search's depth
(``n_steps``) after the forest sizes, as the kernels before the 33-way
search did. The script builds each beside the checkout's own source
(``nvcc`` with ``_build.NVCC_FLAGS``, ptxas report printed) and, for
each case, holds every build to the plain version bit for bit and times
them in turns (old, ..., new, new, ..., old: each build twice, 50
launches a turn; ``chip_smoke.Timer``: L2 flushed and a device-side
lead before each launch):

* ``idle``: phase 3b's forest with every row inactive (the fixed cost:
  launch, staging, outputs);
* ``3b``: ``chip_smoke.py``'s phase 3b (flat forest, B 8, m 64, K 16);
* ``3c``: phase 3c (64 trees, a forest larger than L2, B 64): the chunked
  kernel, and the flat kernel over the same trees;
* ``path``: the main path's own shapes, the second-epoch launch that
  proposed the most tokens in phase 4 (Qwen3-8B lock-step, flat) and in
  phase 5 (continuous, chunked), captured by running those phases at
  full width (random weights from a seed) with the checkout's build.

Prints a line per case and, last, one JSON object of every time (ms),
also written to ``--out``.
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
from repro_torch.kernels.suffix_match import ops as sm_ops  # noqa: E402
from repro_torch.kernels.suffix_match.ref import (  # noqa: E402
    n_search_steps,
    suffix_match_propose_chunked_ref,
    suffix_match_propose_ref,
)

REPS = 50  # launches timed per turn


def _old_args(fn, args, steps):
    """The current C entry's arguments in the order of the kernels before
    the 33-way search, which took n_steps after (B, m, E, C) in the flat
    entry and after (B, m, T, Es, Ns, Cs) in the chunked one. ``steps``
    maps the edge table's length to the value passed for n_steps."""
    args = list(args)
    if fn == "suffix_match_propose_flat":
        return args[:19] + [steps(args[17])] + args[19:]
    return args[:21] + [steps(args[18])] + args[21:]


class OldBuild:
    """Another ``suffix_match.cu`` built and loaded behind the current
    wrappers' C signatures (translated where it is an older build, which
    takes ``n_steps``)."""

    def __init__(self, src: Path, tag: str = "old"):
        text = src.read_bytes()
        h = hashlib.sha256(text + " ".join(_build.NVCC_FLAGS).encode())
        out = _build.BUILD_DIR / (f"suffix_match_{tag}-"
                                  f"{h.hexdigest()[:16]}.so")
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)],
            capture_output=True, text=True)
        self.log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise _build.KernelBuildError(f"nvcc failed for {src}:\n"
                                          f"{self.log}")
        self.lib = ctypes.CDLL(str(out))
        self.older = b"n_steps" in text
        for fn, argtypes in sm_ops._SIGNATURES.items():
            if self.older:
                argtypes = _old_args(fn, argtypes, lambda _: ctypes.c_int)
            f = getattr(self.lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int

    def _call(self, fn, args):
        if self.older:
            args = _old_args(fn, args, n_search_steps)
        return getattr(self.lib, fn)(*args)

    def suffix_match_propose_flat(self, *args):
        return self._call("suffix_match_propose_flat", args)

    def suffix_match_propose_chunked(self, *args):
        return self._call("suffix_match_propose_chunked", args)


def ptxas(log: str):
    return [ln.strip() for ln in log.splitlines()
            if "Used" in ln or "spill" in ln]


def path_cases(card):
    """Phase 4's and phase 5's second-epoch launch that proposed most."""
    cfg, params = cs.full_width_model(torch, "qwen3-8b")
    _, flat_spy = cs.phase_main_path(torch, np, card, cfg, params)
    *_, chunked_spy = cs.continuous_layouts(
        torch, np, cfg, params, "cuda", card, slots=8, n_problems=12,
        n_requests=24, limits=(32, 64, 128, 256), prompt_len=(128, 256),
        layouts=("chunked",))
    del params
    torch.cuda.empty_cache()
    out = {}
    for name, spy in (("path flat (phase 4)", flat_spy),
                      ("path chunked (phase 5)", chunked_spy)):
        (forest, q, kw), j = spy.path_case()
        out[name] = (spy.chunked, forest, q, kw,
                     f"epoch 2 launch {j + 1} of {len(spy.late)}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", type=Path, nargs="+")
    ap.add_argument("--cases", default="idle,3b,3c,path")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "suffix_match_ab.json")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: needs a CUDA card")
    card = cs.card_line()
    cs.log(f"card: {card} | torch {torch.__version__} cuda "
           f"{torch.version.cuda}")
    builds = {}
    for j, src in enumerate(a.others):
        tag = "old" if j == 0 else src.stem
        builds[tag] = OldBuild(src, tag)
        for ln in ptxas(builds[tag].log):
            cs.log(f"  [{tag}] {ln}")
    new = builds["new"] = _build.load("suffix_match", sm_ops._SIGNATURES)
    for ln in ptxas(_build.BUILD_LOG.get("suffix_match", "")):
        cs.log(f"  [new] {ln}")
    kw = dict(n_prop_max=16, min_match=1)
    cases = {}
    wanted = set(a.cases.split(","))
    forest, q = cs.flat_case(torch, np, "cuda")
    if "idle" in wanted:
        idle = (q[0], torch.full_like(q[1], -1), q[2])
        cases["idle flat"] = (False, forest, idle, kw, "no row active")
    if "3b" in wanted:
        cases["3b flat"] = (False, forest, q, kw, "phase 3b")
    if "3c" in wanted:
        cf, ff, q, flat_roots, _ = cs.chunked_case(torch, np, "cuda")
        cases["3c chunked"] = (True, cf, q, kw, "phase 3c")
        cases["3c flat, same trees"] = (False, ff, (q[0], flat_roots, q[2]),
                                        kw, "phase 3c")
    if "path" in wanted:
        cases.update(path_cases(card))
    timer = cs.Timer(torch)
    result = {"card": card, "reps": REPS, "cases": {}}
    for name, (chunked, forest, q, k, where) in cases.items():
        run = (sm_ops.suffix_match_propose_chunked_cuda if chunked
               else sm_ops.suffix_match_propose_cuda)
        ref = (suffix_match_propose_chunked_ref if chunked
               else suffix_match_propose_ref)
        want = ref(*q, *forest, **k)
        for tag, lib in builds.items():
            _build._LIBS["suffix_match"] = lib
            got = run(forest, *q, **k)
            torch.cuda.synchronize()
            for field, g, w in zip(("match_len", "n_prop", "props"), got,
                                   want):
                cs.check(torch.equal(g, w), f"{name}: the {tag} build's "
                         f"{field} differs from the plain version")
        turns = []
        tags = list(builds)
        for tag in tags + tags[::-1]:
            _build._LIBS["suffix_match"] = builds[tag]
            turns.append((tag, timer.ms(lambda: run(forest, *q, **k),
                                        REPS)))
        ms = {t: sum(v for u, v in turns if u == t) / 2 for t in tags}
        bound_ms, entries = cs.suffix_match_bound_ms(
            np, want, *q, forest, chunked=chunked, **k)
        B = q[0].shape[0]
        result["cases"][name] = dict(
            where=where, B=B, edges=list(forest.edge_node.shape),
            rows_active=int((q[1] >= 0).sum()),
            tokens_proposed=int(want[1].sum()), old_ms=ms["old"],
            new_ms=ms["new"], ms=ms, turns=turns, bound_ms=bound_ms)
        cs.log(f"{name} ({where}; B={B}, edges "
               f"{tuple(forest.edge_node.shape)}, "
               f"{int((q[1] >= 0).sum())} rows active, "
               f"{int(want[1].sum())} tokens proposed): every build "
               "bit-identical to the plain version; "
               + ", ".join(f"{t} {v * 1e3:.2f} us" for t, v in ms.items())
               + f" (old / new {ms['old'] / ms['new']:.2f}x; turns "
               + ", ".join(f"{t} {v * 1e3:.2f}" for t, v in turns)
               + f"), bound {bound_ms * 1e3:.4f} us ({entries} forest "
               f"entries)  [{card}]")
    _build._LIBS["suffix_match"] = new
    a.out.parent.mkdir(parents=True, exist_ok=True)
    a.out.write_text(json.dumps(result, indent=1))
    cs.log(json.dumps(result))


if __name__ == "__main__":
    main()
