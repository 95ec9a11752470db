#!/usr/bin/env python3
"""Builds of spec-verify's float32 kernel, timed in turns in one call.

    python3 scripts/spec_verify_ab.py OLD.cu [OTHER.cu ...] [--out FILE]

Needs one CUDA card. ``OLD.cu`` (and any ``OTHER.cu``) is another version
of ``src/repro_torch/csrc/spec_verify.cu`` (for example the parent
commit's: ``git show HEAD~1:src/repro_torch/csrc/spec_verify.cu >
build/ab/spec_verify_old.cu``). The script builds each beside the
checkout's own source (``nvcc`` with ``_build.NVCC_FLAGS``; the ptxas
lines of its float32 instantiations printed). A build whose float32
entry takes a plan is launched through the wrapper; one whose entry
takes none (the kernel before the split-KV redesign: a block per 16
query rows) through that entry's own arguments.

For each case every build is held to the plain version within
``chip_smoke.SV_TOL["float32"]``, then the builds are timed in turns
(old, new, ..., new, old: each twice, 50 launches a turn;
``chip_smoke.Timer``: L2 flushed and a device-side lead before each
launch, four input sets cycled), beside the plain version, float32 SDPA
with the same boolean mask and the bound (``chip_smoke.sv_bound_ms``).
The cases: the timer's floor (an empty kernel); 10b's shape (Qwen3-8B:
B 8, T 17, 32/8 heads, hd 128, S+1 577) at the path's fill and with a
full ring; 10c's (Qwen2-1.5B: B 4, T 17, 12/2 heads, S+1 129) likewise;
hd 256 (16/1 heads) at phase 3a's small case (B 2, T 5, S+1 300, window
160) and at RecurrentGemma-9B's verify shape (B 8, T 17, S+1 577,
window 2048, the path's fill).

Prints a line per case with the card line and, last, one JSON object of
every time (ms), also written to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "scripts")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.spec_verify import ops as sv_ops  # noqa: E402
from repro_torch.kernels.spec_verify.ref import (  # noqa: E402
    spec_verify_attention_ref,
)
from rglru_ab import REPS, build  # noqa: E402

# The float32 entry of a source whose kernel takes no plan (before the
# split-KV redesign): q, k, v, cache_pos, positions, out; B, T, Hq, Hkv,
# S+1, hd, window; softcap, scale; the stream.
_P, _I, _F = sv_ops._P, sv_ops._I, sv_ops._F
UNPLANNED = {"spec_verify_attention_f32": (_P,) * 6 + (_I,) * 7 + (_F, _F, _P)}

# (label, B, T, Hq, Hkv, hd, S+1, window, cache lengths [lo, hi); hi None:
# up to a full ring)
CASES = [
    ("10b path fill", 8, 17, 32, 8, 128, 577, 0, cs.SV_PATH_FILL),
    ("10b full ring", 8, 17, 32, 8, 128, 577, 0, (128, None)),
    ("10c short prompts", 4, 17, 12, 2, 128, 129, 0, cs.SV_QWEN2_F32_FILL),
    ("10c full ring", 4, 17, 12, 2, 128, 129, 0, (8, None)),
    ("hd 256 small", 2, 5, 16, 1, 256, 300, 160, (100, None)),
    ("hd 256 verify", 8, 17, 16, 1, 256, 577, 2048, cs.SV_PATH_FILL),
]


def unplanned_call(lib):
    """A launcher of an entry that takes no plan."""
    def call(q, k, v, cpos, pos, window=0, softcap=0.0):
        B, T, Hq, hd = q.shape
        S1, Hkv = k.shape[1], k.shape[2]
        out = torch.empty_like(q)
        err = lib.spec_verify_attention_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), cpos.data_ptr(),
            pos.data_ptr(), out.data_ptr(), B, T, Hq, Hkv, S1, hd, window,
            softcap, 1.0 / hd ** 0.5, _build.cuda_stream_ptr(q.device))
        _build.check(err, "spec_verify_attention_f32 launch")
        return out
    return call


def wrapper_call(lib):
    """A launcher through the wrapper with ``lib`` loaded."""
    def call(*args, **kw):
        _build._LIBS["spec_verify"] = lib
        return sv_ops.spec_verify_attention_cuda(*args, **kw)
    return call


def f32_ptxas(tag, name):
    """The ptxas lines of the float32 instantiations in ``name``'s build
    (each entry's line and its spill and register lines)."""
    lines = _build.ptxas_lines(name)
    for i, ln in enumerate(lines):
        if "Compiling entry" in ln and "f32" in ln:
            for x in lines[i:i + 3]:
                cs.log(f"  [{tag}] {x}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", type=Path, nargs="+")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "spec_verify_ab.json")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    cs.log(f"card: {card} | torch {torch.__version__} cuda "
           f"{torch.version.cuda}")
    calls = {}
    for j, src in enumerate(a.others):
        tag = "old" if j == 0 else src.stem
        planned = b"int row_blocks" in src.read_bytes()
        lib, _build.BUILD_LOG[f"spec_verify_{tag}"] = build(
            src, tag, "spec_verify",
            sv_ops._SIGNATURES if planned else UNPLANNED)
        f32_ptxas(tag, f"spec_verify_{tag}")
        calls[tag] = wrapper_call(lib) if planned else unplanned_call(lib)
    new = _build.load("spec_verify", sv_ops._SIGNATURES)
    f32_ptxas("new", "spec_verify")
    calls["new"] = wrapper_call(new)
    tags = list(calls)
    timer = cs.Timer(torch)
    result = {"card": card, "reps": REPS, "cases": {}}
    result["empty_kernel_ms"] = timer.ms(lambda: torch.cuda._sleep(0), REPS)
    cs.log(f"timer floor: empty kernel {result['empty_kernel_ms'] * 1e3:.2f}"
           f" us  [{card}]")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for ci, (label, B, T, Hq, Hkv, hd, S1, window, (lo, hi)) in enumerate(
            CASES):
        copies = [cs.sv_inputs(torch, np, B, T, Hq, Hkv, hd, S1, "float32",
                               70 + 4 * ci + j, lo, hi) for j in range(4)]
        want = spec_verify_attention_ref(*copies[0], window=window)
        errs = {}
        for tag in tags:
            got = calls[tag](*copies[0], window=window)
            torch.cuda.synchronize()
            errs[tag] = float((got - want).abs().max())
            cs.check(bool(torch.isfinite(got).all()) and torch.allclose(
                got, want, **cs.SV_TOL["float32"]),
                f"{label}: the {tag} build differs from the plain version, "
                f"max |err| {errs[tag]}")
        it = {"i": 0}

        def nxt():
            it["i"] += 1
            return copies[it["i"] % len(copies)]

        got = []
        for tag in tags + tags[::-1]:
            got.append((tag, timer.ms(lambda: calls[tag](
                *nxt(), window=window), REPS)))
        ms = {t: sum(v for u, v in got if u == t) / 2 for t in tags}
        plain_ms = timer.ms(lambda: spec_verify_attention_ref(
            *nxt(), window=window), 10)
        sdpa_ms = timer.ms(cs.sv_sdpa_call(torch, copies, window), REPS)
        bound_ms, bound_by = cs.sv_bound_ms(np, copies[0], window, "float32")
        plan = sv_ops.f32_split_plan(B, T, Hq, Hkv, S1, hd, n_sm)
        result["cases"][label] = dict(
            B=B, T=T, Hq=Hq, Hkv=Hkv, hd=hd, S1=S1, window=window,
            lengths=[lo, hi], ms=ms, turns=got, max_abs_err=errs,
            plain_ms=plain_ms, sdpa_ms=sdpa_ms, bound_ms=bound_ms,
            bound_by=bound_by, plan=dict(
                n_split=plan.n_split, tiles_per_split=plan.tiles_per_split,
                row_blocks=plan.row_blocks, cta_rows=plan.cta_rows))
        cs.log(f"{label} (B={B} T={T} Hq={Hq} Hkv={Hkv} hd={hd} S+1={S1} "
               f"window={window}): every build within the plain version's "
               "tolerance; " + ", ".join(f"{t} {v * 1e3:.2f} us"
                                         for t, v in ms.items())
               + f" (old / new {ms['old'] / ms['new']:.2f}x; turns "
               + ", ".join(f"{t} {v * 1e3:.2f}" for t, v in got)
               + f"), plain {plain_ms * 1e3:.1f} us, SDPA {sdpa_ms * 1e3:.1f}"
               f" us, bound {bound_ms * 1e3:.2f} us ({bound_by}); plan "
               f"{plan.n_split} x {plan.tiles_per_split} tiles, "
               f"{plan.row_blocks} x {plan.cta_rows} rows  [{card}]")
    _build._LIBS["spec_verify"] = new
    a.out.parent.mkdir(parents=True, exist_ok=True)
    a.out.write_text(json.dumps(result, indent=1))
    cs.log(json.dumps(result))


if __name__ == "__main__":
    main()
