#!/usr/bin/env python3
"""Builds of the flash attention kernels (``csrc/flash_attn.cu``) held to
their plain version and timed in turns, beside the plain version and
SDPA, and a GRPO step of two checkouts in turns.

    python3 scripts/flash_ab.py [--old OLD.cu ...] [--cases LIST]
        [--dtypes LIST] [--one-group] [--grpo ROOT ...] [--out FILE]

Needs one CUDA card. Each ``--old`` source is another version of
``src/repro_torch/csrc/flash_attn.cu`` with the same C entries (for
example the parent commit's: ``git show HEAD~1:src/repro_torch/csrc/
flash_attn.cu > build/ab/flash_old.cu``). The script builds each beside
the checkout's own source (``nvcc`` with ``_build.NVCC_FLAGS``; every
build's ptxas report is printed: registers, spills, shared memory) and,
at each case of ``CASES``, holds every build to the plain version
(``kernels/flash/ref.py``) within ``chip_smoke.FLASH_TOL`` (out, lse,
dq, dk, dv; the backward bit-identical over two launches), then times
the forward and the backward of every build in turns (the first given,
the others, the checkout's, then back: ``chip_smoke.Timer``, L2 flushed
and a device-side lead before each launch), splits the checkout's
backward into its kernels' device times (``torch.profiler``, L2 warm),
and times once each the plain
version's forward and backward and SDPA's forward + backward with the
same boolean mask and with ``is_causal`` (yardsticks; the port never
calls SDPA). Bounds are ``flash_work`` at this run's visible pairs.

Cases (causal, positions 0..S-1, no pads; the layer's chunk pads are
dead tiles the kernels skip, so they are left out):

* ``8a``: B 4, S 2,304, 12/2 heads of 128 (Qwen2-1.5B, phase 8a);
* ``13c``: B 12, S 4,096, 16/16 heads of 64 (SeamlessM4T-medium's
  decoder self-attention in 13c's GRPO step);
* ``9``: B 4, S 2,272, 16/1 heads of 256, window 2,048
  (RecurrentGemma-9B's local attention in 9b's GRPO step).

``--one-group`` adds the checkout's backward with the dK/dV pass's head
groups forced to one (``dkdv_parts``: a key tile's G heads walked by
one CTA, no partials), checked and timed in the same turns.
``--cases`` keeps only the named cases (``none``: no kernel case, the
GRPO turns alone); ``--dtypes`` picks among bfloat16 (default) and
float32.

``--grpo ROOT ...`` times 8c's GRPO step (Qwen2-1.5B at its published
config, 4 rows of 2,100 and 2,200 seeded prompt tokens and 64 seeded
response tokens, ``grpo_loss`` + ``param_grads`` + AdamW) of each
checkout root given (for example this checkout and a ``git archive`` of
its parent unpacked under ``build/``), each in a process of its own
importing that root's ``src``, in turns (the roots in order, then
reversed): per turn the median of 3 warm steps and the peak memory.

Prints a line per case with the card line and, last, one JSON object of
every time (ms), also written to ``--out`` (default
``build/flash_ab.json``).
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

# tag: (B, S, Hq, Hkv, hd, window)
CASES = {"8a": (4, 2304, 12, 2, 128, 0),
         "13c": (12, 4096, 16, 16, 64, 0),
         "9": (4, 2272, 16, 1, 256, 2048)}
GRPO_REPS = 3


def build(src: Path, tag: str):
    """``src`` built with the wrapper's flags and loaded behind the
    wrapper's C signatures; returns (library, compiler log)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash import ops as fo

    text = src.read_bytes()
    h = hashlib.sha256(text + " ".join(_build.NVCC_FLAGS).encode())
    out = _build.BUILD_DIR / f"flash_attn_{tag}-{h.hexdigest()[:16]}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)],
        capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise _build.KernelBuildError(f"nvcc failed for {src}:\n{log}")
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in fo._SIG.items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib, log


def with_lib(variant, fn):
    """``fn`` run with the wrappers launching ``variant``'s kernels: (a
    library, and the dK/dV pass's head groups where fixed, else None)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash import ops as fo

    lib, parts = variant

    def run():
        keep = _build._LIBS["flash_attn"], fo.dkdv_parts
        _build._LIBS["flash_attn"] = lib
        if parts is not None:
            fo.dkdv_parts = lambda *shape: parts
        try:
            return fn()
        finally:
            _build._LIBS["flash_attn"], fo.dkdv_parts = keep
    return run


def kernel_split(torch, fn, calls=3):
    """{kernel name: device ms a call} of ``fn``'s launches, summed over
    ``calls`` calls by ``torch.profiler`` (L2 warm); empty where the
    profiler shows no device events."""
    import re
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            m = re.search(r"flash_\w+?_kernel", e.name)
            split[m.group(0) if m else e.name] += \
                e.time_range.elapsed_us() / 1e3 / calls
    return dict(split)


def kernel_cases(a, cs, torch, np, card):
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash import ops as fo
    from repro_torch.kernels.flash import ref as fr

    libs = {}
    for p in a.old:
        libs[p.stem], _build.BUILD_LOG[f"flash_attn_{p.stem}"] = build(
            p, p.stem)
    _build.build_all(["flash_attn"])
    libs["new"] = fo._load()
    for tag in libs:
        for ln in _build.ptxas_lines("flash_attn" if tag == "new"
                                     else f"flash_attn_{tag}"):
            cs.log(f"  [flash_attn {tag}] {ln}")
    variants = {t: (lib, None) for t, lib in libs.items()}
    if a.one_group:
        variants["new-1group"] = (libs["new"], 1)
    timer = cs.Timer(torch)
    result = {}
    only = [c for c in (a.cases.split(",") if a.cases else CASES)]
    for ci, tag in enumerate(only):
        B, S, Hq, Hkv, hd, window = CASES[tag]
        for dtype in a.dtypes.split(","):
            dt = getattr(torch, dtype)
            args, dout = cs.flash_case_inputs(torch, np, B, S, Hkv, Hq // Hkv,
                                              hd, window, None, dt, 700 + ci)
            what = (f"{tag} {dtype} (B={B} S={S} {Hq}/{Hkv} heads of {hd}, "
                    f"window {window})")
            # the plain version's chunks as the layer's (512 x 1024) where
            # they divide S, else one tile of S
            qc = 512 if S % 512 == 0 else S
            kc = 1024 if S % 1024 == 0 else S
            errs = {}
            for t, var in variants.items():
                errs[t] = with_lib(var, lambda: cs.flash_check(
                    torch, card, f"{what} [{t}]", args, dout, window, dtype,
                    qc, kc))()
            out, lse = fo.flash_fwd_cuda(*args, window)
            runs = {}
            for t, var in variants.items():
                if var[1] is None:
                    runs[f"{t} fwd"] = with_lib(
                        var, lambda: fo.flash_fwd_cuda(*args, window))
                runs[f"{t} bwd"] = with_lib(
                    var, lambda: fo.flash_bwd_cuda(*args, out, lse, dout,
                                                   window))
            order = list(runs)
            ms = {k: [] for k in order}
            for k in order + order[::-1]:
                ms[k].append(timer.ms(runs[k], 5 if S > 3000 else 10,
                                      warmup=1))
            times = {k: sum(v) / len(v) for k, v in ms.items()}
            q, k_, v_ = args[:3]
            qs = q.reshape(B, S, Hq, hd).transpose(1, 2).contiguous() \
                .requires_grad_()
            ks, vs = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (k_, v_))
            ds = dout.reshape(B, S, Hq, hd).transpose(1, 2).contiguous()
            pos = torch.arange(S, device="cuda")
            mask = pos[None, :] <= pos[:, None]
            if window:
                mask &= pos[None, :] > pos[:, None] - window
            mask = mask[None, None]

            def sdpa(causal):
                o = (F.scaled_dot_product_attention(
                    qs, ks, vs, is_causal=True, enable_gqa=True) if causal
                    else F.scaled_dot_product_attention(
                        qs, ks, vs, attn_mask=mask, enable_gqa=True))
                return torch.autograd.grad(o, (qs, ks, vs), ds)

            yard = {"plain fwd": lambda: fr.flash_fwd_ref(*args, window, qc,
                                                          kc),
                    "plain bwd": lambda: fr.flash_bwd_ref(
                        *args, out, lse, dout, window, qc, kc),
                    "SDPA (mask) fwd+bwd": lambda: sdpa(False)}
            if not window:
                yard["SDPA (is_causal) fwd+bwd"] = lambda: sdpa(True)
            for name, fn in yard.items():
                times[name] = timer.ms(fn, 2 if name.startswith("plain")
                                       else 5, warmup=1)
            pairs = fo.visible_pairs(*args[3:], window)
            bounds = {}
            for name, bwd in (("fwd", False), ("bwd", True)):
                bounds[name] = cs.roofline_ms(*reversed(fo.flash_work(
                    B, S, S, Hkv, Hq // Hkv, hd, q.element_size(), pairs,
                    bwd)), dtype)
            split = kernel_split(torch, lambda: fo.flash_bwd_cuda(
                *args, out, lse, dout, window))
            result[f"{tag} {dtype}"] = dict(
                B=B, S=S, Hq=Hq, Hkv=Hkv, hd=hd, window=window, ms=times,
                turns=ms, max_abs_err=errs, bound_ms=bounds,
                bwd_kernels_ms=split)
            cs.log(f"{what}: " + ", ".join(f"{n} {v:.4f} ms" for n, v in
                                           times.items())
                   + "; fwd+bwd " + ", ".join(
                       f"{t} {times[f'{t} fwd'] + times[f'{t} bwd']:.4f} ms"
                       for t in libs)
                   + f"; dK/dV head groups {fo.dkdv_parts(B, S, Hkv, Hq // Hkv)}"
                   + f"; bound fwd {bounds['fwd'][0]:.4f} ms, bwd "
                   f"{bounds['bwd'][0]:.4f} ms ({bounds['bwd'][1]})  [{card}]")
            cs.log(f"{what}: the checkout's backward by kernel (device ms a "
                   "call, torch.profiler): " + (", ".join(
                       f"{n} {v:.4f}" for n, v in split.items())
                       if split else "not measured (no device events)")
                   + f"  [{card}]")
            del args, dout, out, lse, qs, ks, vs, ds, mask
            torch.cuda.empty_cache()
    return result


def grpo_step(root: Path) -> dict:
    """One process's 8c step at ``root``'s port: (median ms of
    ``GRPO_REPS`` warm steps, peak memory GiB, the loss)."""
    sys.path[:0] = [str(root / "src"), str(root)]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.optim import adamw
    from repro_torch.rl import grpo
    from repro_torch.rl.rollout import pack_train_arrays

    assert Path(cs.__file__).resolve().parent == root.resolve()
    cfg, params = cs.full_width_model(torch, "qwen2-1.5b")
    rng = np.random.default_rng(81)
    problems = [[int(t) for t in rng.integers(2, cfg.vocab_size, size=n)]
                for n in (2100, 2200)]
    prompts = [problems[i // 2] for i in range(4)]
    outs = [[int(t) for t in rng.integers(2, cfg.vocab_size, size=64)]
            for _ in range(4)]
    tokens, resp = pack_train_arrays(prompts, outs)
    adv = rng.normal(size=4).astype(np.float32)
    from repro_torch.models import model as M

    M.set_trainable(params)
    tok = torch.tensor(tokens, device="cuda")
    batch = {"tokens": tok, "resp_mask": torch.tensor(resp, device="cuda"),
             "advantages": torch.tensor(adv, device="cuda"),
             "old_logprobs": grpo.compute_old_logprobs(params, cfg, tok)}
    ocfg = adamw.AdamWConfig(lr=cs.STEP_LR)
    opt = adamw.init_state(params)
    gcfg = grpo.GRPOConfig()
    times, losses = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(GRPO_REPS + 1):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        loss, _ = grpo.grpo_loss(params, cfg, gcfg, batch)
        grads = grpo.param_grads(params, loss)
        params, opt, _ = adamw.apply_updates(ocfg, params, grads, opt)
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
        losses.append(float(loss.detach()))
        del grads, loss
    warm = sorted(times[1:])
    return dict(ms=warm[len(warm) // 2], cold_ms=times[0], turns=times,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                S=int(tokens.shape[1]), loss=losses[0])


def grpo_turns(roots, cs, card):
    res = {str(r): [] for r in roots}
    for r in list(roots) + list(roots)[::-1]:
        proc = subprocess.run(
            [sys.executable, __file__, "--grpo-one", str(r)],
            capture_output=True, text=True, cwd=str(r))
        if proc.returncode != 0:
            cs.fail(f"GRPO step at {r} failed:\n{proc.stdout[-4000:]}\n"
                    f"{proc.stderr[-4000:]}")
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        res[str(r)].append(got)
        cs.log(f"8c GRPO step at {r} (S {got['S']}): warm median "
               f"{got['ms']:.1f} ms (turns {', '.join(f'{t:.1f}' for t in got['turns'])}"
               f"; the first cold), peak {got['peak_gib']:.2f} GiB, loss "
               f"{got['loss']:.6f}  [{card}]")
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, nargs="*", default=[])
    ap.add_argument("--cases", default="")
    ap.add_argument("--dtypes", default="bfloat16")
    ap.add_argument("--one-group", action="store_true",
                    help="also the checkout's backward with one dK/dV head "
                    "group (no split)")
    ap.add_argument("--grpo", type=Path, nargs="*", default=[])
    ap.add_argument("--grpo-one", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path, default=ROOT / "build" /
                    "flash_ab.json")
    a = ap.parse_args()
    if a.grpo_one:
        print(json.dumps(grpo_step(a.grpo_one)))
        return
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: needs a CUDA card")
    # the plain version's float32 products in float32, as in chip_smoke.py
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    cs.log(f"card: {card} | torch {torch.__version__} cuda "
           f"{torch.version.cuda}")
    result = {"card": card}
    if a.cases != "none":
        result["kernels"] = kernel_cases(a, cs, torch, np, card)
    if a.grpo:
        result["grpo"] = grpo_turns([p.resolve() for p in a.grpo], cs, card)
    a.out.parent.mkdir(parents=True, exist_ok=True)
    a.out.write_text(json.dumps(result, indent=1))
    cs.log(json.dumps(result))


if __name__ == "__main__":
    main()
