#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the repository's sources next to this file; it
imports only ``repro_torch``, torch and numpy. Phases (any failure exits
non-zero; no phase's error is caught):

1. device: the card's name and power limit (nvidia-smi), torch's view;
2. build: the four CUDA sources from ``src/repro_torch/csrc`` with nvcc
   for sm_90a, in parallel, with the ptxas register/shared-memory report;
3. kernels against their plain PyTorch versions at main-path shapes
   (spec-verify attention within the bfloat16 tolerance at Qwen3-8B's
   head shape, at RecurrentGemma-9B's (head_dim 256, MQA, window 2048)
   and at Qwen2-1.5B's (12/2 heads of 128, G = 6, phase 8b's ring of
   2,305 slots filled past 2,100), each at its path's cache fill and
   with the full ring,
   with its split plan and ptxas report, one call under the sync-debug
   mode "error", and bf16 edge cases (T = 1, rows that see nothing, one
   live split, hd 64 and 32, softcap, G = 6); float32 at head_dim 64
   and 256; suffix-match flat and chunked (a warp a row, 33-way edge
   search from staged splitters) bit-identical, the chunked kernel also
   against the flat one over the same trees, at a forest larger than
   L2, and both at edge tables of 2^26 entries (their 64-bit search); 3d: the RG-LRU scan bit-identical (and within 1e-5) at
   RecurrentGemma-9B's verify shape (B 8, T 17, frozen rows masked), its
   prefill shape (B 8, T 256, left pads), the longest prompt (B 1, T
   2047), a ragged width and a width not a multiple of 4, after the
   timer's floor (an empty kernel); phase 7's most frequent admission
   shape follows phase 7), with kernel / plain /
   library times (CUDA events, L2 flushed before every launch, and a
   device-side wait before each start event so that the wrappers' host
   work stays out of the window) and each kernel's bound (for
   suffix-match, the forest entries a per-row walk of the row core
   reads, ``walk_needed_reads``);
4. lock-step path: Qwen3-8B at full width (random weights from a seed,
   bf16), DAS ``generate`` of 8 requests over 4 problems, two epochs over
   the same prompts; epoch 2 must be token-identical to epoch 1 and
   accept drafts; the flat suffix-match kernel must have launched, and
   spec-verify exactly once per attention layer per verify round; the
   spec-verify launches a spy keeps (each epoch's first and every 64th)
   must match its plain version within the bf16 tolerance after the run,
   and the suffix-match launches its spy keeps (each epoch's first and
   every 16th) must equal theirs bit for bit (the same holds in phases 5
   and 7); the suffix-match spy also keeps epoch 2's launches, of which
   the one that proposed most is the flat kernel's timing case at the
   path's own shape (after phase 5: bit-identical to the plain version,
   kernel / plain / bound); after phase 5 the same traffic again with
   ``MICRO_R`` = 4 fused rounds a dispatch (the micro-loop): per epoch
   the R = 1 run's tokens and verify rounds with strictly fewer result
   downloads, spec-verify once per attention layer per dispatched
   micro-round (the idle ones past the loop's exit included);
5. continuous path: the same model through ``SpecEngine.serve`` — 24
   requests over 12 problems in 8 slots, two epochs, with the chunked
   forest and then, on a fresh engine and drafter, the flat one; the two
   layouts must agree on every token, round and acceptance, and each run
   must have launched its own suffix-match kernel and not the other; each
   run's kept suffix-match launches must equal the plain version bit for
   bit, and the chunked run's epoch-2 launch that proposed most is the
   chunked kernel's timing case at the path's own shape; every token of
   both epochs and of lock-step ``generate`` on the same prompts must be
   plain greedy's choice on its own prefix within the bf16 tolerance;
6. the serving CLI as subprocesses (lock-step, ``--continuous``, and the
   hybrid model) and the training CLI (``--smoke``, Qwen2-1.5B and the
   hybrid), last of all;
7. RecurrentGemma-9B at full width (the Qwen3-8B weights freed first):
   phase 4's lock-step traffic and phase 5's continuous traffic (chunked
   forest only), gated as there, with one RG-LRU launch per recurrent
   layer per forward and plain greedy's forwards run on the plain scan,
   and the lock-step traffic again with R = 4 as in phase 4;
   then (phases 8 and 9, below) the RL loops; then the small float32 variants
   of Qwen3-8B and RecurrentGemma-9B: lock-step and continuous (chunked)
   output against plain greedy decoding without cache or kernels;
8. the RL loop on Qwen2-1.5B at its published config (28 layers,
   d_model 1536, 12/2 heads of 128, d_ff 8960, vocab 151,936, QKV bias,
   tied embeddings; random bf16 weights from seed 0):
   8a. ``_flash_attn_train`` (the memory-bounded flash attention with a
       hand-written backward) at B 4, S 2304, 12/2 heads, hd 128, float32
       and bf16, against autograd through plain dense attention
       (``FLASH_TOL``), timed beside dense attention and SDPA with the
       same boolean mask, with each one's peak memory;
   8b. long-prompt rollouts: 4 rows over 2 problems (prompts of 2,100
       and 2,200 seeded tokens), 64 new tokens, T = 0, lock-step, two
       epochs: every prefill through ``_flash`` once per layer,
       spec-verify once per attention layer per verify round (kept
       launches held to the plain version), epoch 2 equal to epoch 1
       and drafting, every token plain greedy's choice (0.25 logit);
   8c. one GRPO step at S >= 2048 on 8b's epoch-1 batch (seeded
       advantages, ``compute_old_logprobs``): the surrogate at ratio 1
       within ``SURROGATE_RTOL`` of -sum(adv*mask)/sum(mask), every
       gradient finite, every layer's wq/wk/wv gradient non-zero (the
       flash backward carries gradient), update_norm = lr * min(1,
       clip/gnorm) * gnorm, and a lower surrogate after the step; its
       time and peak memory;
   8d. after ``set_params``, a third epoch of 8b's traffic, every token
       plain greedy's under the updated weights;
   8e. ``Trainer.run``: the pattern task (8 problems), 4 prompts a step,
       G = 2, 32 new tokens, 4 SFT warmup steps (the CE must fall) and 4
       GRPO steps at T = 0.6, spec-verify once per attention layer per
       round in every rollout and the drafting kernel in every rollout
       from the second epoch on (the first has no history); a
       checkpoint after step 2 into a temporary directory, from which a
       fresh trainer resumes with cursor 2 and the drafter's rollouts,
       and its steps 3-4 equal the uninterrupted run's token for token
       (the sidecar carries the generator's state) with equal losses;
9. RecurrentGemma-9B training at its published widths, depth cut to 6
   layers (two (rglru, rglru, local_attn) triples, 2.23 B parameters:
   all 38 layers' weights, gradients and moments would take ~102 GB):
   9a. the RG-LRU scan's backward kernel against its plain version on
       the forward kernel's hs at the GRPO step's shape (B 4, T 2272, W
       4096), with left pads, a ragged width and a width not a multiple
       of 4: dx, dr, di and dh0 bit for bit, dΛ within
       ``RGLRU_DLAM_TOL``; timed beside its bound after the timer's
       floor, and the forward timed at the training shape;
   9b. 8b's long-prompt rollouts and 8c's GRPO step on the cut hybrid:
       every RG-LRU parameter's gradient non-zero in every recurrent
       layer, one forward and one backward scan launch per recurrent
       layer in the step, and with remat the same loss and gradients
       with twice the forward launches;
   9c. 8e's ``Trainer.run`` on the cut hybrid (T = 0.6, checkpoint,
       token-identical resume), one backward launch per recurrent layer
       per train step.

The last lines are the card line, the per-kernel JSON line and the
result line ``{"ok": true, "device": {...}}``. A kernel's ``launches``
there sum every path that runs it, each counted from 0 (flat drafting:
phases 4 and 7 (R = 1 and R = 4), phase 5's flat run and phases 8 and 9;
chunked drafting: phase 5's and phase 7's chunked runs; spec-verify at hd
128: phases 4 and 5; at hd 256 and the RG-LRU scan: phases 7 and 9; at
Qwen2-1.5B's shape, ``spec_verify_attention_qwen2``: phase 8; the scan's
backward: phase 9); the drafting
kernels' times and bounds there are at the path's own shapes (phases
3b and 3c are logged). The scan has an entry per shape class, split by
the wrapper's launches by (B, T): ``rglru_scan`` at the verify shape
with the verify rounds' launches (T = 17), ``rglru_scan_prefill`` at the
prefill shape with every other launch below T 2048, and
``rglru_scan_long`` at phase 9's training shape with the launches at T
>= 2048; the three sum to the gated total. Its
bound counts x, r and i only at the steps the mask updates (the kernel
loads nothing at a masked step); the log gives the bound reading every
step beside it.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published H100 SXM peaks (NVIDIA data sheet), the bound's denominators.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
SV_TOL = {"bfloat16": dict(atol=3e-2, rtol=1e-2),
          "float32": dict(atol=3e-5, rtol=1e-2)}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi reported no card")
    return out[0].strip()


class Timer:
    """Per-launch CUDA-event timing with the L2 flushed before each
    launch (the main path finds K/V and the forest cold: 36 layers of
    weights stream through L2 between two launches of a kernel).

    After the flush and before the start event, a device-side wait
    (``torch.cuda._sleep``, ``lead_us`` long, calibrated once) is
    enqueued, so that the host has enqueued the launch under test
    (the wrapper's checks, allocation and ctypes call) before the start
    event fires: the window holds device time, not host time."""

    def __init__(self, torch, lead_us: float = 300.0):
        self.torch = torch
        self.flush_buf = torch.empty(96 << 20, dtype=torch.uint8,
                                     device="cuda")
        cycles = 2_000_000
        torch.cuda._sleep(cycles // 10)  # warm-up
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        torch.cuda._sleep(cycles)
        e.record()
        torch.cuda.synchronize()
        self.cycles_per_us = cycles / (s.elapsed_time(e) * 1e3)
        self.lead_us = lead_us
        self.lead_cycles = int(lead_us * self.cycles_per_us)
        log(f"timer: torch.cuda._sleep runs {self.cycles_per_us:.1f} cycles "
            f"a microsecond; {self.lead_cycles} cycles ({lead_us:.0f} us) "
            "are enqueued after each L2 flush, before the start event")

    def ms(self, fn, reps: int, warmup: int = 2, lead: bool = True) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(reps):
            self.flush_buf.zero_()
            if lead:
                torch.cuda._sleep(self.lead_cycles)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / reps


# ---------------------------------------------------------------------------
# phase 3a: spec-verify attention
# ---------------------------------------------------------------------------

def sv_inputs(torch, np, B, T, Hq, Hkv, hd, S1, dtype, seed, min_len,
              max_len=None):
    """Ragged ring caches: row b holds positions [0, len_b + T) (the
    block's own K/V already written, as the model writes them before the
    read); the block's queries sit at len_b .. len_b + T - 1. len_b is
    drawn from [min_len, max_len), by default up to S - T (a full
    ring)."""
    rng = np.random.default_rng(seed)
    S = S1 - 1
    dt = getattr(torch, dtype)
    q = torch.from_numpy(rng.normal(size=(B, T, Hq, hd)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(B, S1, Hkv, hd)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(B, S1, Hkv, hd)).astype(np.float32))
    lengths = rng.integers(min_len, S - T if max_len is None else max_len,
                           size=B)
    cpos = np.full((B, S1), -1, np.int32)
    for b in range(B):
        for p in range(lengths[b] + T):
            cpos[b, p % S] = p
    positions = (lengths[:, None] + np.arange(T)[None]).astype(np.int32)
    return (q.to(dt).cuda(), k.to(dt).cuda(), v.to(dt).cuda(),
            torch.from_numpy(cpos).cuda(), torch.from_numpy(positions).cuda())


def sv_bound_ms(np, args, window, dtype):
    """Least time for the same work: each valid K/V slot, q, positions
    and cache_pos read once, the output written once; flops of QK and PV
    over the visible (row, slot) pairs only."""
    q, k, _, cpos, pos = args
    B, T, Hq, hd = q.shape
    Hkv = k.shape[2]
    esz = q.element_size()
    cp = cpos.cpu().numpy()
    qp = pos.cpu().numpy()
    valid_slots = int((cp >= 0).sum())
    nbytes = (2 * q.numel() * esz + cp.size * 4 + qp.size * 4
              + 2 * valid_slots * Hkv * hd * esz)
    vis = (cp[:, None, :] >= 0) & (cp[:, None, :] <= qp[:, :, None])
    if window > 0:
        vis &= cp[:, None, :] > qp[:, :, None] - window
    flops = 4.0 * int(vis.sum()) * Hq * hd
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sv_plan_line(torch, B, T, Hq, Hkv, hd, S1):
    """The bf16 kernel's split plan for a shape, and the ptxas report of
    the instantiation it launches (registers, shared memory, spills)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.spec_verify import ops as sv_ops

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    plan = sv_ops.split_plan(B, T, Hq, Hkv, S1, hd, n_sm)
    TG = T * (Hq // Hkv)
    part_mb = plan.partial_floats(B, Hkv, TG, hd) * 4 / 1e6
    kv_mb = 2 * B * S1 * Hkv * hd * 2 / 1e6
    inst = f"spec_verify_tc_kernelILi{max(hd, 64)}ELi{plan.tile}E"
    lines = _build.ptxas_lines("spec_verify")
    at = next((i for i, ln in enumerate(lines) if inst in ln), None)
    rep = ("; ".join(ln.split("ptxas info    : ")[-1] for ln in
                     lines[at + 1:at + 3]) if at is not None
           else "not in this process's build log")
    return (f"plan: {plan.n_split} split(s) of {plan.tiles_per_split} tiles "
            f"x {plan.tile} slots, {plan.row_blocks} row block(s) of <= "
            f"{plan.cta_rows} rows: {B * Hkv * plan.row_blocks * plan.n_split}"
            f" CTAs on {n_sm} SMs; partials {part_mb:.2f} MB against K/V "
            f"{kv_mb:.2f} MB; ptxas ({inst}): {rep}")


# bf16 edge cases held against the plain version: (label, B, T, Hq, Hkv,
# hd, S+1, window, softcap, cache lengths [lo, hi), seed)
SV_EDGE_CASES = [
    ("T=1", 8, 1, 32, 8, 128, 577, 0, 0.0, (128, 560), 31),
    ("rows that see nothing", 4, 5, 8, 2, 128, 300, 0, 0.0, (20, 290), 32),
    ("every split but one empty", 8, 17, 16, 1, 256, 2113, 2048, 0.0,
     (1, 16), 33),
    ("hd 64", 2, 9, 8, 2, 64, 257, 0, 0.0, (1, 240), 34),
    ("hd 32", 1, 2, 16, 1, 32, 70, 0, 0.0, (1, 60), 35),
    ("softcap 30", 2, 17, 8, 4, 128, 513, 0, 30.0, (1, 490), 36),
    ("G=6, window 100", 2, 4, 12, 2, 64, 300, 100, 0.0, (1, 290), 37),
]


def phase_sv_edge_cases(torch, np, card):
    from repro_torch.kernels.spec_verify import ops as sv_ops
    from repro_torch.kernels.spec_verify.ref import spec_verify_attention_ref

    worst = 0.0
    for (label, B, T, Hq, Hkv, hd, S1, window, softcap, (lo, hi),
         seed) in SV_EDGE_CASES:
        args = sv_inputs(torch, np, B, T, Hq, Hkv, hd, S1, "bfloat16", seed,
                         lo, hi)
        blind = []  # (b, t) query rows that see no slot
        if label == "rows that see nothing":
            args[4][1, 0] = -1  # one query of row 1
            args[4][2, :] = -1  # every query of row 2: all splits empty
            blind = [(1, 0)] + [(2, t) for t in range(T)]
        got = sv_ops.spec_verify_attention_cuda(*args, window=window,
                                                softcap=softcap)
        want = spec_verify_attention_ref(*args, window=window,
                                         softcap=softcap)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()),
              f"spec_verify bf16 {label}: non-finite output")
        err = float((got.float() - want.float()).abs().max())
        check(torch.allclose(got.float(), want.float(), **SV_TOL["bfloat16"]),
              f"spec_verify bf16 {label}: max |err| {err}")
        for b, t in blind:
            check(bool((got[b, t] == 0).all()),
                  f"spec_verify bf16 {label}: a row that sees nothing is "
                  "not 0")
        worst = max(worst, err)
        log(f"spec_verify bf16 edge case {label} (B={B} T={T} Hq={Hq} "
            f"Hkv={Hkv} hd={hd} S+1={S1} window={window} softcap={softcap}, "
            f"lengths [{lo}, {hi})): max |err| {err:.3e}  ok; "
            f"{sv_plan_line(torch, B, T, Hq, Hkv, hd, S1)}  [{card}]")
    return worst


def phase_spec_verify(torch, np, timer, card):
    from repro_torch.kernels.spec_verify import ops as sv_ops
    from repro_torch.kernels.spec_verify.ref import spec_verify_attention_ref

    # small float32 case with a window and a softcap
    small = sv_inputs(torch, np, 2, 5, 8, 2, 64, 130, "float32", 1, 20)
    got = sv_ops.spec_verify_attention_cuda(*small, window=48, softcap=30.0)
    want = spec_verify_attention_ref(*small, window=48, softcap=30.0)
    torch.cuda.synchronize()
    err_small = float((got - want).abs().max())
    check(torch.allclose(got, want, **SV_TOL["float32"]),
          f"spec_verify f32 window/softcap: max |err| {err_small}")
    log(f"spec_verify f32 (B=2 T=5 Hq=8 Hkv=2 hd=64 S+1=130 window=48 "
        f"softcap=30): max |err| {err_small:.3e}  ok")
    # float32 at hd 256 (MQA 16/1, a window): each thread owns two columns
    small = sv_inputs(torch, np, 2, 5, 16, 1, 256, 300, "float32", 2, 100)
    got = sv_ops.spec_verify_attention_cuda(*small, window=160)
    want = spec_verify_attention_ref(*small, window=160)
    torch.cuda.synchronize()
    err_small = float((got - want).abs().max())
    check(torch.allclose(got, want, **SV_TOL["float32"]),
          f"spec_verify f32 hd=256: max |err| {err_small}")
    log(f"spec_verify f32 (B=2 T=5 Hq=16 Hkv=1 hd=256 S+1=300 window=160): "
        f"max |err| {err_small:.3e}  ok")
    edge_err = phase_sv_edge_cases(torch, np, card)

    # main-path shapes, bf16: Qwen3-8B's (hd 128, GQA 32/8) and
    # RecurrentGemma-9B's local attention (hd 256, MQA 16/1, window 2048),
    # each at the ring and fill phases 4, 5 and 7 give it (S+1 = 577: the
    # paths' max_len of 576 is below window + headroom) and with a full
    # ring (for RecurrentGemma the window's own: S+1 = 2113)
    # and Qwen2-1.5B's (hd 128, GQA 12/2: G = 6, 102 query rows a kv head)
    # at phase 8b's batch, ring and fill (prompts of 2,100 and 2,200
    # tokens, 64 generated: S+1 = 2305)
    entries = []
    for name, (B, Hq, Hkv, hd, S1_path, S1_full, window, min_len,
               fill) in (
            ("spec_verify_attention",
             (8, 32, 8, 128, 577, 577, 0, 128, SV_PATH_FILL)),
            ("spec_verify_attention_hd256",
             (8, 16, 1, 256, 577, 2113, 2048, 1024, SV_PATH_FILL)),
            ("spec_verify_attention_qwen2",
             (4, 12, 2, 128, 2305, 2305, 0, 2100, SV_LONG_FILL))):
        e = sv_main_shape(torch, np, timer, card, B, 17, Hq, Hkv, hd,
                          S1_path, S1_full, window, min_len, fill)
        e["max_abs_err"] = max(e["max_abs_err"], edge_err)
        entries.append(dict(name=name, **e))
    return entries


# The path's fill: prompts of 128-256 tokens and up to 256 generated
# (phases 4, 5 and 7), so a block's first position lies in [128, 512].
SV_PATH_FILL = (128, 513)
# Phase 8b's fill: prompts of 2,100 and 2,200 tokens and up to 64
# generated, so a block's first position lies in [2100, 2264].
SV_LONG_FILL = (2100, 2265)


def sv_main_shape(torch, np, timer, card, B, T, Hq, Hkv, hd, S1_path,
                  S1_full, window, min_len, path_fill=SV_PATH_FILL):
    """One bf16 main-path shape at the path's ring (S+1 = ``S1_path``) and
    fill (``path_fill``) and with a full ring of ``S1_full`` slots
    (lengths from ``min_len``): the kernel against the plain version,
    then kernel, plain, SDPA and bound times (the full ring's kernel
    time also without the timer's lead, once). The path fill's numbers
    are returned; the full ring's are logged."""
    import torch.nn.functional as F

    from repro_torch.kernels.spec_verify import ops as sv_ops
    from repro_torch.kernels.spec_verify.ref import spec_verify_attention_ref

    res = {}
    for fill, S1, (lo, hi), seed in (
            ("path fill", S1_path, path_fill, 20),
            ("full ring", S1_full, (min_len, None), 10)):
        log(f"spec_verify bf16 hd={hd} S+1={S1} "
            f"{sv_plan_line(torch, B, T, Hq, Hkv, hd, S1)}  [{card}]")
        copies = [sv_inputs(torch, np, B, T, Hq, Hkv, hd, S1, "bfloat16",
                            seed + i, lo, hi) for i in range(4)]
        args = copies[0]
        got = sv_ops.spec_verify_attention_cuda(*args, window=window)
        want = spec_verify_attention_ref(*args, window=window)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()),
              "spec_verify bf16: non-finite output")
        err = float((got.float() - want.float()).abs().max())
        check(torch.allclose(got.float(), want.float(), **SV_TOL["bfloat16"]),
              f"spec_verify bf16 hd={hd} {fill}: max |err| {err}")
        cp = args[3].cpu().numpy()
        log(f"spec_verify bf16 (B={B} T={T} Hq={Hq} Hkv={Hkv} hd={hd} "
            f"S+1={S1} window={window}, {fill}: lengths [{lo}, "
            f"{S1 - 1 - T if hi is None else hi}), {int((cp >= 0).sum())} of "
            f"{cp.size} slots filled): max |err| {err:.3e}  ok")
        if fill == "path fill":  # the wrapper never waits on the device
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                sv_ops.spec_verify_attention_cuda(*copies[1], window=window)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            log(f"spec_verify bf16 hd={hd}: one call under "
                "torch.cuda.set_sync_debug_mode('error') raised nothing")

        # timing: cycle 4 input sets so nothing stays warm
        it = {"i": 0}

        def nxt():
            it["i"] += 1
            return copies[it["i"] % len(copies)]

        def kern():
            return sv_ops.spec_verify_attention_cuda(*nxt(), window=window)

        ms = timer.ms(kern, 50)
        plain_ms = timer.ms(lambda: spec_verify_attention_ref(
            *nxt(), window=window), 10)
        # library yardstick: one SDPA call with the same boolean mask
        # (never called by the port)
        lib_in = []
        for q, k, v, cpos, pos in copies:
            cpm, qp = cpos[:, None, :], pos[:, :, None]
            mask = (cpm >= 0) & (cpm <= qp)
            if window > 0:
                mask &= cpm > qp - window
            lib_in.append((q.transpose(1, 2).contiguous(),
                           k.transpose(1, 2).contiguous(),
                           v.transpose(1, 2).contiguous(), mask[:, None]))
        try:
            F.scaled_dot_product_attention(*lib_in[0][:3],
                                           attn_mask=lib_in[0][3],
                                           enable_gqa=True)
            sdpa_kw = {"enable_gqa": True}
        except TypeError:  # older torch: expand the kv heads outside timing
            sdpa_kw = {}
            G = Hq // Hkv
            lib_in = [(q, k.repeat_interleave(G, 1),
                       v.repeat_interleave(G, 1), m)
                      for q, k, v, m in lib_in]
        li = {"i": 0}

        def lib_call():
            li["i"] += 1
            q, k, v, m = lib_in[li["i"] % len(lib_in)]
            return F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                                  **sdpa_kw)

        library_ms = timer.ms(lib_call, 50)
        bound_ms, bound_by = sv_bound_ms(np, args, window, "bfloat16")
        extra = ""
        if fill == "full ring":  # the timer's lead, on and off, once
            extra = (f"; without the timer's lead: kernel "
                     f"{timer.ms(kern, 50, lead=False) * 1e3:.1f} us, SDPA "
                     f"{timer.ms(lib_call, 50, lead=False) * 1e3:.1f} us")
        log(f"spec_verify bf16 hd={hd} {fill} timing: kernel {ms * 1e3:.1f} "
            f"us, plain {plain_ms * 1e3:.1f} us, SDPA {library_ms * 1e3:.1f} "
            f"us, bound {bound_ms * 1e3:.2f} us ({bound_by}){extra}  [{card}]")
        res[fill] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=library_ms)
    out = dict(route="cuda", source="src/repro_torch/csrc/spec_verify.cu",
               replaces="src/repro/kernels/spec_verify/kernel.py:103",
               **res["path fill"])
    out["max_abs_err"] = max(r["max_abs_err"] for r in res.values())
    return out


# ---------------------------------------------------------------------------
# phase 3b: suffix-match drafting
# ---------------------------------------------------------------------------

def synthetic_rollouts(np, seed, n_problems=4, per_problem=8, doc_len=None):
    """Seeded rollouts that repeat themselves the way RL rollouts of one
    problem do: each problem has a few motifs; a rollout stitches motifs
    with random edits. Rollouts run to at least 300 tokens, or, with
    ``doc_len=(lo, hi)``, to a length drawn from [lo, hi]."""
    rng = np.random.default_rng(seed)
    out = {}
    for p in range(n_problems):
        motifs = [list(rng.integers(2, 5000, size=rng.integers(8, 40)))
                  for _ in range(6)]
        docs = []
        for _ in range(per_problem):
            target = (300 if doc_len is None
                      else int(rng.integers(doc_len[0], doc_len[1] + 1)))
            doc = []
            while len(doc) < target:
                m = list(motifs[rng.integers(0, len(motifs))])
                if rng.random() < 0.3:
                    m[rng.integers(0, len(m))] = int(rng.integers(2, 5000))
                doc += m
            if doc_len is not None:
                doc = doc[:target]
            docs.append([int(t) for t in doc])
        out[f"p{p}"] = docs
    return out


_EN, _ET, _EC, _SL, _ES, _EL, _FT, _BC, _CO = range(9)  # forest arrays
_FEED, _DESC = 0, 1


def walk_needed_reads(np, tails, roots, budgets, forest, *, chunked,
                      n_prop_max, min_match):
    """Every row's match and proposal computed on the host as the kernels'
    row core (``match_propose_row`` in ``csrc/suffix_match.cu``) computes
    them, reading a forest entry only where the row's result depends on
    its value: nothing for an inactive row or a row whose loop has ended,
    only the branch a micro-step takes (no child search while on an edge
    or at the end of a descent, no suffix link unless the step hops), and
    no search step after the search has converged. Returns the outputs
    (match_len, n_prop, props as numpy, to be held against the kernel's),
    the distinct forest entries read and the query entries read."""
    arrs = [a.cpu().numpy() for a in forest]
    if not chunked:  # the flat layout is the one-tree case
        arrs = [a[None] for a in arrs]
    tails, roots, budgets = (a.cpu().numpy() for a in (tails, roots, budgets))
    B, m = tails.shape
    T, E = arrs[_EN].shape
    C = arrs[_CO].shape[1]
    n_steps = max(int(E - 1).bit_length(), 1) + 1
    seen = set()
    n_query = B  # every row's root
    match_len = np.zeros(B, np.int32)
    n_prop = np.zeros(B, np.int32)
    props = np.full((B, n_prop_max), -1, np.int32)
    for b in range(B):
        r = int(roots[b])
        tree, root = (min(max(r, 0), T - 1), 0 if r >= 0 else -1) \
            if chunked else (0, r)
        if root < 0:
            continue
        n_query += m + 1  # the row's tail and budget
        budget = min(int(budgets[b]), n_prop_max)

        def rd(a, i, tree=tree):
            seen.add((a, tree, i))
            return int(arrs[a][tree, i])

        def find_child(node, tok):
            lo, hi = 0, E
            for _ in range(n_steps):
                if lo >= hi:  # converged: later steps change nothing
                    break
                mid = (lo + hi) // 2
                mc = min(mid, E - 1)
                en = rd(_EN, mc)
                if en < node or (en == node and rd(_ET, mc) < tok):
                    lo = mid + 1
                else:
                    hi = mid
            if lo >= E or rd(_EN, lo) != node or rd(_ET, lo) != tok:
                return -1
            return rd(_EC, lo)

        def descend(dnode, dpos, drem):
            """One descent micro-step: (node, child, epos, mode, dnode,
            dpos, drem) after it, ``node`` None where it stays."""
            if drem == 0:
                return dnode, -1, 0, _FEED, dnode, dpos, drem
            c_s = max(find_child(dnode, rd(_CO, min(dpos, C - 1))), 0)
            ell = rd(_EL, c_s)
            if drem >= ell:
                return None, -1, 0, _DESC, c_s, dpos + ell, drem - ell
            return dnode, c_s, drem, _FEED, dnode, dpos, drem

        # streaming longest-suffix match
        i, node, child, epos, mlen = 0, root, -1, 0, 0
        mode, dnode, dpos, drem = _FEED, root, 0, 0
        while i < m or mode == _DESC:
            if mode == _DESC:
                n2, child, epos, mode, dnode, dpos, drem = descend(
                    dnode, dpos, drem)
                node = node if n2 is None else n2
                continue
            t = int(tails[b, i])
            if t < 0:
                node, child, epos, mlen, i = root, -1, 0, 0, i + 1
                continue
            on_edge = child >= 0
            if on_edge:
                es_ch = rd(_ES, child)
                ok = rd(_CO, min(es_ch + epos, C - 1)) == t
                new_child, new_epos = child, epos + 1
            else:
                new_child = find_child(node, t)
                ok, new_epos = new_child >= 0, 1
            if ok:
                if new_epos == rd(_EL, new_child):
                    node, child, epos = new_child, -1, 0
                else:
                    child, epos = new_child, new_epos
                mlen, i = mlen + 1, i + 1
            elif mlen == 0:
                i += 1
            else:  # suffix-link hop, then retry the same token
                shift = int(on_edge and node == root)
                dnode = rd(_SL, node)
                dpos = es_ch + shift if on_edge else 0
                drem = epos - shift if on_edge else 0
                mlen, mode = mlen - 1, _DESC

        # greedy continuation walk with shorter-suffix fallback
        minm = max(int(min_match), 1)
        wn, wc, we, k, pmlen = node, child, epos, 0, mlen
        mode, dnode, dpos, drem = _FEED, root, 0, 0
        done = budget <= 0 or mlen < minm
        while not done:
            if mode == _DESC:
                n2, wc, we, mode, dnode, dpos, drem = descend(dnode, dpos, drem)
                wn = wn if n2 is None else n2
                continue
            if k >= budget:
                break
            on_edge = wc >= 0
            if on_edge:
                if we == rd(_EL, wc):  # end of the edge: step onto its node
                    wn, wc, we = wc, -1, 0
                    continue
                es_wc = rd(_ES, wc)
                tok = rd(_CO, min(es_wc + we, C - 1))
                brk = tok < 0
            else:
                bcx = rd(_BC, wn)
                brk = bcx < 0
                tok = -1 if brk else rd(_FT, bcx)
            if not brk:
                props[b, min(k, n_prop_max - 1)] = tok
                k += 1
                wc, we = (wc, we + 1) if on_edge else (bcx, 1)
            elif k > 0 or pmlen - 1 < minm:  # done, or give up
                done = True
            else:
                shift = int(on_edge and wn == root)
                dnode = rd(_SL, wn)
                dpos = es_wc + shift if on_edge else 0
                drem = we - shift if on_edge else 0
                pmlen, mode = pmlen - 1, _DESC
        match_len[b], n_prop[b] = mlen, k
    return (match_len, n_prop, props), len(seen), n_query


def suffix_match_bound_ms(np, got, tails, roots, budgets, forest, *, chunked,
                          n_prop_max, min_match):
    """Least time for the same work: the distinct forest entries the rows'
    results depend on (``walk_needed_reads``), the query entries they
    need and the outputs, each int32 moved once at the HBM rate. The
    walk's outputs must equal the kernel's (``got``), so the count is of
    the kernel's own work. Returns (ms, forest entries read)."""
    outs, entries, n_query = walk_needed_reads(
        np, tails, roots, budgets, forest, chunked=chunked,
        n_prop_max=n_prop_max, min_match=min_match)
    for name, w, g in zip(("match_len", "n_prop", "props"), outs, got):
        check(np.array_equal(w, g.cpu().numpy()),
              f"the read walk's {name} differs from the kernel's")
    B = tails.shape[0]
    nbytes = 4 * (entries + n_query + 2 * B + B * n_prop_max)
    return nbytes / HBM_BYTES_PER_S * 1e3, entries


def flat_case(torch, np, dev, layout="flat", **pack_kw):
    """Phase 3b's forest and query: four problems of 8 seeded rollouts,
    packed flat (or chunked; ``pack_kw`` to the packer); 8 rows of
    64-token tails cut from the rollouts, one inactive row, budgets from
    0 to 16."""
    from repro_torch.core.drafter import DrafterConfig, SuffixDrafter
    from repro_torch.kernels.suffix_match import ops as sm_ops

    rollouts = synthetic_rollouts(np, 5)
    d = SuffixDrafter(DrafterConfig(scope="problem"))
    for ep, (pid, docs) in enumerate(rollouts.items()):
        for doc in docs:
            d.observe_rollout(pid, doc, epoch=ep)
    keys = list(rollouts)
    pack = sm_ops.pack_forest if layout == "flat" else \
        sm_ops.pack_forest_chunked
    forest, roots = pack([d.pack_for(k) for k in keys], device=dev,
                         **pack_kw)
    B, m = 8, 64
    rng = np.random.default_rng(6)
    tails = np.full((B, m), -1, np.int32)
    rts = np.zeros(B, np.int32)
    for b in range(B):
        p = b % len(keys)
        doc = rollouts[keys[p]][int(rng.integers(0, 8))]
        cut = int(rng.integers(m // 2, len(doc)))
        tail = doc[max(0, cut - m):cut]
        tails[b, m - len(tail):] = tail
        rts[b] = roots[p]
    rts[5] = -1  # an inactive row
    budgets = np.array([16, 16, 8, 4, 16, 16, 0, 12], np.int32)
    return forest, [torch.from_numpy(a).to(dev) for a in (tails, rts, budgets)]


# csrc/suffix_match.cu's WIDE_EDGES: edge tables from this size on take
# the kernels' search with 64-bit index products
WIDE_EDGES = 1 << 26


def wide_tables(torch, np, timer, card, K):
    """Phase 3b's trees in edge tables of WIDE_EDGES entries (sentinel
    pads), flat and chunked: both kernels' 64-bit search, bit-identical
    to the plain versions, timed once each."""
    from repro_torch.kernels.suffix_match import ops as sm_ops
    from repro_torch.kernels.suffix_match.ref import (
        suffix_match_propose_chunked_ref,
        suffix_match_propose_ref,
    )

    for layout, kw, run, ref in (
            ("flat", dict(min_edges=WIDE_EDGES),
             sm_ops.suffix_match_propose_cuda, suffix_match_propose_ref),
            ("chunked", dict(min_stride_edges=WIDE_EDGES),
             sm_ops.suffix_match_propose_chunked_cuda,
             suffix_match_propose_chunked_ref)):
        forest, args = flat_case(torch, np, "cuda", layout, **kw)
        check(forest.edge_node.shape[-1] >= WIDE_EDGES,
              f"the {layout} table holds {forest.edge_node.shape[-1]} edges")
        got = run(forest, *args, n_prop_max=K, min_match=1)
        want = ref(*args, *forest, n_prop_max=K, min_match=1)
        torch.cuda.synchronize()
        for name, g, w in zip(("match_len", "n_prop", "props"), got, want):
            check(torch.equal(g, w), f"suffix_match ({layout}, "
                  f"{tuple(forest.edge_node.shape)} edges) {name} differs "
                  "from plain")
        ms = timer.ms(lambda: run(forest, *args, n_prop_max=K, min_match=1),
                      10)
        log(f"suffix_match {layout}, edge table {tuple(forest.edge_node.shape)}"
            f" (64-bit search): bit-identical, {int(got[1].sum())} tokens "
            f"proposed, kernel {ms * 1e3:.1f} us  [{card}]")
        del forest, args, got, want
        torch.cuda.empty_cache()


def phase_suffix_match(torch, np, timer, card):
    from repro_torch.kernels.suffix_match import ops as sm_ops
    from repro_torch.kernels.suffix_match.ref import suffix_match_propose_ref

    K = 16
    forest, args = flat_case(torch, np, "cuda")
    B, m = args[0].shape
    got = sm_ops.suffix_match_propose_cuda(forest, *args, n_prop_max=K,
                                           min_match=1)
    want = suffix_match_propose_ref(*args, *forest, n_prop_max=K, min_match=1)
    torch.cuda.synchronize()
    for name, g, w in zip(("match_len", "n_prop", "props"), got, want):
        check(torch.equal(g, w), f"suffix_match {name} differs from plain")
    n_prop = got[1].cpu().numpy()
    check(int(n_prop.sum()) > 0, "suffix_match proposed nothing")
    log(f"suffix_match (B={B} m={m} K={K}, E={forest.edge_node.shape[0]} "
        f"N={forest.suffix_link.shape[0]} C={forest.corpus.shape[0]}): "
        f"bit-identical, n_prop={n_prop.tolist()}")
    ms = timer.ms(lambda: sm_ops.suffix_match_propose_cuda(
        forest, *args, n_prop_max=K, min_match=1), 50)
    plain_ms = timer.ms(lambda: suffix_match_propose_ref(
        *args, *forest, n_prop_max=K, min_match=1), 5, warmup=1)
    bound_ms, entries = suffix_match_bound_ms(
        np, got, *args, forest, chunked=False, n_prop_max=K, min_match=1)
    log(f"suffix_match timing: kernel {ms * 1e3:.1f} us, plain "
        f"{plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.4f} us (bytes: "
        f"{entries} forest entries read + query + outputs)  [{card}]")
    wide_tables(torch, np, timer, card, K)
    return dict(name="suffix_match_propose", route="cuda",
                source="src/repro_torch/csrc/suffix_match.cu",
                replaces="src/repro/kernels/suffix_match/kernel.py:331",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=None)


# ---------------------------------------------------------------------------
# phase 3c: chunked suffix-match drafting at a forest larger than L2
# ---------------------------------------------------------------------------

def chunked_case(torch, np, dev, n_problems=64, B=64, m=64, K=16,
                 doc_len=(1024, 2048)):
    """The phase's forest and query: ``n_problems`` problems of 8 seeded
    rollouts each, packed chunked and flat; B rows, one tree each, most
    tails cut from a rollout of the row's problem, some unseen, with
    inactive rows and zero budgets among them."""
    from repro_torch.core.drafter import DrafterConfig, SuffixDrafter
    from repro_torch.kernels.suffix_match import ops as sm_ops

    rollouts = synthetic_rollouts(np, 21, n_problems=n_problems,
                                  per_problem=8, doc_len=doc_len)
    d = SuffixDrafter(DrafterConfig(scope="problem"))
    for pid, docs in rollouts.items():
        for doc in docs:
            d.observe_rollout(pid, doc, epoch=0)
    keys = list(rollouts)
    packs = [d.pack_for(k) for k in keys]
    cf, troots = sm_ops.pack_forest_chunked(packs, device=dev)
    ff, froots = sm_ops.pack_forest(packs, device=dev)
    rng = np.random.default_rng(22)
    tails = np.full((B, m), -1, np.int32)
    roots = np.zeros(B, np.int32)
    for b in range(B):
        p = (b * 37) % len(keys)
        roots[b] = troots[p]
        if b % 8 == 7:  # a context the tree has not seen
            tail = rng.integers(2, 5000, size=m)
        else:
            doc = rollouts[keys[p]][int(rng.integers(0, 8))]
            cut = int(rng.integers(m, len(doc)))
            tail = doc[cut - m:cut]
        tails[b, m - len(tail):] = tail
    roots[4::9] = -1  # inactive rows
    budgets = np.full(B, K, np.int32)
    budgets[3::10] = 0
    budgets[6::10] = rng.integers(1, K, size=len(budgets[6::10]))
    flat_roots = np.where(roots >= 0, froots[np.maximum(roots, 0)], -1)
    up = lambda a: torch.tensor(np.asarray(a, np.int32), device=dev)  # noqa: E731
    n_tok = sum(len(doc) for docs in rollouts.values() for doc in docs)
    return (cf, ff, (up(tails), up(roots), up(budgets)), up(flat_roots),
            n_tok)


def phase_suffix_match_chunked(torch, np, timer, card):
    from repro_torch.kernels.suffix_match import ops as sm_ops
    from repro_torch.kernels.suffix_match.ref import (
        suffix_match_propose_chunked_ref,
    )

    K = 16
    t0 = time.perf_counter()
    cf, ff, args, flat_roots, n_tok = chunked_case(torch, np, "cuda", K=K)
    fargs = (args[0], flat_roots, args[2])
    B, m = args[0].shape
    T, Es = cf.edge_node.shape
    mb = sum(t.numel() for t in cf) * 4 / 1e6
    log(f"suffix_match chunked forest: {T} trees, {n_tok} tokens, strides "
        f"Es={Es} Ns={cf.suffix_link.shape[1]} Cs={cf.corpus.shape[1]}, "
        f"{mb:.1f} MB (flat: {sum(t.numel() for t in ff) * 4 / 1e6:.1f} MB), "
        f"built in {time.perf_counter() - t0:.1f} s on the host")
    kw = dict(n_prop_max=K, min_match=1)
    got = sm_ops.suffix_match_propose_chunked_cuda(cf, *args, **kw)
    want = suffix_match_propose_chunked_ref(*args, *cf, **kw)
    flat = sm_ops.suffix_match_propose_cuda(ff, *fargs, **kw)
    torch.cuda.synchronize()
    for name, g, w, f in zip(("match_len", "n_prop", "props"), got, want,
                             flat):
        check(torch.equal(g, w), f"suffix_match chunked {name} differs "
              "from its plain version")
        check(torch.equal(g, f), f"suffix_match chunked {name} differs "
              "from the flat kernel over the same trees")
    n_prop = got[1].cpu().numpy()
    check(int(n_prop.sum()) > 0, "suffix_match chunked proposed nothing")
    log(f"suffix_match chunked (B={B} m={m} K={K}): bit-identical to the "
        f"plain version and the flat kernel; {int((n_prop > 0).sum())} rows "
        f"proposed {int(n_prop.sum())} tokens")
    ms = timer.ms(lambda: sm_ops.suffix_match_propose_chunked_cuda(
        cf, *args, **kw), 50)
    flat_ms = timer.ms(lambda: sm_ops.suffix_match_propose_cuda(
        ff, *fargs, **kw), 50)
    plain_ms = timer.ms(lambda: suffix_match_propose_chunked_ref(
        *args, *cf, **kw), 5, warmup=1)
    bound_ms, entries = suffix_match_bound_ms(np, got, *args, cf,
                                              chunked=True, **kw)
    flat_bound_ms, flat_entries = suffix_match_bound_ms(
        np, flat, *fargs, ff, chunked=False, **kw)
    log(f"suffix_match chunked timing: kernel {ms * 1e3:.1f} us, flat kernel "
        f"{flat_ms * 1e3:.1f} us (same trees, same call), plain "
        f"{plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.4f} us (bytes: "
        f"{entries} forest entries read + query + outputs; flat walk "
        f"{flat_entries} entries, {flat_bound_ms * 1e3:.4f} us)  [{card}]")
    return dict(name="suffix_match_propose_chunked", route="cuda",
                source="src/repro_torch/csrc/suffix_match.cu",
                replaces="src/repro/kernels/suffix_match/kernel.py:415",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=None)


# ---------------------------------------------------------------------------
# phase 3d: the RG-LRU scan
# ---------------------------------------------------------------------------

RGLRU_TOL = dict(atol=1e-5, rtol=1e-5)  # tests/test_kernels.py's


def rglru_inputs(torch, np, B, T, W, seed):
    """x ~ N(0, 1), gates r, i ~ U(0, 1), Λ ~ N(0, 1), h0 ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    arrs = (rng.normal(size=(B, T, W)), rng.uniform(size=(B, T, W)),
            rng.uniform(size=(B, T, W)), rng.normal(size=(W,)),
            rng.normal(size=(B, W)))
    return [torch.tensor(a, dtype=torch.float32, device="cuda")
            for a in arrs]


# float32 operations a (b, t, w) step of the scan does: log_a (2 products),
# a and exp(2 log_a) (2 exp, 1 product), 1 - e, clip (2), sqrt, i·x,
# mult·gx, a·h, + gx
RGLRU_OPS_PER_STEP = 13
# The verify block's T on the main path: its one K bucket (16) + the head.
VERIFY_T = 17


def rglru_bytes(B, T, W, mask, skip_masked=True):
    """Bytes the scan's result depends on, and the steps it updates: x, r
    and i at the updated steps (at every step with ``skip_masked`` False,
    the count before the kernel skipped masked steps), hs written once,
    h0, Λ, h_final and the (B, T) mask once."""
    kept = B * T if mask is None or not skip_masked else int(mask.sum())
    nbytes = 4 * (3 * kept * W + B * T * W + 2 * B * W + W)
    if mask is not None:
        nbytes += mask.numel()
    return nbytes, kept


def rglru_bound_ms(x, mask, skip_masked=True):
    """Least time for the same work, the larger of: ``rglru_bytes`` at the
    HBM rate; the scan's float32 operations at the updated steps at the
    card's float32 rate. Returns (ms, which bounds it)."""
    B, T, W = x.shape
    nbytes, kept = rglru_bytes(B, T, W, mask, skip_masked)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = RGLRU_OPS_PER_STEP * kept * W / PEAK_FLOPS["float32"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def rglru_launch_split(by_shape, verify_t=VERIFY_T):
    """(verify launches, prefill launches) of a count by (B, T): T equal
    to the verify block's is a verify round, any other a prefill (a
    lock-step prompt batch or an admission)."""
    verify = sum(n for (_, t), n in by_shape.items() if t == verify_t)
    return verify, sum(by_shape.values()) - verify


def rglru_mask(torch, np, kind, B, T, dev="cuda"):
    """The (B, T) update mask of a phase 3d case (None for ``None``)."""
    if kind == "left pads":  # prompts of 64..T tokens, right-aligned
        lens = np.linspace(min(64, T), T, B).astype(int)
    elif kind == "bucket pads":  # an admission: T is the 16-multiple bucket
        lens = np.linspace(max(T - 15, 1), T, B).astype(int)
    elif kind == "rows masked out":  # frozen rows of a verify block
        m = np.ones((B, T), bool)
        m[1::3] = False
        return torch.tensor(m, device=dev)
    elif kind == "all kept":
        lens = np.full(B, T)
    else:
        return None
    return torch.tensor(np.arange(T)[None] >= (T - lens)[:, None], device=dev)


# (label, B, T, W, mask): RecurrentGemma-9B's verify block at the main
# path's batch (the frozen-row mask), its prefill batch (left pads), the
# longest prompt the port prefills (below _FLASH_THRESHOLD, one row), a
# ragged width without a mask and a width that is not a multiple of 4
# (the kernel's 4-byte copy path). The admission shape is added after
# phase 7, from the launches by shape of its continuous run.
RGLRU_CASES = [("verify", 8, VERIFY_T, 4096, "rows masked out"),
               ("prefill", 8, 256, 4096, "left pads"),
               ("longest prompt", 1, 2047, 4096, "all kept"),
               ("ragged width", 3, 40, 4000, None),
               ("odd width", 2, 33, 4001, "rows masked out")]


def rglru_case(torch, np, timer, card, label, B, T, W, mk, seed):
    """One phase 3d case: the kernel bit-identical to the plain version
    (and within RGLRU_TOL), then kernel, plain and bound times."""
    from repro_torch.kernels.rglru import ops as rg_ops
    from repro_torch.kernels.rglru.ref import rglru_scan_ref

    copies = [rglru_inputs(torch, np, B, T, W, seed + j) for j in range(4)]
    mask = rglru_mask(torch, np, mk, B, T)
    got = rg_ops.rglru_scan_cuda(*copies[0], mask)
    want = rglru_scan_ref(*copies[0], mask)
    torch.cuda.synchronize()
    err = 0.0
    for name, g, w in zip(("hs", "h_final"), got, want):
        check(bool(torch.isfinite(g).all()), f"rglru {name}: non-finite")
        err = max(err, float((g - w).abs().max()))
        where = f"rglru {label} (B={B} T={T} W={W}, {mk}) {name}"
        check(torch.allclose(g, w, **RGLRU_TOL),
              f"{where}: max |err| {float((g - w).abs().max())}")
        check(torch.equal(g, w), f"{where}: not bit-identical to the plain "
              "version")
    it = {"i": 0}

    def nxt():
        it["i"] += 1
        return copies[it["i"] % len(copies)]

    ms = timer.ms(lambda: rg_ops.rglru_scan_cuda(*nxt(), mask), 50)
    plain_ms = timer.ms(lambda: rglru_scan_ref(*nxt(), mask), 5, warmup=1)
    bound_ms, bound_by = rglru_bound_ms(copies[0][0], mask)
    every_ms, _ = rglru_bound_ms(copies[0][0], mask, skip_masked=False)
    log(f"rglru_scan {label} (B={B} T={T} W={W}, mask: {mk}): bit-identical "
        f"to the plain version (max |err| {err:.3e}); kernel "
        f"{ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, bound "
        f"{bound_ms * 1e3:.2f} us ({bound_by}; {every_ms * 1e3:.2f} us "
        f"reading every step)  [{card}]")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def timer_floor(torch, np, timer, card):
    """The timer's floor: an empty kernel (``torch.cuda._sleep(0)``) and
    the scan at (B 1, T 1, W 1), timed as every kernel is."""
    from repro_torch.kernels.rglru import ops as rg_ops

    empty = timer.ms(lambda: torch.cuda._sleep(0), 50)
    tiny = rglru_inputs(torch, np, 1, 1, 1, 0)
    one = timer.ms(lambda: rg_ops.rglru_scan_cuda(*tiny), 50)
    log(f"timer floor: empty kernel {empty * 1e3:.2f} us, rglru_scan at "
        f"(1, 1, 1) {one * 1e3:.2f} us  [{card}]")
    return empty, one


def phase_rglru(torch, np, timer, card):
    """Phase 3d. Returns the kernels JSON line's two entries of the scan:
    ``rglru_scan`` at the verify shape and ``rglru_scan_prefill`` at the
    prefill shape (their launches are set after phase 7)."""
    timer_floor(torch, np, timer, card)
    res = {label: rglru_case(torch, np, timer, card, label, B, T, W, mk,
                             40 + 4 * ci)
           for ci, (label, B, T, W, mk) in enumerate(RGLRU_CASES)}
    # library_ms is null: no single PyTorch call computes a gated linear
    # recurrence (torch has no associative scan over a custom operator)
    common = dict(route="cuda", source="src/repro_torch/csrc/rglru.cu",
                  replaces="src/repro/kernels/rglru/kernel.py:64",
                  library_ms=None)
    out = []
    for name, label, errs in (
            ("rglru_scan", "verify", ("verify",)),
            ("rglru_scan_prefill", "prefill",
             [c[0] for c in RGLRU_CASES if c[0] != "verify"])):
        r = res[label]
        out.append(dict(name=name, max_abs_err=max(res[e]["err"]
                                                   for e in errs),
                        ms=r["ms"], plain_ms=r["plain_ms"],
                        bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                        **common))
    return out


# ---------------------------------------------------------------------------
# phase 4: the lock-step path at full width
# ---------------------------------------------------------------------------

def reset_launches():
    from repro_torch.kernels.rglru import ops as rg_ops
    from repro_torch.kernels.spec_verify import ops as sv_ops
    from repro_torch.kernels.suffix_match import ops as sm_ops

    sv_ops.LAUNCHES = 0
    sm_ops.LAUNCHES = 0
    sm_ops.LAUNCHES_CHUNKED = 0
    rg_ops.LAUNCHES = 0
    rg_ops.LAUNCHES_BY_SHAPE.clear()
    rg_ops.BWD_LAUNCHES = 0


def read_launches():
    from repro_torch.kernels.rglru import ops as rg_ops
    from repro_torch.kernels.spec_verify import ops as sv_ops
    from repro_torch.kernels.suffix_match import ops as sm_ops

    return {"spec_verify_attention": sv_ops.LAUNCHES,
            "suffix_match_propose": sm_ops.LAUNCHES,
            "suffix_match_propose_chunked": sm_ops.LAUNCHES_CHUNKED,
            "rglru_scan": rg_ops.LAUNCHES,
            "rglru_scan_by_shape": Counter(rg_ops.LAUNCHES_BY_SHAPE),
            "rglru_scan_bwd": rg_ops.BWD_LAUNCHES}


def check_rglru_launches(cfg, launches, n_fwd, where):
    """One RG-LRU launch per recurrent layer per forward (prefills and
    verify rounds alike), none for a model without recurrent layers."""
    n_rec = sum(k == "rglru" for k in cfg.layer_kinds)
    check(launches["rglru_scan"] == n_rec * n_fwd,
          f"{where}: {launches['rglru_scan']} RG-LRU launches, expected "
          f"{n_rec} layers x {n_fwd} forwards")
    check(sum(launches["rglru_scan_by_shape"].values())
          == launches["rglru_scan"],
          f"{where}: the RG-LRU launches by shape do not sum to the total")


def check_sv_launches(cfg, launches, n_rounds, where):
    """One spec-verify launch per attention layer per verify round: the
    prefills run without the cache and never launch it."""
    n_attn = sum(k in ("attn", "local_attn") for k in cfg.layer_kinds)
    check(launches["spec_verify_attention"] == n_attn * n_rounds,
          f"{where}: {launches['spec_verify_attention']} spec-verify "
          f"launches, expected {n_attn} attention layers x {n_rounds} "
          "verify rounds")


class SvSpy:
    """Wraps ``spec_verify_attention_cuda`` on the main path: keeps the
    inputs (the cache tensors copied) and the output of each epoch's
    first launch and of every ``EVERY``-th, to be held against the plain
    version after the run, outside its timing. Adds no launch."""

    EVERY = 64

    def __init__(self):
        from repro_torch.kernels.spec_verify import ops as sv_ops

        self.ops = sv_ops
        self.real = sv_ops.spec_verify_attention_cuda
        self.kept = []
        self.n = 0
        self.first = True

    def new_epoch(self):
        self.first = True

    def __call__(self, q, k, v, cache_pos, positions, **kw):
        out = self.real(q, k, v, cache_pos, positions, **kw)
        if self.first or self.n % self.EVERY == 0:
            self.kept.append(tuple(t.clone() for t in (
                q, k, v, cache_pos, positions, out)) + (kw,))
        self.n += 1
        self.first = False
        return out

    def __enter__(self):
        self.ops.spec_verify_attention_cuda = self
        return self

    def __exit__(self, *exc):
        self.ops.spec_verify_attention_cuda = self.real

    def check(self, torch, card, where):
        from repro_torch.kernels.spec_verify.ref import (
            spec_verify_attention_ref,
        )

        check(len(self.kept) >= 2,
              f"{where}: only {len(self.kept)} spec-verify launches kept")
        worst = 0.0
        shapes = set()
        for q, k, v, cpos, pos, got, kw in self.kept:
            want = spec_verify_attention_ref(q, k, v, cpos, pos, **kw)
            err = float((got.float() - want.float()).abs().max())
            check(bool(torch.isfinite(got).all()) and torch.allclose(
                got.float(), want.float(), **SV_TOL["bfloat16"]),
                f"{where}: a kept spec-verify launch differs from the plain "
                f"version, max |err| {err}")
            worst = max(worst, err)
            shapes.add((tuple(q.shape), tuple(k.shape), kw.get("window", 0)))
        log(f"{where}: {len(self.kept)} of {self.n} spec-verify launches kept "
            f"(each epoch's first, every {self.EVERY}th), within the bf16 "
            f"tolerance of the plain version: max |err| {worst:.3e}; (q, "
            f"cache, window) {sorted(shapes)}  [{card}]")
        self.kept.clear()


class SmSpy:
    """Wraps one suffix-match wrapper on the main path
    (``suffix_match_propose_cuda``, or with ``chunked``
    ``suffix_match_propose_chunked_cuda``). Keeps the inputs (the query
    tensors copied, the forest by reference: a repack makes new tensors)
    and the outputs of each epoch's first launch and of every
    ``EVERY``-th, to be held against the plain version after the run,
    outside its timing; and the inputs and proposal counts of every
    launch of the second epoch, of which the one that proposed the most
    tokens (the latest such) is the path's own timing case
    (``path_case``). Adds no launch and no host sync."""

    EVERY = 16

    def __init__(self, chunked: bool):
        from repro_torch.kernels.suffix_match import ops as sm_ops

        self.ops = sm_ops
        self.chunked = chunked
        self.attr = ("suffix_match_propose_chunked_cuda" if chunked
                     else "suffix_match_propose_cuda")
        self.real = getattr(sm_ops, self.attr)
        self.kept = []
        self.late = []
        self.trees = 0
        self.n = 0
        self.epoch = -1
        self.first = True

    def new_epoch(self):
        self.epoch += 1
        self.first = True

    def __call__(self, forest, tails, roots, budgets, **kw):
        out = self.real(forest, tails, roots, budgets, **kw)
        if self.chunked:
            self.trees = max(self.trees, int(forest.edge_node.shape[0]))
        keep = self.first or self.n % self.EVERY == 0
        if keep or self.epoch == 1:
            q = tuple(t.clone() for t in (tails, roots, budgets))
        if keep:
            self.kept.append((forest, q, kw, tuple(o.clone() for o in out)))
        if self.epoch == 1:
            self.late.append((forest, q, kw, out[1].clone()))
        self.n += 1
        self.first = False
        return out

    def __enter__(self):
        setattr(self.ops, self.attr, self)
        return self

    def __exit__(self, *exc):
        setattr(self.ops, self.attr, self.real)

    def plain(self, forest, tails, roots, budgets, **kw):
        from repro_torch.kernels.suffix_match.ref import (
            suffix_match_propose_chunked_ref,
            suffix_match_propose_ref,
        )

        ref = (suffix_match_propose_chunked_ref if self.chunked
               else suffix_match_propose_ref)
        return ref(tails, roots, budgets, *forest, **kw)

    def check(self, torch, card, where):
        """The kept launches against the plain version on the same forest
        and query: bit-identical; at least one of them proposed."""
        check(len(self.kept) >= 2,
              f"{where}: only {len(self.kept)} {self.attr} launches kept")
        rows = toks = 0
        shapes = set()
        for forest, q, kw, got in self.kept:
            want = self.plain(forest, *q, **kw)
            for name, g, w in zip(("match_len", "n_prop", "props"), got,
                                  want):
                check(torch.equal(g, w), f"{where}: a kept {self.attr} "
                      f"launch's {name} differs from its plain version")
            rows += int((got[1] > 0).sum())
            toks += int(got[1].sum())
            shapes.add((tuple(q[0].shape), tuple(forest.edge_node.shape),
                        tuple(forest.suffix_link.shape),
                        tuple(forest.corpus.shape)))
        check(toks > 0, f"{where}: no kept {self.attr} launch proposed")
        log(f"{where}: {len(self.kept)} of {self.n} {self.attr} launches "
            f"kept (each epoch's first, every {self.EVERY}th), bit-identical "
            f"to the plain version ({rows} rows proposed {toks} tokens; "
            f"tails, edges, nodes, corpus seen: {sorted(shapes)})  [{card}]")
        self.kept.clear()

    def path_case(self):
        """The inputs of the second epoch's launch that proposed the most
        tokens (the latest of those), and its place in the epoch."""
        check(bool(self.late), f"no {self.attr} launch in the second epoch")
        n = [int(late[3].sum()) for late in self.late]
        j = max(range(len(n)), key=lambda j: (n[j], j))
        return self.late[j][:3], j


def time_path_case(torch, np, timer, card, spy, where):
    """The kernel at the path's own shape (``spy.path_case()``), after the
    run: bit-identical to its plain version, then timed (kernel, plain)
    with its bound. Returns (ms, plain_ms, bound_ms)."""
    (forest, q, kw), j = spy.path_case()
    got = spy.real(forest, *q, **kw)
    want = spy.plain(forest, *q, **kw)
    torch.cuda.synchronize()
    for name, g, w in zip(("match_len", "n_prop", "props"), got, want):
        check(torch.equal(g, w), f"{where}: the path case's {name} differs "
              "from the plain version")
    ms = timer.ms(lambda: spy.real(forest, *q, **kw), 50)
    plain_ms = timer.ms(lambda: spy.plain(forest, *q, **kw), 5, warmup=1)
    bound_ms, entries = suffix_match_bound_ms(
        np, got, *q, forest, chunked=spy.chunked, **kw)
    B, m = q[0].shape
    log(f"{where}: {spy.attr} at the path's shape (epoch 2, launch "
        f"{j + 1} of {len(spy.late)}; B={B} m={m} "
        f"K={kw['n_prop_max']}, edges {tuple(forest.edge_node.shape)}, "
        f"{int((q[1] >= 0).sum())} rows active, n_prop "
        f"{got[1].cpu().numpy().tolist()}): kernel {ms * 1e3:.1f} us, plain "
        f"{plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.4f} us "
        f"({entries} forest entries read + query + outputs)  [{card}]")
    spy.late.clear()
    return ms, plain_ms, bound_ms


@contextlib.contextmanager
def plain_rglru_scan():
    """Swaps the plain scan into ``kernels.rglru.ops`` for a reference
    forward, the way the continuous phase's spy swaps the chunked kernel:
    the plain greedy check must not run the kernel under test."""
    from repro_torch.kernels.rglru import ops as rg_ops
    from repro_torch.kernels.rglru.ref import rglru_scan_ref

    saved = rg_ops.rglru_scan
    rg_ops.rglru_scan = rglru_scan_ref
    try:
        yield
    finally:
        rg_ops.rglru_scan = saved


def full_width_model(torch, arch, layers=None):
    """``arch`` at its published config, depth cut to ``layers`` if given;
    random bf16 weights from seed 0, made on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = get_config(arch)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"{arch}: {M.param_count(params) / 1e9:.3f} B params ({cfg.dtype}, "
        f"{cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, "
        f"kinds {dict(Counter(cfg.layer_kinds))}, vocab "
        f"{cfg.padded_vocab}) initialised on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    return cfg, params


def phase_main_path(torch, np, card, cfg, params, micro_rounds=1):
    """Phase 4's lock-step traffic (phase 7's for the hybrid), with up to
    ``micro_rounds`` fused rounds a dispatch. Returns the launches, the
    flat suffix-match spy and each epoch's (outputs, stats, wall s)."""
    from repro_torch.core.drafter import DrafterConfig, SuffixDrafter
    from repro_torch.core.spec_engine import EngineConfig, SpecEngine
    from repro_torch.models import model as M

    # One K bucket (16): every verify round runs the same (8, 17) block
    # shape, so the GEMMs of both epochs use the same kernels and T=0
    # identity across epochs does not rest on cuBLAS picking the same
    # kernel for two shapes.
    eng = SpecEngine(
        params, cfg,
        EngineConfig(max_draft=16, block_buckets=(16,), max_new_tokens=256,
                     eos_token=1, fuse_rounds="auto",
                     micro_rounds=micro_rounds),
        drafter=SuffixDrafter(DrafterConfig(scope="problem")),
        device="cuda",
    )
    where = f"{cfg.name} lock-step" + (f" R={micro_rounds}"
                                       if micro_rounds > 1 else "")
    rng = np.random.default_rng(1)
    problems = [[int(t) for t in rng.integers(2, cfg.vocab_size,
                                              size=int(rng.integers(128, 257)))]
                for _ in range(4)]
    prompts = [problems[i // 2] for i in range(8)]
    pids = [f"p{i // 2}" for i in range(8)]
    max_new = [(32, 64, 128, 256)[i // 2] for i in range(8)]

    # the prefill's logits at full width are finite and of the right shape
    Tp = 256
    toks = torch.zeros((8, Tp), dtype=torch.int32, device="cuda")
    mask = torch.zeros((8, Tp), dtype=torch.bool, device="cuda")
    for b, p in enumerate(prompts):
        toks[b, Tp - len(p):] = torch.tensor(p, dtype=torch.int32)
        mask[b, Tp - len(p):] = True
    with torch.inference_mode():
        last, _ = M.prefill(params, cfg, toks, mask, max_len=576)
    check(tuple(last.shape) == (8, cfg.padded_vocab), "prefill logits shape")
    check(bool(torch.isfinite(last).all()), "prefill logits not finite")

    reset_launches()
    epochs = []
    spy = SvSpy()
    sm_spy = SmSpy(chunked=False)
    for ep in range(2):
        eng.begin_iteration(ep)
        spy.new_epoch()
        sm_spy.new_epoch()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with spy, sm_spy:
            outs, st = eng.generate(prompts, pids, max_new_tokens=max_new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        epochs.append((outs, st, wall))
        toks_n = st.n_toks_emitted
        log(f"{where} epoch {ep + 1}: wall {wall * 1e3:.1f} ms, rounds "
            f"{st.n_rounds}, "
            f"tokens {toks_n}, {toks_n / wall:.1f} tok/s, drafted "
            f"{st.n_drafted}, accepted {st.n_accepted} "
            f"({st.acceptance_per_round:.2f}/round), peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]")
    launches = read_launches()
    log(f"{where} path launches: {launches}")
    (o1, s1, _), (o2, s2, _) = epochs
    for b, o in enumerate(o1):
        check(len(o) <= max_new[b], f"row {b} emitted {len(o)} > {max_new[b]}")
        check(all(0 <= t < cfg.vocab_size for t in o), f"row {b}: bad token")
    check(o2 == o1, "epoch 2 outputs differ from epoch 1 (T=0 is lossless)")
    check(s2.n_accepted > 0, "epoch 2 accepted no drafts")
    check(s2.n_rounds < s1.n_rounds, "epoch 2 did not cut verify rounds")
    check(launches["suffix_match_propose"] > 0,
          "suffix_match_propose never launched on the lock-step path")
    # every dispatched micro-round launches, the rounds past the loop's
    # exit (``n_idle_rounds``) included
    idle = s1.n_idle_rounds + s2.n_idle_rounds
    check_sv_launches(cfg, launches, s1.n_rounds + s2.n_rounds + idle, where)
    spy.check(torch, card, where)
    sm_spy.check(torch, card, where)
    check(launches["suffix_match_propose_chunked"] == 0,
          "the chunked kernel launched on the flat lock-step path")
    check_rglru_launches(cfg, launches, s1.n_fwd + s2.n_fwd + idle, where)
    del eng
    torch.cuda.empty_cache()
    return launches, sm_spy, epochs


MICRO_R = 4  # the micro-loop's rounds a dispatch on the card


def phase_micro(torch, np, card, cfg, params, ref):
    """The lock-step traffic again with ``MICRO_R`` fused rounds a
    dispatch (``EngineConfig.micro_rounds``), against ``ref``, the R = 1
    run's epochs: per epoch the same tokens, the same verify rounds and
    strictly fewer result downloads (``n_d2h``). Logs the rounds a
    dispatch, the live micro-rounds of those dispatched and the wall a
    round beside R = 1's. Returns the launches."""
    launches, _, runs = phase_main_path(torch, np, card, cfg, params,
                                        micro_rounds=MICRO_R)
    for ep, ((o1, s1, w1), (o4, s4, w4)) in enumerate(zip(ref, runs)):
        where = f"{cfg.name} R={MICRO_R} epoch {ep + 1}"
        check(o4 == o1, f"{where}: tokens differ from the R = 1 run")
        check(s4.n_rounds == s1.n_rounds, f"{where}: {s4.n_rounds} verify "
              f"rounds, R = 1 ran {s1.n_rounds}")
        check(s4.n_d2h < s1.n_d2h, f"{where}: n_d2h {s4.n_d2h} is not below "
              f"R = 1's {s1.n_d2h}")
        dispatched = s4.n_rounds + s4.n_idle_rounds
        log(f"{where}: tokens and {s4.n_rounds} rounds equal to R = 1; "
            f"{s4.n_dispatches} dispatches, {s4.n_rounds / s4.n_dispatches:.2f}"
            f" rounds a dispatch, {s4.n_rounds} of {dispatched} dispatched "
            f"micro-rounds live; n_d2h {s4.n_d2h} (R = 1: {s1.n_d2h}); wall a "
            f"round {w4 / s4.n_rounds * 1e3:.2f} ms (R = 1: "
            f"{w1 / s1.n_rounds * 1e3:.2f} ms); drafted {s4.n_drafted} "
            f"(R = 1: {s1.n_drafted})  [{card}]")
    return launches


# ---------------------------------------------------------------------------
# phase 5: the continuous path at full width
# ---------------------------------------------------------------------------

def continuous_requests(np, vocab, n_problems=12, n_requests=24,
                        limits=(32, 64, 128, 256), prompt_len=(128, 256)):
    """Seeded prompts of ``prompt_len`` tokens, two requests a problem,
    token limits cycling through ``limits``."""
    rng = np.random.default_rng(7)
    problems = [[int(t) for t in rng.integers(
                    2, vocab, size=int(rng.integers(prompt_len[0],
                                                    prompt_len[1] + 1)))]
                for _ in range(n_problems)]
    per = n_requests // n_problems
    return ([problems[i // per] for i in range(n_requests)],
            [f"p{i // per}" for i in range(n_requests)],
            [limits[i % len(limits)] for i in range(n_requests)])


def serve_epochs(torch, eng, prompts, pids, max_new, slots, dev, card, tag,
                 on_epoch=None):
    """Two epochs of ``SpecEngine.serve`` over the same requests; returns
    per epoch the outputs, per-request rounds and admission rounds, and
    the stats. ``on_epoch()`` is called as each epoch begins."""
    from repro_torch.core.scheduler import Request
    from repro_torch.core.spec_engine import RolloutStats

    runs = []
    for ep in range(2):
        eng.begin_iteration(ep)
        if on_epoch is not None:
            on_epoch()
        reqs = [Request(rid=i, problem_id=pids[i], prompt=list(prompts[i]),
                        max_new_tokens=max_new[i])
                for i in range(len(prompts))]
        st = RolloutStats()
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in eng.serve(reqs, slots=slots, stats=st):
            pass
        if dev == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        toks = st.n_toks_emitted
        log(f"{tag} epoch {ep + 1}: makespan {st.n_rounds} rounds, wall "
            f"{wall * 1e3:.1f} ms, tokens {toks}, {toks / wall:.1f} tok/s, "
            f"drafted {st.n_drafted}, accepted {st.n_accepted}  [{card}]")
        runs.append(dict(outputs=[r.output for r in reqs],
                         rounds=[r.rounds for r in reqs],
                         admit=[r.admit_round for r in reqs],
                         makespan=st.n_rounds, accepted=st.n_accepted,
                         stats=st))
    return runs


def continuous_layouts(torch, np, cfg, params, dev, card, *, slots,
                       n_problems, n_requests, limits, prompt_len,
                       layouts=("chunked", "flat")):
    """The continuous path with the chunked forest, then (unless
    ``layouts`` leaves it out) with the flat one on a fresh engine and
    drafter; gated as ``phase_continuous`` says. Returns each run's
    launches (by layout), the chunked run's runs, the prompts, the
    lock-step outputs of the same prompts and the chunked run's
    suffix-match spy (its second epoch's launches kept for timing)."""
    from repro_torch.core.drafter import DrafterConfig, SuffixDrafter
    from repro_torch.core.spec_engine import EngineConfig, SpecEngine

    prompts, pids, max_new = continuous_requests(
        np, cfg.vocab_size, n_problems, n_requests, limits, prompt_len)
    result = {}
    for layout in layouts:
        # one K bucket (16): every verify round runs one (slots, 17) block
        eng = SpecEngine(
            params, cfg,
            EngineConfig(max_draft=16, block_buckets=(16,),
                         max_new_tokens=max(limits), eos_token=1,
                         fuse_rounds="auto"),
            drafter=SuffixDrafter(DrafterConfig(scope="problem",
                                                forest_layout=layout)),
            device=dev,
        )
        sv_spy = SvSpy()
        sm_spy = SmSpy(chunked=layout == "chunked")

        def on_epoch():
            sv_spy.new_epoch()
            sm_spy.new_epoch()

        reset_launches()
        with sv_spy, sm_spy:
            runs = serve_epochs(torch, eng, prompts, pids, max_new, slots,
                                dev, card, f"continuous ({layout})",
                                on_epoch=on_epoch)
        launches = read_launches()
        log(f"{cfg.name} continuous ({layout}) launches: {launches}")
        if dev == "cuda":
            where = f"{cfg.name} continuous ({layout})"
            check_sv_launches(cfg, launches,
                              sum(r["stats"].n_rounds for r in runs), where)
            sv_spy.check(torch, card, where)
            sm_spy.check(torch, card, where)
        result[layout] = (runs, launches, eng, sm_spy)
    c_runs, c_launch, c_eng, c_spy = result["chunked"]
    f_runs, f_launch, f_eng, _ = result.get("flat",
                                           (c_runs, None, c_eng, None))
    for ep, (c, f) in enumerate(zip(c_runs, f_runs)):
        for key in ("outputs", "rounds", "makespan", "accepted"):
            check(c[key] == f[key], f"continuous epoch {ep + 1}: {key} "
                  "differ between the chunked and the flat layouts")
        for i, o in enumerate(c["outputs"]):
            check(len(o) <= max_new[i], f"request {i} emitted {len(o)}")
            check(all(0 <= t < cfg.vocab_size for t in o),
                  f"request {i}: bad token")
        check(max(c["admit"]) > 0, "no slot was recycled")
    check(c_runs[1]["accepted"] > 0, "continuous epoch 2 accepted no drafts")
    if dev == "cuda":
        check(c_launch["suffix_match_propose_chunked"] > 0,
              "the chunked kernel never launched on the chunked run")
        check(c_launch["suffix_match_propose"] == 0,
              "the flat kernel launched on the chunked run")
        if f_launch is not None:
            check(f_launch["suffix_match_propose"] > 0,
                  "the flat kernel never launched on the flat run")
            check(f_launch["suffix_match_propose_chunked"] == 0,
                  "the chunked kernel launched on the flat run")
        check_rglru_launches(cfg, c_launch,
                             sum(r["stats"].n_fwd for r in c_runs),
                             f"{cfg.name} continuous (chunked)")
        check(c_spy.trees >= n_problems,
              f"the chunked forest held {c_spy.trees} trees")
    lock, _ = f_eng.generate(prompts, pids, max_new_tokens=max_new)
    launches = {k: v[1] for k, v in result.items()}
    del c_eng, f_eng, result
    return launches, c_runs, prompts, lock, c_spy


def phase_continuous(torch, np, card, cfg, params,
                     layouts=("chunked", "flat")):
    """``SpecEngine.serve`` at full width: 24 requests over 12 problems in
    8 slots, two epochs, chunked then flat. Gated: identical outputs,
    per-request rounds, makespan and acceptances between the layouts;
    each run launched its own suffix-match kernel and not the other; each
    run's kept suffix-match launches equal the plain version; the chunked
    forest held every problem's tree; slots were recycled; epoch 2
    accepted drafts; every token of both epochs and of lock-step
    ``generate`` on the same prompts is plain greedy's choice within the
    bf16 tolerance (``plain_greedy_full_width``). Reported: how many
    outputs equal lock-step ``generate`` exactly (bf16 admissions prefill
    in chunks of other sizes than the lock-step batch, so cuBLAS may round
    differently), and where those that differ diverge. Returns each run's
    launches (by layout) and the chunked run's suffix-match spy."""
    launches, runs, prompts, lock, spy = continuous_layouts(
        torch, np, cfg, params, "cuda", card, slots=8, n_problems=12,
        n_requests=24, limits=(32, 64, 128, 256), prompt_len=(128, 256),
        layouts=layouts)
    same = [sum(a == b for a, b in zip(r["outputs"], lock)) for r in runs]
    log(f"{cfg.name} continuous vs lock-step generate (bf16, reported): "
        f"{same[0]} / "
        f"{len(lock)} outputs equal in epoch 1, {same[1]} / {len(lock)} in "
        f"epoch 2  [{card}]")
    plain_greedy_full_width(
        torch, np, cfg, params, prompts,
        {"lock-step": lock, "continuous epoch 1": runs[0]["outputs"],
         "continuous epoch 2": runs[1]["outputs"]}, card)
    torch.cuda.empty_cache()
    return launches, spy


# The most a bf16 engine's token may fall short of plain greedy's top
# logit on the same prefix: 8 bfloat16 ulps at the top logits' magnitude
# here (4 to 8, one ulp 2^-5). Two bf16 computations of the same logits
# whose every logit differs by at most e pick tokens at most 2e apart;
# a token picked on a wrong context falls short by about the top logit.
TOL_LOGIT_BF16 = 0.25


def plain_greedy_full_width(torch, np, cfg, params, prompts, outputs, card):
    """Every token of every output set (name -> one output per prompt)
    against plain greedy decoding: one full-sequence forward (no cache, no
    kernels: the RG-LRU scan swapped for its plain version) over prompt +
    output gives the logits at each position on the
    output's own prefix, and the output's token must be the top or within
    ``TOL_LOGIT_BF16`` of it. An output that is a prefix of one already
    checked for the same prompt reuses its forward. Logs, per set, the
    tokens checked, how many are the top, the largest shortfall, and,
    for outputs that differ from the first set's, the first position they
    differ at with both tokens' shortfalls there."""
    from repro_torch.models import model as M

    dev = params.embed.device
    done = {}  # prompt -> list of (tokens, shortfalls, top-2 gaps)

    def measure(p, out):
        for toks, sf, gap in done.get(tuple(p), []):
            if toks[:len(out)] == out:
                return sf[:len(out)], gap[:len(out)]
        x = torch.tensor([list(p) + list(out)], dtype=torch.int32, device=dev)
        with torch.inference_mode(), plain_rglru_scan():
            logits, _ = M.forward(params, cfg, x)
            lg = logits[0, len(p) - 1:len(p) - 1 + len(out), :cfg.vocab_size]
            top2 = torch.topk(lg, 2, dim=-1).values
            chosen = lg.gather(1, torch.tensor(out, device=dev)[:, None])
            sf = (top2[:, 0] - chosen[:, 0]).cpu().numpy()
            gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        done.setdefault(tuple(p), []).append((list(out), sf, gap))
        return sf, gap

    res = {name: {} for name in outputs}
    for name, i in sorted(  # longest first, so prefixes reuse a forward
            ((n, i) for n in outputs for i in range(len(prompts))),
            key=lambda ni: -len(outputs[ni[0]][ni[1]])):
        out = list(outputs[name][i])
        res[name][i] = (measure(prompts[i], out) if out
                        else (np.zeros(0), np.zeros(0)))
    ref_name = next(iter(outputs))
    worst = 0.0
    for name, outs in outputs.items():
        sfs = np.concatenate([res[name][i][0] for i in range(len(outs))])
        n_top = int((sfs == 0).sum())
        mx = float(sfs.max(initial=0.0))
        worst = max(worst, mx)
        div = []
        for i, o in enumerate(outs):
            r = outputs[ref_name][i]
            if name == ref_name or o == r:
                continue
            j = next((j for j, (a, b) in enumerate(zip(o, r)) if a != b),
                     min(len(o), len(r)))
            if j < min(len(o), len(r)):
                div.append(f"r{i}@{j}: {float(res[name][i][0][j]):.4f}/"
                           f"{float(res[ref_name][i][0][j]):.4f} (top-2 gap "
                           f"{float(res[ref_name][i][1][j]):.4f})")
            else:
                div.append(f"r{i}: length {len(o)} vs {len(r)}")
        log(f"plain greedy ({cfg.dtype}) vs {name}: {sfs.size} tokens, "
            f"{n_top} the top logit, largest shortfall {mx:.4f} (tolerance "
            f"{TOL_LOGIT_BF16})" + (f"; first divergence from {ref_name}, "
                                    f"shortfall this/that: {'; '.join(div)}"
                                    if div else "") + f"  [{card}]")
    check(worst <= TOL_LOGIT_BF16,
          f"a full-width engine token falls {worst:.4f} short of plain "
          f"greedy's top logit (tolerance {TOL_LOGIT_BF16})")


def phase_small_reference(torch, np, arch, dev="cuda"):
    """The engine (kernels, ring cache, drafts) against plain greedy
    decoding (full-sequence forward, no cache, no kernels) on the small
    float32 variant of ``arch``, compared up to the first near-tie (top-2
    gap < 1e-3); the continuous engine (fewer slots than requests, chunked
    forest) must give the lock-step engine's tokens in both epochs."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.core.drafter import DrafterConfig, SuffixDrafter
    from repro_torch.core.spec_engine import EngineConfig, SpecEngine
    from repro_torch.models import model as M

    cfg = smoke_variant(get_config(arch))
    params = M.init_params(cfg, seed=3, device=dev)

    def engine(layout):
        return SpecEngine(
            params, cfg,
            EngineConfig(max_new_tokens=24, max_draft=8, eos_token=1),
            drafter=SuffixDrafter(DrafterConfig(scope="problem",
                                                forest_layout=layout)),
            device=dev)

    eng, cont = engine("auto"), engine("chunked")
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(2, cfg.vocab_size, size=n)]
               for n in (9, 14, 20, 5)]
    pids = ["a", "b", "a", "c"]
    accepted = 0
    for ep in range(2):
        eng.begin_iteration(ep)
        cont.begin_iteration(ep)
        outs, st = eng.generate(prompts, pids)
        couts, cst = cont.generate_continuous(prompts, pids, slots=2)
        check(couts == outs, f"epoch {ep + 1}: generate_continuous differs "
              "from lock-step generate (float32)")
        accepted += cst.n_accepted
    check(accepted > 0, "the continuous engine accepted no drafts")
    compared = 0
    with torch.inference_mode(), plain_rglru_scan():
        for p, o in zip(prompts, outs):
            seq = list(p)
            for tok in o:
                x = torch.tensor([seq], dtype=torch.int32, device=dev)
                logits, _ = M.forward(params, cfg, x)
                lg = logits[0, -1, : cfg.vocab_size]
                top2 = torch.topk(lg, 2).values
                if float(top2[0] - top2[1]) < 1e-3:
                    break
                check(int(lg.argmax()) == tok,
                      "engine output differs from plain greedy decoding")
                compared += 1
                seq.append(tok)
    check(compared >= 40, f"only {compared} tokens compared")
    log(f"small float32 reference ({cfg.name}): {compared} tokens equal to plain greedy "
        f"decoding; generate_continuous (2 slots, chunked) equal to "
        f"lock-step generate in both epochs (epoch 2 accepted "
        f"{st.n_accepted} lock-step, {cst.n_accepted} continuous)")


# ---------------------------------------------------------------------------
# phase 8: the RL loop on the card (Qwen2-1.5B at its published config)
# ---------------------------------------------------------------------------

# _flash against dense attention on the same inputs: the output within
# atol/rtol, each gradient within ``grad`` of the dense one's largest
# magnitude (max |err| / max |ref|). bf16 rounds P before the value
# product tile by tile in _flash and once over the whole row in the dense
# softmax, so it needs the looser bound.
FLASH_TOL = {"float32": dict(atol=1e-4, rtol=1e-3, grad=1e-4),
             "bfloat16": dict(atol=3e-2, rtol=1e-2, grad=3e-2)}
# the GRPO surrogate at ratio 1 against -sum(adv * mask) / sum(mask)
SURROGATE_RTOL = 1e-3
# remat recomputes each block's forward with the same kernels in the
# backward: its gradients against the step's, max |err| / max |ref| per
# parameter (bf16 gradients; 0 when every kernel repeats its rounding)
REMAT_GRAD_TOL = 1e-2
# Learning rate of phase 8's AdamW steps. Adam's first steps move every
# weight by about lr (the sign of its gradient), and the weights are bf16
# with no master copy (the reference's rule): at 1e-4 every weight of the
# random model moves by about one ulp at once and the surrogate rose from
# -0.72 to 25.8 in one step (NVIDIA H100 80GB HBM3, 700 W); at 1e-5 only
# the small weights and the zero-initialised QKV biases move.
STEP_LR = 1e-5


def peak_mb(torch, fn):
    """Device memory ``fn`` allocates at its peak beyond what was live
    before it, in MB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e6


def phase_flash(torch, np, timer, card, B=4, S=2304, Hq=12, Hkv=2, hd=128):
    """8a: ``_flash_attn_train`` forward and backward at Qwen2-1.5B's
    attention shape and a long-tail length, float32 and bf16, against
    autograd through the plain dense attention (``_attn_core``); times
    (forward, forward + backward) beside the dense version's and SDPA's
    forward + backward with the same boolean mask, and each one's peak
    memory."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.models import layers as L

    cfg = get_config("qwen2-1.5b")
    rng = np.random.default_rng(80)
    base = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda()
            for shape in ((B, S, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd),
                          (B, S, Hq, hd))]
    pos = torch.arange(S, dtype=torch.int32, device="cuda")[None].expand(B, S)
    mask = (pos[:, None, :] <= pos[:, :, None])[:, None]  # (B, 1, S, S)
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        q, k, v = (t.to(dt).requires_grad_() for t in base[:3])
        dout = base[3].to(dt)

        def flash():
            return L._flash_attn_train(q, k, v, pos, cfg, window=0,
                                       valid=None)

        def dense():
            return L._attn_core(q, k, v, mask, cfg)

        out = flash()
        grads = torch.autograd.grad(out, (q, k, v), dout)
        ref = dense()
        rgrads = torch.autograd.grad(ref, (q, k, v), dout)
        tol = FLASH_TOL[dtype]
        out, ref = out.detach(), ref.detach()
        err = float((out.float() - ref.float()).abs().max())
        check(bool(torch.isfinite(out).all()) and torch.allclose(
            out.float(), ref.float(), atol=tol["atol"], rtol=tol["rtol"]),
            f"_flash {dtype} forward: max |err| {err}")
        rel = []
        for name, g, r in zip(("dq", "dk", "dv"), grads, rgrads):
            e = float((g.float() - r.float()).abs().max()
                      / r.float().abs().max())
            check(bool(torch.isfinite(g).all()) and e <= tol["grad"],
                  f"_flash {dtype} {name}: max |err| / max |ref| {e}")
            rel.append(f"{name} {e:.2e}")
        del out, grads, ref, rgrads
        # SDPA yardstick: forward + backward with the same boolean mask,
        # (B, H, S, hd) layout made outside the timing
        qs, ks, vs = (t.detach().transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        ds = dout.transpose(1, 2).contiguous()

        def sdpa_fb():
            o = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                               enable_gqa=True)
            return torch.autograd.grad(o, (qs, ks, vs), ds)

        def fwd():
            with torch.no_grad():
                return flash()

        def fb():
            return torch.autograd.grad(flash(), (q, k, v), dout)

        def dense_fb():
            return torch.autograd.grad(dense(), (q, k, v), dout)

        res = {}
        for name, fn in (("forward", fwd), ("forward + backward", fb),
                         ("dense forward + backward", dense_fb),
                         ("SDPA forward + backward", sdpa_fb)):
            res[name] = (timer.ms(fn, 5, warmup=1), peak_mb(torch, fn))
        log(f"_flash {dtype} (B={B} S={S} Hq={Hq} Hkv={Hkv} hd={hd}, causal): "
            f"forward max |err| {err:.3e} (atol {tol['atol']}, rtol "
            f"{tol['rtol']}), gradients max |err| / max |ref|: "
            f"{', '.join(rel)} (<= {tol['grad']})  ok; "
            + "; ".join(f"{n} {ms:.2f} ms, peak {mb:.0f} MB"
                        for n, (ms, mb) in res.items()) + f"  [{card}]")
        del q, k, v, qs, ks, vs
        torch.cuda.empty_cache()


class FlashSpy:
    """Counts the calls of ``layers._flash_attn_train`` (every full-
    sequence attention at 2048+ tokens) while active."""

    def __init__(self):
        from repro_torch.models import layers as L

        self.L = L
        self.real = L._flash_attn_train
        self.n = 0

    def __call__(self, *a, **kw):
        self.n += 1
        return self.real(*a, **kw)

    def __enter__(self):
        self.L._flash_attn_train = self
        return self

    def __exit__(self, *exc):
        self.L._flash_attn_train = self.real


def sync(torch, dev):
    if dev == "cuda":
        torch.cuda.synchronize()


def long_prompt_epochs(torch, np, card, cfg, eng, prompts, pids, epochs,
                       where, update_norm=0.0, dev="cuda"):
    """``epochs`` lock-step ``generate`` epochs of the long prompts
    (T = 0): the prefill through ``_flash`` once per layer, and on the
    card spec-verify once per attention layer per verify round (its kept
    launches held to the plain version). Returns each epoch's (outputs,
    stats) and the launches."""
    reset_launches()
    spy, flash = SvSpy(), FlashSpy()
    runs = []
    for ep in epochs:
        eng.begin_iteration(ep, update_norm)
        spy.new_epoch()
        sync(torch, dev)
        t0 = time.perf_counter()
        with spy, flash:
            outs, st = eng.generate(prompts, pids, max_new_tokens=64)
        sync(torch, dev)
        wall = time.perf_counter() - t0
        runs.append((outs, st))
        log(f"{where} epoch {ep + 1}: wall {wall * 1e3:.1f} ms, rounds "
            f"{st.n_rounds}, tokens {st.n_toks_emitted}, drafted "
            f"{st.n_drafted}, accepted {st.n_accepted}  [{card}]")
    launches = read_launches()
    n_attn = sum(k in ("attn", "local_attn") for k in cfg.layer_kinds)
    check(flash.n == n_attn * len(epochs),
          f"{where}: {flash.n} _flash calls, expected {n_attn} attention "
          f"layers x {len(epochs)} prefills")
    if dev == "cuda":
        check_sv_launches(cfg, launches,
                          sum(st.n_rounds for _, st in runs), where)
        spy.check(torch, card, where)
    log(f"{where}: {flash.n} _flash calls (one per attention layer per "
        f"prefill); launches {launches}")
    return runs, launches


def phase_rl_rollouts(torch, np, card, cfg, params, dev="cuda",
                      lens=(2100, 2200), tag="8b"):
    """8b: long-prompt rollouts, 4 rows over 2 problems (G = 2), prompts of
    2,100 and 2,200 seeded tokens, 64 new tokens, T = 0, lock-step, two
    epochs: epoch 2 equals epoch 1 and accepts drafts, the flat drafting
    kernel launched, every token plain greedy's choice."""
    from repro_torch.core.drafter import DrafterConfig, SuffixDrafter
    from repro_torch.core.spec_engine import EngineConfig, SpecEngine

    eng = SpecEngine(
        params, cfg,
        EngineConfig(max_draft=16, block_buckets=(16,), max_new_tokens=64,
                     eos_token=1),
        drafter=SuffixDrafter(DrafterConfig(scope="problem")),
        device=dev,
    )
    rng = np.random.default_rng(81)
    problems = [[int(t) for t in rng.integers(2, cfg.vocab_size, size=n)]
                for n in lens]
    prompts = [problems[i // 2] for i in range(4)]
    pids = [f"long{i // 2}" for i in range(4)]
    runs, launches = long_prompt_epochs(torch, np, card, cfg, eng, prompts,
                                        pids, (0, 1), f"{cfg.name} {tag}",
                                        dev=dev)
    (o1, _), (o2, s2) = runs
    check(o2 == o1, f"{tag}: epoch 2 outputs differ from epoch 1 (T=0)")
    check(s2.n_accepted > 0, f"{tag}: epoch 2 accepted no drafts")
    check(dev != "cuda" or launches["suffix_match_propose"] > 0,
          f"{tag}: the drafting kernel never launched")
    plain_greedy_full_width(torch, np, cfg, params, prompts,
                            {f"{tag} epoch 1": o1, f"{tag} epoch 2": o2},
                            card)
    return eng, prompts, pids, o1, launches


RGLRU_PARAMS = ("wx", "wy", "wo", "conv", "w_a", "w_i", "lam")


def check_layer_grads(cfg, grads, tag):
    """Every attention layer's wq/wk/wv gradient and every RG-LRU layer's
    gradient of each of its parameters is non-zero somewhere."""
    for li, kind in enumerate(cfg.layer_kinds):
        names = ([f"rglru.{w}" for w in RGLRU_PARAMS] if kind == "rglru"
                 else [f"attn.{w}" for w in ("wq", "wk", "wv")])
        for w in names:
            g = grads[f"layers.{li}.{w}"]
            check(bool((g != 0).any()), f"{tag}: layer {li} ({kind}) {w} "
                  "gradient is 0")


def scan_launch_delta(before, after):
    return (after["rglru_scan"] - before["rglru_scan"],
            after["rglru_scan_bwd"] - before["rglru_scan_bwd"])


def phase_rl_step(torch, np, card, cfg, params, prompts, outs,
                  dev="cuda", tag="8c", remat_check=False):
    """8c (9b for the hybrid): one GRPO step at S >= 2048 on the rollouts'
    epoch-1 batch, seeded non-zero advantages, ``old_logprobs`` from
    ``compute_old_logprobs``: the surrogate at ratio 1, finite gradients,
    non-zero ones in every attention layer's wq/wk/wv and every RG-LRU
    layer's parameters, one forward and one backward RG-LRU launch per
    recurrent layer (on the card), the update norm, and a lower surrogate
    after the step. With ``remat_check``, the loss and gradients again
    with ``GRPOConfig(remat=True)`` first: the same loss and gradients,
    two forward launches per recurrent layer. Returns the step's update
    norm and the launches from the start of the phase."""
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.rl import grpo
    from repro_torch.rl.rollout import pack_train_arrays

    n_rec = sum(k == "rglru" for k in cfg.layer_kinds)
    reset_launches()
    tokens, resp = pack_train_arrays(prompts, outs)
    adv = np.random.default_rng(82).normal(size=len(prompts)).astype(
        np.float32)
    check(bool((adv != 0).all()), f"{tag}: an advantage is 0")
    M.set_trainable(params)
    tok = torch.tensor(tokens, device=dev)
    batch = {"tokens": tok, "resp_mask": torch.tensor(resp, device=dev),
             "advantages": torch.tensor(adv, device=dev),
             "old_logprobs": grpo.compute_old_logprobs(params, cfg, tok)}
    ocfg = adamw.AdamWConfig(lr=STEP_LR)
    opt = adamw.init_state(params)
    gcfg = grpo.GRPOConfig()
    sync(torch, dev)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    before = read_launches()
    t0 = time.perf_counter()
    loss, _ = grpo.grpo_loss(params, cfg, gcfg, batch)
    grads = grpo.param_grads(params, loss)
    loss = float(loss.detach())
    sync(torch, dev)
    t_grad = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() / 2**30 if dev == "cuda"
            else float("nan"))
    fwd, bwd = scan_launch_delta(before, read_launches())
    check(dev != "cuda" or (fwd, bwd) == (n_rec, n_rec),
          f"{tag}: {fwd} forward and {bwd} backward RG-LRU launches in the "
          f"step, expected {n_rec} each (one per recurrent layer)")
    remat = ""
    if remat_check:
        before = read_launches()
        t0 = time.perf_counter()
        rloss, _ = grpo.grpo_loss(params, cfg,
                                  grpo.GRPOConfig(remat=True), batch)
        rgrads = grpo.param_grads(params, rloss)
        sync(torch, dev)
        t_remat = time.perf_counter() - t0
        rfwd, rbwd = scan_launch_delta(before, read_launches())
        check(dev != "cuda" or (rfwd, rbwd) == (2 * n_rec, n_rec),
              f"{tag} remat: {rfwd} forward and {rbwd} backward RG-LRU "
              f"launches, expected {2 * n_rec} and {n_rec}")
        rl = float(rloss.detach())
        check(rl == loss, f"{tag} remat: loss {rl} differs from {loss}")
        worst = max(float((rgrads[k].float() - g.float()).abs().max()
                          / g.float().abs().max().clamp(min=1e-30))
                    for k, g in grads.items())
        check(worst <= REMAT_GRAD_TOL, f"{tag} remat: gradients differ by "
              f"{worst:.3e} of their largest magnitude")
        del rgrads, rloss
        remat = (f"; with remat: the same loss, gradients within {worst:.2e} "
                 f"of their largest magnitude, {rfwd} forward / {rbwd} "
                 f"backward RG-LRU launches, {t_remat:.3f} s")
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt, om = adamw.apply_updates(ocfg, params, grads, opt)
    sync(torch, dev)
    t_step = t_grad + time.perf_counter() - t0
    if dev == "cuda":  # the step's peak: loss and gradients, or the update
        peak = max(peak, torch.cuda.max_memory_allocated() / 2**30)
    want = float(-(adv[:, None] * resp).sum() / resp.sum())
    check(abs(loss - want) <= SURROGATE_RTOL * abs(want),
          f"{tag}: surrogate {loss} at ratio 1, expected {want}")
    gn = float(om["grad_norm"])
    check(np.isfinite(gn) and gn > 0, f"{tag}: grad_norm {gn}")
    bad = [k for k, g in grads.items() if not bool(torch.isfinite(g).all())]
    check(not bad, f"{tag}: non-finite gradients in {bad[:4]}")
    check_layer_grads(cfg, grads, tag)
    lr = float(om["lr"])
    un_want = lr * min(1.0, ocfg.grad_clip / gn) * gn
    un = float(om["update_norm"])
    check(abs(un - un_want) <= 1e-5 * un_want,
          f"{tag}: update_norm {un}, expected lr*min(1, clip/gnorm)*gnorm "
          f"{un_want}")
    del grads
    with torch.no_grad():
        after, _ = grpo.grpo_loss(params, cfg, gcfg, batch)
    after = float(after)
    check(after < loss, f"{tag}: surrogate after the step {after} is not "
          f"below {loss}")
    B, S = tokens.shape
    log(f"{cfg.name} {tag} GRPO step (B={B}, S={S}, {int(resp.sum())} "
        f"response tokens, no remat): surrogate {loss:.6f} at ratio 1 "
        f"(expected {want:.6f}), after the step {after:.6f}; grad_norm "
        f"{gn:.4f}, lr {lr:g}, update_norm {un:.6f}; every gradient finite, "
        f"every attention layer's wq/wk/wv and every RG-LRU layer's "
        f"parameters' gradient non-zero; {fwd} forward / {bwd} backward "
        f"RG-LRU launches; loss + gradients {t_grad:.3f} s, with the AdamW "
        f"update {t_step:.3f} s, peak memory {peak:.2f} GiB{remat}  [{card}]")
    return un, read_launches()


def phase_rl_after_update(torch, np, card, cfg, params, eng, prompts, pids,
                          update_norm, dev="cuda"):
    """8d: the engine sees the update: a third epoch of 8b's traffic after
    ``set_params``, every token plain greedy's under the new weights."""
    eng.set_params(params)
    runs, launches = long_prompt_epochs(torch, np, card, cfg, eng, prompts,
                                        pids, (2,), f"{cfg.name} 8d",
                                        update_norm, dev)
    plain_greedy_full_width(torch, np, cfg, params, prompts,
                            {"8d epoch 3 (updated weights)": runs[0][0]},
                            card)
    return launches


def phase_trainer(torch, np, card, cfg=None, dev="cuda", tag="8e"):
    """8e (9c for the hybrid): ``Trainer.run`` end to end at full width:
    the pattern task (8 problems), 4 prompts a step, G = 2, 32 new tokens,
    4 SFT warmup steps then 4 GRPO steps at temperature 0.6, a checkpoint
    after step 2 into a temporary directory; a fresh trainer loaded from
    it resumes steps 3 and 4 token for token. On the card, every train
    step runs one backward RG-LRU launch per recurrent layer. Returns the
    launches of both runs."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.core.drafter import DrafterConfig
    from repro_torch.core.spec_engine import EngineConfig
    from repro_torch.data.tasks import PatternTask
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.rl.trainer import Trainer, TrainerConfig

    cfg = cfg or get_config("qwen2-1.5b")
    n_attn = sum(k in ("attn", "local_attn") for k in cfg.layer_kinds)
    n_rec = sum(k == "rglru" for k in cfg.layer_kinds)

    def trainer():
        return Trainer(
            cfg, PatternTask(n_problems=8),
            TrainerConfig(
                steps=4, prompts_per_step=4, group_size=2, max_new_tokens=32,
                temperature=0.6, seed=0, sft_warmup_steps=4, sft_lr=STEP_LR,
                optim=AdamWConfig(lr=STEP_LR, warmup_steps=2),
                engine=EngineConfig(max_draft=16, block_buckets=(16,),
                                    eos_token=1),
                drafter=DrafterConfig(scope="problem")),
            device=dev)

    def watch(tr, rolls, where):
        orig = tr.worker.rollout

        def wrapped(*a, **k):
            before = read_launches()
            batch = orig(*a, **k)
            after = read_launches()
            sv = (after["spec_verify_attention"]
                  - before["spec_verify_attention"])
            sm = (after["suffix_match_propose"]
                  - before["suffix_match_propose"])
            check(dev != "cuda" or sv == n_attn * batch.stats.n_rounds,
                  f"{where} rollout {len(rolls) + 1}: {sv} spec-verify "
                  f"launches, expected {n_attn} x {batch.stats.n_rounds}")
            # the first epoch has no history to draft from: from the
            # second on, every rollout drafts through the kernel
            if tr._epoch > 0 and dev == "cuda":
                check(sm > 0, f"{where} rollout {len(rolls) + 1} (epoch "
                      f"{tr._epoch + 1}) never launched the drafting kernel")
            rolls.append([list(r) for r in batch.responses])
            return batch

        tr.worker.rollout = wrapped

    def log_steps(hist, where):
        for h in hist:
            log(f"{where} step {h['step'] + 1} (epoch {h['epoch'] + 1}): "
                f"reward_mean {h['reward_mean']:.4f}, loss {h['loss']:.6f}, "
                f"grad_norm {h['grad_norm']:.4f}, accept_per_round "
                f"{h['accept_per_round']:.3f}, rollout {h['gen_time_s']:.3f} "
                f"s, train step {h['train_time_s']:.3f} s  [{card}]")

    reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        tr = trainer()
        rolls_a = []
        watch(tr, rolls_a, tag)
        t0 = time.perf_counter()
        tr.run(steps=2)  # the SFT warmup, then steps 1-2
        sft = tr.sft_losses
        log(f"{cfg.name} {tag} SFT warmup CE by step: "
            f"{', '.join(f'{x:.4f}' for x in sft)}; with steps 1-2 "
            f"{time.perf_counter() - t0:.1f} s  [{card}]")
        check(sft[-1] < sft[0], f"{tag}: SFT loss did not fall: {sft}")
        path = os.path.join(tmp, "step2.npz")
        t0 = time.perf_counter()
        tr.save_checkpoint(path)
        t_save = time.perf_counter() - t0
        n_roll = tr.engine.drafter.store.n_rollouts
        hist_a = tr.run(steps=4)
        tr.close()
        log_steps(hist_a, f"{cfg.name} {tag}")
        del tr
        if dev == "cuda":
            torch.cuda.empty_cache()
        tr = trainer()
        t0 = time.perf_counter()
        tr.load_checkpoint(path)
        sync(torch, dev)
        t_load = time.perf_counter() - t0
        size = os.path.getsize(path) / 2**30
    check(tr._step == 2, f"{tag}: the resumed trainer's cursor is {tr._step}")
    check(tr.engine.drafter.store.n_rollouts == n_roll,
          f"{tag}: the resumed drafter holds {tr.engine.drafter.store.n_rollouts}"
          f" rollouts, the checkpointed one {n_roll}")
    rolls_b = []
    watch(tr, rolls_b, f"{tag} resumed")
    hist_b = tr.run(steps=4)
    tr.close()
    log_steps(hist_b[2:], f"{cfg.name} {tag} resumed")
    check(len(rolls_a) == 4 and len(rolls_b) == 2,
          f"{tag}: {len(rolls_a)} and {len(rolls_b)} rollouts")
    check(rolls_b == rolls_a[2:],
          f"{tag}: the resumed steps' rollouts differ from the uninterrupted "
          "run")
    for a, b in zip(hist_a[2:], hist_b[2:]):
        check(a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"],
              f"{tag}: resumed step {a['step'] + 1}: loss {b['loss']} vs "
              f"{a['loss']}")
    log(f"{cfg.name} {tag} resume: checkpoint of {size:.2f} GiB saved in "
        f"{t_save:.1f} s, loaded in {t_load:.1f} s; cursor 2, drafter "
        f"{n_roll} rollouts restored; steps 3-4 token-identical at T=0.6 "
        f"({sum(len(r) for rs in rolls_b for r in rs)} tokens), losses "
        f"equal  [{card}]")
    launches = read_launches()
    steps = len(sft) + len(hist_a) + len(hist_b) - 2
    check(dev != "cuda" or launches["rglru_scan_bwd"] == n_rec * steps,
          f"{tag}: {launches['rglru_scan_bwd']} backward RG-LRU launches, "
          f"expected {n_rec} recurrent layers x {steps} train steps")
    return launches


def phase_rl(torch, np, timer, card):
    """Phase 8, the RL loop on the card; returns its launches (the
    spec-verify ones at the 12/2-head shape)."""
    phase_flash(torch, np, timer, card)
    t0 = time.perf_counter()
    cfg, params = full_width_model(torch, "qwen2-1.5b")
    eng, prompts, pids, outs, l8b = phase_rl_rollouts(torch, np, card, cfg,
                                                      params)
    un, _ = phase_rl_step(torch, np, card, cfg, params, prompts, outs)
    l8d = phase_rl_after_update(torch, np, card, cfg, params, eng, prompts,
                                pids, un)
    del eng, params
    torch.cuda.empty_cache()
    l8e = phase_trainer(torch, np, card)
    torch.cuda.empty_cache()
    total = Counter()
    for run in (l8b, l8d, l8e):
        total.update({k: v for k, v in run.items()
                      if k != "rglru_scan_by_shape"})
    check(total["rglru_scan"] == 0 and total["rglru_scan_bwd"] == 0 and
          total["suffix_match_propose_chunked"] == 0,
          f"phase 8 launched a kernel off its path: {dict(total)}")
    total["spec_verify_attention_qwen2"] = total.pop("spec_verify_attention")
    log(f"phase 8 (8b-8e) in {time.perf_counter() - t0:.1f} s; launches "
        f"{dict(total)}  [{card}]")
    return total


# ---------------------------------------------------------------------------
# phase 9: RecurrentGemma-9B training (published widths, depth cut)
# ---------------------------------------------------------------------------

# Bf16 weights and gradients with float32 moments (12 bytes a parameter:
# no master copy, the reference's rule) of all 38 layers take about 102
# GB, more than the card's 80: phase 9 keeps two (rglru, rglru,
# local_attn) triples, 2.23 B parameters, every width as published.
HYBRID_TRAIN_LAYERS = 6
# The GRPO step's sequence length in 9b (prompts of 2,100 and 2,200 tokens
# and 64 new ones, packed): the backward kernel's training shape.
TRAIN_S = 2272
# float32 operations a (b, t, w) step of the backward does: log a (2
# products), a and exp(2 log a) (2 exp, a product), 1 - e, the clip (2),
# the square root, the division, i·x, and the carry's chain (14 products
# and sums)
RGLRU_BWD_OPS_PER_STEP = 25
# (label, B, T, W, mask): the GRPO step's shape (no mask, as training
# runs it), the same with left pads, a ragged width and a width that is
# not a multiple of 4
RGLRU_BWD_CASES = [("train", 4, TRAIN_S, 4096, None),
                   ("train, left pads", 4, TRAIN_S, 4096, "left pads"),
                   ("ragged width", 3, 40, 4000, None),
                   ("odd width", 2, 33, 4001, "rows masked out")]
# dΛ sums B · T products a lane; the kernel repeats the plain version's
# order, and dΛ is held to this tolerance (its bits are reported)
RGLRU_DLAM_TOL = dict(atol=1e-5, rtol=1e-5)


def rglru_bwd_bytes(B, T, W, mask):
    """Bytes the backward's result depends on, and the updated steps: x,
    r, i and h_{t-1} at the updated steps, dhs at every step, dx, dr and di
    written at every step (32 bytes a (b, t, w) without a mask), h0,
    dh_final and dh0, Λ and dΛ once, and the mask."""
    kept = B * T if mask is None else int(mask.sum())
    nbytes = 4 * (4 * kept * W + 4 * B * T * W + 3 * B * W + 2 * W)
    if mask is not None:
        nbytes += mask.numel()
    return nbytes, kept


def rglru_bwd_bound_ms(B, T, W, mask):
    nbytes, kept = rglru_bwd_bytes(B, T, W, mask)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = RGLRU_BWD_OPS_PER_STEP * kept * W / PEAK_FLOPS["float32"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def rglru_long_launches(by_shape, long_t=2048):
    """The forward scan's launches at T >= 2048 (phase 9's training steps
    and long prefills), a part of ``rglru_launch_split``'s prefill count."""
    return sum(n for (_, t), n in by_shape.items() if t >= long_t)


def rglru_bwd_case(torch, np, timer, card, label, B, T, W, mk, seed):
    """One 9a case: the backward kernel against the plain version on the
    forward kernel's hs (dx, dr, di, dh0 bit for bit, dΛ within
    RGLRU_DLAM_TOL), then kernel, plain and bound times."""
    from repro_torch.kernels.rglru import ops as rg_ops
    from repro_torch.kernels.rglru.ref import rglru_scan_bwd_ref

    x, r, i, lam, h0 = rglru_inputs(torch, np, B, T, W, seed)
    mask = rglru_mask(torch, np, mk, B, T)
    hs, _ = rg_ops.rglru_scan_cuda(x, r, i, lam, h0, mask)
    rng = np.random.default_rng(seed + 1)
    dhs = torch.tensor(rng.normal(size=(B, T, W)), dtype=torch.float32,
                       device="cuda")
    dhf = torch.tensor(rng.normal(size=(B, W)), dtype=torch.float32,
                       device="cuda")
    args = (x, r, i, lam, h0, hs, dhs, dhf, mask)
    got = rg_ops.rglru_scan_bwd_cuda(*args)
    want = rglru_scan_bwd_ref(*args)
    torch.cuda.synchronize()
    err = 0.0
    where = f"rglru_scan_bwd {label} (B={B} T={T} W={W}, {mk})"
    for name, g, w in zip(("dx", "dr", "di", "dlam", "dh0"), got, want):
        check(bool(torch.isfinite(g).all()), f"{where} {name}: non-finite")
        e = float((g - w).abs().max())
        err = max(err, e)
        if name == "dlam":
            dlam_exact = torch.equal(g, w)
            check(torch.allclose(g, w, **RGLRU_DLAM_TOL),
                  f"{where} dlam: max |err| {e}")
        else:
            check(torch.equal(g, w), f"{where} {name}: not bit-identical to "
                  f"the plain version (max |err| {e})")
    ms = timer.ms(lambda: rg_ops.rglru_scan_bwd_cuda(*args), 20)
    plain_ms = timer.ms(lambda: rglru_scan_bwd_ref(*args), 2, warmup=1)
    bound_ms, bound_by = rglru_bwd_bound_ms(B, T, W, mask)
    log(f"{where}: dx, dr, di, dh0 bit-identical to the plain version, dΛ "
        f"{'bit-identical' if dlam_exact else 'within the tolerance'} (max "
        f"|err| {err:.3e}); kernel {ms * 1e3:.1f} us, plain "
        f"{plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.2f} us "
        f"({bound_by})  [{card}]")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def phase_rglru_bwd(torch, np, timer, card):
    """9a: the backward kernel at RGLRU_BWD_CASES after the timer's floor,
    and the forward kernel timed at the training shape. Returns the kernels
    JSON line's entries ``rglru_scan_bwd`` and ``rglru_scan_long`` (the
    forward at T >= 2048), launches set after phase 9."""
    timer_floor(torch, np, timer, card)
    res = {label: rglru_bwd_case(torch, np, timer, card, label, B, T, W, mk,
                                 90 + 4 * ci)
           for ci, (label, B, T, W, mk) in enumerate(RGLRU_BWD_CASES)}
    fwd = rglru_case(torch, np, timer, card, "train", 4, TRAIN_S, 4096,
                     None, 110)
    r = res["train"]
    common = dict(route="cuda", library_ms=None)
    return [dict(name="rglru_scan_bwd",
                 source="src/repro_torch/csrc/rglru_bwd.cu",
                 replaces="src/repro/models/layers.py:665",
                 max_abs_err=max(v["err"] for v in res.values()),
                 ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                 bound_by=r["bound_by"], **common),
            dict(name="rglru_scan_long", source="src/repro_torch/csrc/rglru.cu",
                 replaces="src/repro/kernels/rglru/kernel.py:64",
                 max_abs_err=fwd["err"], ms=fwd["ms"],
                 plain_ms=fwd["plain_ms"], bound_ms=fwd["bound_ms"],
                 bound_by=fwd["bound_by"], **common)]


def phase_hybrid_train(torch, np, timer, card):
    """Phase 9: 9a (the backward kernel), then RecurrentGemma-9B at its
    published widths cut to HYBRID_TRAIN_LAYERS layers: 9b, long-prompt
    rollouts (phase 8b's traffic) and one GRPO step at S >= 2048 on them,
    with the remat check; 9c, ``Trainer.run`` with a checkpoint and a
    token-identical resume. Returns the JSON entries of 9a, the launches
    of 9b and 9c and their forward scan launches by (B, T)."""
    entries = phase_rglru_bwd(torch, np, timer, card)
    t0 = time.perf_counter()
    cfg, params = full_width_model(torch, "recurrentgemma-9b",
                                   layers=HYBRID_TRAIN_LAYERS)
    eng, prompts, _, outs, l_roll = phase_rl_rollouts(
        torch, np, card, cfg, params, tag="9b")
    del eng
    _, l_step = phase_rl_step(torch, np, card, cfg, params, prompts, outs,
                              tag="9b", remat_check=True)
    del params
    torch.cuda.empty_cache()
    l_tr = phase_trainer(torch, np, card, cfg=cfg, tag="9c")
    torch.cuda.empty_cache()
    total, shapes = Counter(), Counter()
    for run in (l_roll, l_step, l_tr):
        total.update({k: v for k, v in run.items()
                      if k != "rglru_scan_by_shape"})
        shapes.update(run["rglru_scan_by_shape"])
    check(total["rglru_scan"] > 0 and total["rglru_scan_bwd"] > 0
          and total["suffix_match_propose"] > 0,
          f"phase 9 left a kernel of its path unlaunched: {dict(total)}")
    check(total["suffix_match_propose_chunked"] == 0,
          f"phase 9 launched the chunked kernel: {dict(total)}")
    total["spec_verify_attention_hd256"] = total.pop("spec_verify_attention")
    log(f"phase 9 (9b-9c, {cfg.num_layers} layers) in "
        f"{time.perf_counter() - t0:.1f} s; launches {dict(total)}; RG-LRU "
        f"forward launches by (B, T) {dict(shapes)}  [{card}]")
    return entries, total, shapes


def phase_cli(card):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    for mod, args in (
            ("serve", ["--arch", "qwen3-8b", "--scope", "problem",
                       "--rounds", "2"]),
            ("serve", ["--arch", "qwen2-1.5b", "--continuous"]),
            ("serve", ["--arch", "recurrentgemma-9b", "--rounds", "2"]),
            ("train", ["--arch", "qwen2-1.5b", "--steps", "2"]),
            ("train", ["--arch", "recurrentgemma-9b", "--steps", "2"])):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", f"repro_torch.launch.{mod}", "--smoke",
             *args], cwd=str(ROOT), env=env, capture_output=True, text=True,
            timeout=600)
        tail = (proc.stdout + proc.stderr).strip().splitlines()[-3:]
        check(proc.returncode == 0, f"{mod} CLI {' '.join(args)} exited "
              f"{proc.returncode}: {' | '.join(tail)}")
        log(f"{mod} CLI {' '.join(args)} ok in "
            f"{time.perf_counter() - t0:.1f} s [{card}]: {' | '.join(tail)}")


def main() -> None:
    if not (SRC / "repro_torch" / "__init__.py").exists():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the "
             "repository")
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: needs a CUDA card")
    # float32 products in full float32 (the plain references compare at 3e-5)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {kind} x{count}")

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    sources = ["spec_verify", "suffix_match", "rglru", "rglru_bwd"]
    _build.build_all(sources)
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc sm_90a, parallel)  "
        f"[{card}]")
    for name in sources:
        for ln in _build.ptxas_lines(name):
            log(f"  [{name}] {ln}")

    timer = Timer(torch)
    kernels = {k["name"]: k for k in (
        *phase_spec_verify(torch, np, timer, card),
        phase_suffix_match(torch, np, timer, card),
        phase_suffix_match_chunked(torch, np, timer, card),
        *phase_rglru(torch, np, timer, card))}
    # every path's launches of each kernel, each path counted from 0 (the
    # scan's also by (B, T))
    launches = Counter()
    rglru_shapes = Counter()

    def add(run, skip=()):
        launches.update({k: v for k, v in run.items()
                         if k not in skip and k != "rglru_scan_by_shape"})
        rglru_shapes.update(run["rglru_scan_by_shape"])

    cfg, params = full_width_model(torch, "qwen3-8b")
    lock, flat_spy, lock_runs = phase_main_path(torch, np, card, cfg, params)
    cont, chunked_spy = phase_continuous(torch, np, card, cfg, params)
    micro = phase_micro(torch, np, card, cfg, params, lock_runs)
    for run in (lock, cont["chunked"], cont["flat"], micro):
        add(run)
    # the drafting kernels at the path's own shapes (phases 4 and 5)
    for spy, name in ((flat_spy, "suffix_match_propose"),
                      (chunked_spy, "suffix_match_propose_chunked")):
        k = kernels[name]
        k["ms"], k["plain_ms"], k["bound_ms"] = time_path_case(
            torch, np, timer, card, spy, f"{cfg.name} path case")
    del timer, flat_spy, chunked_spy, params
    torch.cuda.empty_cache()
    # phase 7: RecurrentGemma-9B, whose main path runs the RG-LRU kernel
    # and spec-verify at head_dim 256 (lock-step and continuous runs)
    cfg, params = full_width_model(torch, "recurrentgemma-9b")
    hybrid, _, hybrid_runs = phase_main_path(torch, np, card, cfg, params)
    cont, _ = phase_continuous(torch, np, card, cfg, params,
                               layouts=("chunked",))
    hmicro = phase_micro(torch, np, card, cfg, params, hybrid_runs)
    for run in (hybrid, cont["chunked"], hmicro):
        add(run, skip=("spec_verify_attention",))
        launches["spec_verify_attention_hd256"] += run["spec_verify_attention"]
    del params
    torch.cuda.empty_cache()
    # the admission prefill shape phase 7's continuous run launched most,
    # timed as phase 3d
    admissions = Counter({bt: n for bt, n in
                          cont["chunked"]["rglru_scan_by_shape"].items()
                          if bt[1] != VERIFY_T})
    check(bool(admissions), "phase 7's continuous run prefilled nothing")
    (aB, aT), an = admissions.most_common(1)[0]
    log(f"RG-LRU launches by (B, T) in phase 7: {dict(rglru_shapes)}; "
        f"admission shape (B={aB}, T={aT}): {an} of the continuous run's "
        f"{sum(admissions.values())} prefill launches  [{card}]")
    timer = Timer(torch)
    rglru_case(torch, np, timer, card, "admission", aB, aT, cfg.rnn_width,
               "bucket pads", 80)
    del timer
    # phase 8: the RL loop on Qwen2-1.5B at its published config
    timer = Timer(torch)
    rl = phase_rl(torch, np, timer, card)
    del timer
    launches.update(rl)
    # phase 9: RecurrentGemma-9B training (the scan's backward kernel)
    timer = Timer(torch)
    entries, l9, shapes9 = phase_hybrid_train(torch, np, timer, card)
    del timer
    kernels.update({k["name"]: k for k in entries})
    launches.update(l9)
    rglru_shapes.update(shapes9)
    # the scan's launches by shape class (phases 7 and 9)
    verify_n, prefill_n = rglru_launch_split(rglru_shapes)
    long_n = rglru_long_launches(rglru_shapes)
    check(verify_n + prefill_n == launches["rglru_scan"],
          f"RG-LRU launches by shape ({verify_n} verify + {prefill_n} "
          f"prefill) differ from the total {launches['rglru_scan']}")
    log(f"RG-LRU forward launches: {verify_n} at the verify shape, "
        f"{prefill_n - long_n} prefills below T 2048, {long_n} at T >= 2048; "
        f"{launches['rglru_scan_bwd']} backward  [{card}]")
    kernels["rglru_scan"]["launches"] = verify_n
    kernels["rglru_scan_prefill"]["launches"] = prefill_n - long_n
    kernels["rglru_scan_long"]["launches"] = long_n
    for arch in ("qwen3-8b", "recurrentgemma-9b"):
        phase_small_reference(torch, np, arch)
    phase_cli(card)
    log(f"launches on every path: {dict(launches)}  [{card}]")
    kernels = list(kernels.values())
    for k in kernels:
        k.setdefault("launches", launches[k["name"]])
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"total {time.perf_counter() - t_start:.1f} s  [{card}]")
    log(card)
    log(json.dumps({"kernels": [{key: k[key] for key in order}
                                for k in kernels]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))


if __name__ == "__main__":
    main()
