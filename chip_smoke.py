#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the repository's sources next to this file; it
imports only ``repro_torch``, torch and numpy. Phases (any failure exits
non-zero; no phase's error is caught):

1. device: the card's name and power limit (nvidia-smi), torch's view;
2. build: the seven CUDA sources from ``src/repro_torch/csrc`` with nvcc
   for sm_90a, in parallel, with the ptxas register/shared-memory report;
3. kernels against their plain PyTorch versions at main-path shapes
   (spec-verify attention within the bfloat16 tolerance at Qwen3-8B's
   head shape, at RecurrentGemma-9B's (head_dim 256, MQA, window 2048)
   and at Qwen2-1.5B's (12/2 heads of 128, G = 6, phase 8b's ring of
   2,305 slots filled past 2,100), each at its path's cache fill and
   with the full ring,
   with its split plan and ptxas report, one call under the sync-debug
   mode "error", and bf16 edge cases (T = 1, rows that see nothing, one
   live split, hd 64 and 32, softcap, G = 6); the float32 kernel at
   edge cases within the float32 tolerance (a window with a softcap, T =
   1, rows that see nothing, hd 32 with G = 16, hd 64, hd 256 with a
   window and 16/1 heads, G = 6, G = 16, softcap 30, a ring of 20,000
   slots; head dims 24 and 40, which the wrapper zero-pads to 32 and
   64), its batch invariance bit for bit at 10b's shape (a B-8 launch
   against two B-4 launches and 17 T-1 launches; a row against redrawn
   other rows) and its timing at 10b's and 10c's shapes (path fill and a
   full ring: kernel, plain, SDPA, bound, plan and ptxas report); the
   bf16 kernel at phase 11's head layouts that no earlier path runs (B
   8, T 17, hd 128, phase 11's ring of 385 slots at its fill and full):
   ChatGLM3's 32/2 heads (G = 16: 272 query rows a kv head, three
   128-row CTAs), Command R+'s 96/8 (G = 12) and Arctic's 56/8 (G = 7),
   each with its plan, error and kernel / plain / SDPA / bound times,
   and at phase 12c's (B 4, T 1, SeamlessM4T-medium's 16/16 heads of
   64, G = 1, its ring of 97 slots);
   suffix-match flat and chunked (a warp a row, 33-way edge
   search from staged splitters) bit-identical, the chunked kernel also
   against the flat one over the same trees, at a forest larger than
   L2, and both at edge tables of 2^26 entries (their 64-bit search); 3d: the RG-LRU scan bit-identical (and within 1e-5) at
   RecurrentGemma-9B's verify shape (B 8, T 17, frozen rows masked), its
   prefill shape (B 8, T 256, left pads), the longest prompt (B 1, T
   2047), a ragged width and a width not a multiple of 4, after the
   timer's floor (an empty kernel); phase 7's most frequent admission
   shape follows phase 7); 3e: the xLSTM recurrences' four kernels
   (mLSTM and sLSTM, forward and backward) within ``XLSTM_TOL`` of their
   plain versions at ``XLSTM_CASES``: 12a's verify shape with staged
   states and with a committed carry (commit_upto from -1 to T + 4), its
   prefill shape with left pads, a training shape (B 16, T 256) forward
   and backward in bf16 and in float32, the float32 one's backward also
   held to ``torch.autograd.grad`` through the plain forward, the edges (a tie in the stabilizer's max, the first
   update from m = -inf, left pads and a frozen row, hd 64 and 40, T not
   a multiple of the checkpoint interval, 64 rows) and 13b's train_4k
   shape (B 16, T 4,096), each backward bit-identical from run to run;
   with kernel / plain /
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
   hybrid), last of all, started at once with 10d's;
7. RecurrentGemma-9B at full width on its first 14 layers
   (``HYBRID_SERVE_LAYERS``; the Qwen3-8B weights freed first): phase
   4's lock-step traffic, and again with R = 4 as in phase 4, then phase
   5's continuous traffic (chunked forest only), gated as there, with one RG-LRU launch
   per recurrent layer per forward and plain greedy's forwards run on
   the plain scan;
   then (phases 8 and 9, below) the RL loops; then the small float32 variants
   of Qwen3-8B and RecurrentGemma-9B: lock-step and continuous (chunked)
   output against plain greedy decoding without cache or kernels;
8. the RL loop on Qwen2-1.5B at its published config (28 layers,
   d_model 1536, 12/2 heads of 128, d_ff 8960, vocab 151,936, QKV bias,
   tied embeddings; random bf16 weights from seed 0):
   8a. the flash kernels (``csrc/flash_attn.cu``, forward and backward)
       against their plain version (``kernels/flash/ref.py``) within
       ``FLASH_TOL`` at ``FLASH_KERNEL_CASES`` (hd 64, 128, 256 and 96
       padded to 128; windows 0, 257, 2048; left pads and rows that see
       no key; lengths off the kernels' tiles) and at 8a's, phase 9's
       and 13c's own shapes as the layer pads them, in float32 and bf16,
       each backward bit-identical over two launches; the library's
       launch plans within the card's threads and shared memory;
       then ``_flash_attn_train`` at B 4, S 2304, 12/2 heads, hd 128,
       float32 and bf16, against autograd through plain dense attention
       (``FLASH_TOL``), timed (the layer's and the kernels' forward, the
       backward kernel, forward + backward) beside the plain version,
       dense attention and SDPA (the same boolean mask, and
       ``is_causal``), with each one's peak memory and the bound;
   8b. long-prompt rollouts: 4 rows over 2 problems (prompts of 2,100
       and 2,200 seeded tokens), 64 new tokens, T = 0, lock-step, two
       epochs: every prefill through ``_flash`` once per layer (one
       flash forward launch each, no backward),
       spec-verify once per attention layer per verify round (kept
       launches held to the plain version), epoch 2 equal to epoch 1
       and drafting, every token plain greedy's choice (0.25 logit);
   8c. one GRPO step at S >= 2048 on 8b's epoch-1 batch (seeded
       advantages, ``compute_old_logprobs``): the surrogate at ratio 1
       within ``SURROGATE_RTOL`` of -sum(adv*mask)/sum(mask), every
       gradient finite, every layer's wq/wk/wv gradient non-zero (the
       flash backward carries gradient), update_norm = lr * min(1,
       clip/gnorm) * gnorm, and a lower surrogate after the step; one
       flash forward launch a layer in ``compute_old_logprobs`` and one
       forward and one backward a layer in the step; its time and peak
       memory;
   8d. after ``set_params``, a third epoch of 8b's traffic, every token
       plain greedy's under the updated weights;
   8e. ``Trainer.run`` on the first 7 of the 28 layers
       (``TRAINER_LAYERS``): the pattern task (8 problems), 4 prompts a step,
       G = 2, 32 new tokens, 4 SFT warmup steps (the CE must fall) and 4
       GRPO steps at T = 0.6, spec-verify once per attention layer per
       round in every rollout and the drafting kernel in every rollout
       from the second epoch on (the first has no history); a
       checkpoint after step 2 into a temporary directory, from which a
       fresh trainer resumes with cursor 2 and the drafter's rollouts,
       and its steps 3-4 equal the uninterrupted run's token for token
       (the sidecar carries the generator's state) with equal losses;
9. RecurrentGemma-9B training at its published widths, depth cut to 3
   layers (one (rglru, rglru, local_attn) triple, 1.64 B parameters:
   all 38 layers' weights, gradients and moments would take ~102 GB):
   9a. the RG-LRU scan's backward kernel: its ptxas report and its
       resident CTAs a SM at the training shape (the occupancy query;
       one wave is the design's aim), then against its plain version on
       the forward kernel's hs at the GRPO step's shape (B 4, T 2272, W
       4096), with left pads, a ragged width and a width not a multiple
       of 4: dx, dr, di and dh0 bit for bit, dΛ within
       ``RGLRU_DLAM_TOL``; timed beside its bound after the timer's
       floor, and the forward timed at the training shape;
   9b. 8b's long-prompt rollouts and 8c's GRPO step on the cut hybrid:
       every RG-LRU parameter's gradient non-zero in every recurrent
       layer, one forward and one backward scan launch per recurrent
       layer in the step, one flash forward and one backward launch for
       its local-attention layer (hd 256, window 2048), and with remat
       the same loss and gradients with twice the forward launches;
   9c. 8e's ``Trainer.run`` on the cut hybrid (T = 0.6, checkpoint,
       token-identical resume), one backward launch per recurrent layer
       per train step;
10. telemetry and durability:
   10a. (right after phase 5, on its weights) phase 5's continuous
       traffic, chunked forest, with one ``obs.Telemetry`` (flight
       recorder on) and one ``RolloutJournal``: tokens, rounds and
       ``n_d2h``/``n_h2d`` equal to phase 5's chunked run (telemetry and
       the journal add no crossing), spec-verify and chunked-drafting
       launches equal to its, kept launches held to the plain versions,
       ``das_rounds_total`` and the token counters of the Prometheus text
       equal to the stats, the journal's sessions equal to the outputs,
       the exported trace valid, ``obs.attribute`` a component table per
       length class; the wall a round beside phase 5's and the journal's
       fsync times logged;
   10b. phase 5's epoch 1 with a journal and a ``DrainController`` (a
       virtual clock) requested by the caller once ``DRAIN_AFTER_ROUNDS``
       rounds ran: ``serve`` returns early with the journal fsynced; a
       fresh engine recovers it and runs ``generate_continuous(resume=
       ...)``; ``das_resumed_tokens_total`` equal to the salvaged tokens.
       Twice: in bf16 against phase 5's epoch 1, every journaled prefix
       equal to it and every resumed token within 0.25 logit of plain
       greedy's top (the shortfalls where an output departs from phase
       5's logged), then on the same weights cut to their first 6
       layers (``F32_RESUME_LAYERS``) and upcast to float32 against an
       uninterrupted float32 run, every prefix and output equal;
   10c. (after phase 8) ``Trainer.run`` on Qwen2-1.5B, its first 7 of
       28 layers (``MULTIWORKER_LAYERS``), with two workers
       over the in-process sharded history service, ``fault_tolerant``,
       journals and the flight recorder at T = 0 on 8e's task: a shard
       killed after its second publish (the supervisor restarts it),
       worker 1 stalled by its watchdog mid-slice and by ``FlakyWorker``
       on its first call, and a step-2 checkpoint with the shards' sidecar
       from which a fresh trainer runs step 3; spec-verify once per
       attention layer per verify round of every trainer, its kept
       launches held to the plain version, the flat drafting kernel's
       bit-identical over the remote packs; each slice timed. Twice: in
       float32, every step's responses and the resumed step 3 equal to
       the single-worker and the uninterrupted runs'; in bf16, every
       response token of the three runs within 0.25 logit of plain
       greedy's top under the weights it was sampled with (the shortfalls
       where they depart logged), and the engine spans of step 3 in the
       single- and the two-worker trainer;
   10d. (with phase 6) the serving CLI with ``--continuous
       --history-service --workers 2 --supervise --journal-dir D
       --trace-out D/trace.json``: exit 0, a valid trace, only finished
       journal sessions;
11. the remaining decoder families at their published widths (random
   bf16 weights from seed 0, one model on the card at a time), depth cut
   only where the model does not fit one card (``FAMILY_CASES``): 11a
   Yi-9B (48 layers), 11b ChatGLM3-6B (28; partial RoPE, QKV bias), 11c
   Command R+ (16 of 64; parallel blocks, LayerNorm, tied embeddings,
   vocab 256,000), 11d Qwen2-VL-2B's backbone (28; M-RoPE), 11e
   Mixtral-8x7B (16 of 32; 8 experts, top 2, window 4096), 11f
   Arctic-480B (2 of 35; 128 experts and a dense residual MLP). Each runs
   phase 4's lock-step traffic with limits of 32 and 64 new tokens (and
   Mixtral also 16 requests over 8 problems in 8 slots through
   ``SpecEngine.serve``, chunked forest, two epochs), gated as phase 4:
   the drafting kernel's kept launches bit-identical, spec-verify once
   per attention layer per verify round with its kept launches within
   the bf16 tolerance, epoch 2 accepting drafts. The dense families'
   epoch 2 equals epoch 1 and every token is plain greedy's within
   0.25 logit. The MoE families' witness is the layer: capacity dropping
   makes a token depend on the other tokens of its forward, so a spy on
   ``apply_moe`` keeps each epoch's first call and every 64th and
   replays them through the plain float32 layer (``moe_plain``): equal
   top-k experts, capacity slots and kept masks, outputs within
   ``MOE_TOL``; it logs the share of (token, k) pairs each path dropped.
   11d also runs a forward over stub embeddings (B 4, S 1,024, three
   position streams) held to the same forward on the weights upcast to
   float32, M-RoPE on text positions against standard RoPE bit for bit,
   and a GRPO step on that batch (the surrogate at ratio 1, finite
   gradients, the update norm, a lower surrogate after it);
12. the two families with no decoder-only attention stack:
   12a. xLSTM-125M whole (12 mLSTM/sLSTM layers, no attention, bf16):
       phase 4's lock-step traffic with limits 32 and 64 (flat forest)
       and 11e's continuous traffic (16 requests over 8 problems in 8
       slots, chunked forest), two epochs each: the drafting kernels'
       kept launches bit-identical, spec-verify exactly 0 launches (the
       count for a model with no attention layer, gated), epoch 2 equal
       to epoch 1 and accepting drafts; plain greedy's shortfalls by one
       batched full-sequence forward reported beside the same forward on
       the weights upcast to float32 (xLSTM amplifies a bf16 rounding
       past any logit tolerance: 12b is the exact witness); the wall a
       round and one verify forward's kernel launches (``torch.profiler``)
       and wall; one mLSTM or sLSTM kernel launch per layer of its kind
       per forward (gated, as in 12b);
   12b. the same lock-step traffic in float32 on the first 4 layers
       (``XLSTM_F32_LAYERS``): epoch 2 equal to epoch 1 and every token
       plain greedy's argmax (DAS's output identity, exact), and the
       staged states gathered at n_commit equal to a ``commit_upto``
       forward's committed carry bit for bit in every layer;
   12c. SeamlessM4T-medium (12 encoder and 12 decoder layers, d 1024,
       vocab 256,206, bf16): ``encode`` over 4 stub utterances of 1,024
       frames (one cut to 768), ``build_cross_cache``, a 32-token
       ``prefill`` and 64 greedy steps through the ring and the cross
       cache: spec-verify once per decoder layer a step, its kept
       launches within the bf16 tolerance of the plain version, the
       cached logits within ``TOL_LOGIT_BF16`` of a full
       ``forward(enc_out=)`` over the same tokens and every token within
       it of that forward's top; then on the first 2 encoder and decoder
       layers upcast to float32, every token the full forward's argmax.
13. the launch tooling's workloads on the card, beside the dry run's
   count of the same work on the one card's mesh (``launch.dryrun``:
   meta tensors, NVIDIA H100 data-sheet peaks; counted in a process
   started with the script, ``start_p13_counts``):
   13a. (right after phase 5, on its Qwen3-8B weights, every earlier
       cache freed) the paper's economics: ``workloads.make_decode_fn``'s
       decode_32k and verify_8 steps at B 8 (the per-device share of 128
       over the 16-way data axis) on the workloads' cache layout, 33,024
       slots at ``SLOT_MULTIPLE`` 256, filled with seeded K/V, every slot
       valid, lengths 32,768: layer 0's spec-verify launch at this ring,
       on V that lights one lane a hd-th of the ring, within ``SV_TOL``
       of the plain version, which moves by more than 10 x its atol
       without the split plan's middle split or with it twice; the verify
       step's next tokens equal ``verify_block`` on the same forward's
       logits and its lengths advance by 1 + accepted; each step's time
       (CUDA events, median of ``P13_REPS``), its kernels' device time
       (``torch.profiler``) and peak memory beside its floor (weights and
       ring read once, the counted FLOPs) and the counted eager traffic's
       t_compute, t_memory and peak_memory; the measured verify/decode
       ratio beside the counted one; spec-verify once per layer a step;
   13b. (after phase 12) one GRPO + AdamW step
       (``workloads.make_train_fn``: group 8, remat, lr 3e-4) of
       xLSTM-125M at its published config, B 16, train_4k's own S 4,096
       (``XLSTM_TRAIN_S``), each mLSTM and sLSTM layer two forward
       launches (remat) and one backward (gated):
       the loss at ratio 1 within ``SURROGATE_RTOL``
       of its closed form, every gradient finite and non-zero somewhere,
       every parameter moved; the step's time (the first at the shape,
       then a second, warm) and peak memory beside its floor (weights,
       gradients and AdamW moments each moved once, the counted FLOPs)
       and the counted eager traffic and peak;
   13c. the same for SeamlessM4T-medium (12 + 12 layers) at B 12 (B 16
       does not fit the card: ``SEAMLESS_TRAIN_BATCH``), S 4,096, stub
       ``enc_embeds`` of 1,024 frames, each decoder self-attention layer
       two flash forward launches (remat) and one backward (gated);
   13d. (with phase 6) the dry run's CLIs: ``launch.dryrun --arch
       qwen3-8b --shape verify_8``, ``launch.train --arch xlstm-125m
       --dry-run``, ``launch.serve --arch qwen3-8b --dry-run --shape
       verify_8`` and ``launch.hillclimb --pair C``, each exit 0 with a
       record that parses.
14. the paper's RL run through the port's entry points' own configs
   (``examples/torch_rl_math.py`` and ``torch_rl_code.py``, float32):
   14a. (after 13b-c) rl_math at the 100m preset (12 layers, d_model 768,
       12/4 heads of 64, d_ff 2048) at T 0: one trainer runs the SFT
       warmup (``P14_SFT`` steps: the example's 10 leave no EOS), whose
       weights every arm loads (a fresh GRPO optimizer, an empty drafter,
       one generator seed each): the plain arm (``--no-das``), the
       example's DAS arm (scope ``problem+request``: per-row host
       drafting, as in the reference) and a DAS arm with scope
       ``problem`` (drafting through the flat kernel), ``P14_STEPS``
       GRPO steps each in turns. Gates: the SFT CE falls; every rollout
       token-identical across the arms with equal rewards, ``loss`` and
       ``grad_norm`` within rtol 1e-5; fewer forwards with DAS from the
       second rollout on; some rollout ends in EOS; one prefill and one
       spec-verify launch per attention layer per verify round in every
       rollout (the plain arm's all at T 1), its kept launches within the
       float32 tolerance; the drafting kernel in every rollout of the
       scope-``problem`` arm from its second epoch on, bit-identical to
       its plain version, and never in the others. Logged per step and
       arm: rollout and train time, forwards, accepted per round, J under
       the default ``LatencyModel``, lengths, EOS share, budgets by length
       class, reward, loss, grad norm; the rollout times summed and their
       ratios;
   14b. the same preset at the example's T 0.6, plain and DAS from 14a's
       SFT weights: finite losses, a non-zero grad norm in each arm, the
       launch gates; the reward curves and rollout times side by side;
   14c. rl_code's own config (3 layers, d_model 128, 4/2 heads of 32) at
       T 0, plain and DAS: 14a's identity and launch gates;
   and (with phase 6's CLIs) ``examples/torch_quickstart.py`` (prints
   ``LOSSLESS``) and ``torch_serve_spec.py --rounds 3``.

The last lines are the card line, the per-kernel JSON line and the
result line ``{"ok": true, "device": {...}}``. A kernel's ``launches``
there sum every path that runs it, each counted from 0 (flat drafting:
phases 4 and 7 (R = 1 and R = 4), phase 5's flat run and phases 8, 9
and 10c; chunked drafting: phase 5's and phase 7's chunked runs and
phases 10a and 10b; spec-verify at hd 128: phases 4, 5, 10a, 10b and 13a
in bf16; at hd 256 and the RG-LRU scan: phases 7 and 9; at Qwen2-1.5B's
shape, ``spec_verify_attention_qwen2``: phases 8 and 10c in bf16; the
float32 instantiation has entries of its own, timed at the shape its
run launched most (kept launches, cycled): ``spec_verify_attention_f32``
at Qwen3-8B's (10b) and ``spec_verify_attention_qwen2_f32`` at Qwen2-
1.5B's (10c); the scan's backward: phase 9; each phase-11 family's
spec-verify launches have an entry of their own, timed on that run's
kept launches: ``spec_verify_attention_{yi,chatglm3,command_r,
qwen2_vl,mixtral,arctic}``, and so have 12c's bf16 and float32 runs,
``spec_verify_attention_seamless`` and ``..._seamless_f32``, and phase
14's float32 runs, ``spec_verify_attention_rl100m_f32`` (14a and 14b)
and ``..._rlcode_f32`` (14c); the drafting kernels count phases 11, 12
and 14's launches too; the xLSTM kernels: ``mlstm_scan`` and
``slstm_scan`` phases 12a and 12b, timed at 12a's verify shape,
``..._scan_train`` and ``..._scan_bwd`` 13b's step, timed at its shape
in 3e); the drafting
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
import copy
import gc
import json
import os
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

SV_TOL = {"bfloat16": dict(atol=3e-2, rtol=1e-2),
          "float32": dict(atol=3e-5, rtol=1e-2)}
# Timed calls of a plain version that takes tens to hundreds of
# milliseconds (drafting, the scans): each was just run once to be
# compared, so no warm-up; its time is a yardstick, not a gate.
PLAIN_SLOW_REPS = 2


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


def roofline_ms(nbytes, flops, dtype="bfloat16"):
    """(ms, "bytes" or "operations"): the least time to move ``nbytes``
    once and do ``flops`` operations in ``dtype``, the larger of the two
    at the card's data-sheet peaks (``launch.mesh``)."""
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS

    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sv_bound_ms(np, args, window, dtype):
    """Least time for the same work: each valid K/V slot, q, positions
    and cache_pos read once, the output written once; flops of QK and PV
    over the visible (row, slot) pairs only. The kernel's ``work`` counts
    every slot valid and visible; the slots this run's cache_pos leaves
    out are taken off it."""
    from repro_torch.kernels.spec_verify import ops as sv_ops

    q, k, _, cpos, pos = args
    B, T, Hq, hd = q.shape
    S1, Hkv = k.shape[1], k.shape[2]
    esz = q.element_size()
    cp = cpos.cpu().numpy()
    qp = pos.cpu().numpy()
    every_flops, every_bytes = sv_ops.work(B, T, Hq, Hkv, S1, hd, esz)
    invalid_slots = int((cp < 0).sum())
    nbytes = every_bytes - 2 * invalid_slots * Hkv * hd * esz
    vis = (cp[:, None, :] >= 0) & (cp[:, None, :] <= qp[:, :, None])
    if window > 0:
        vis &= cp[:, None, :] > qp[:, :, None] - window
    return roofline_ms(nbytes, every_flops * int(vis.sum()) / vis.size,
                       dtype)


def sv_plan_line(torch, B, T, Hq, Hkv, hd, S1, dtype="bfloat16"):
    """A kernel's split plan for a shape (``split_plan`` in bf16,
    ``f32_split_plan`` in float32), and the ptxas report of the
    instantiation it launches (registers, shared memory, spills)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.spec_verify import ops as sv_ops

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    f32 = dtype == "float32"
    hd = sv_ops.padded_head_dim(hd)  # the head dim the launch runs at
    plan = (sv_ops.f32_split_plan if f32 else sv_ops.split_plan)(
        B, T, Hq, Hkv, S1, hd, n_sm)
    TG = T * (Hq // Hkv)
    part_mb = plan.partial_floats(B, Hkv, TG, hd) * 4 / 1e6
    kv_mb = 2 * B * S1 * Hkv * hd * (4 if f32 else 2) / 1e6
    inst = (f"spec_verify_f32_kernelILi{hd}ELi{plan.tile}E" if f32 else
            f"spec_verify_tc_kernelILi{max(hd, 64)}ELi{plan.tile}E")
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


# Edge cases held against the plain version: (label, B, T, Hq, Hkv, hd,
# S+1, window, softcap, cache lengths [lo, hi) (hi None: a full ring),
# seed, dtype)
SV_EDGE_CASES = [
    ("T=1", 8, 1, 32, 8, 128, 577, 0, 0.0, (128, 560), 31, "bfloat16"),
    ("rows that see nothing", 4, 5, 8, 2, 128, 300, 0, 0.0, (20, 290), 32,
     "bfloat16"),
    ("every split but one empty", 8, 17, 16, 1, 256, 2113, 2048, 0.0,
     (1, 16), 33, "bfloat16"),
    ("hd 64", 2, 9, 8, 2, 64, 257, 0, 0.0, (1, 240), 34, "bfloat16"),
    ("hd 32", 1, 2, 16, 1, 32, 70, 0, 0.0, (1, 60), 35, "bfloat16"),
    ("softcap 30", 2, 17, 8, 4, 128, 513, 0, 30.0, (1, 490), 36, "bfloat16"),
    ("G=6, window 100", 2, 4, 12, 2, 64, 300, 100, 0.0, (1, 290), 37,
     "bfloat16"),
    ("window 48, softcap 30", 2, 5, 8, 2, 64, 130, 48, 30.0, (20, None), 1,
     "float32"),
    ("T=1", 8, 1, 32, 8, 128, 577, 0, 0.0, (128, 560), 41, "float32"),
    ("rows that see nothing", 4, 5, 8, 2, 128, 300, 0, 0.0, (20, 290), 42,
     "float32"),
    ("hd 32, G=16", 1, 2, 16, 1, 32, 70, 0, 0.0, (1, 60), 43, "float32"),
    ("hd 64", 2, 9, 8, 2, 64, 257, 0, 0.0, (1, 240), 44, "float32"),
    ("hd 256, window 160, 16/1 heads", 2, 5, 16, 1, 256, 300, 160, 0.0,
     (100, None), 2, "float32"),
    ("hd 256, window 2048, 16/1 heads, every split but one empty", 8, 17,
     16, 1, 256, 2113, 2048, 0.0, (1, 16), 45, "float32"),
    ("G=6, window 100", 2, 4, 12, 2, 64, 300, 100, 0.0, (1, 290), 46,
     "float32"),
    ("G=16", 2, 17, 16, 1, 128, 577, 0, 0.0, (100, 560), 47, "float32"),
    ("softcap 30", 2, 17, 8, 4, 128, 513, 0, 30.0, (1, 490), 48, "float32"),
    ("ring of 20,000 slots", 1, 17, 32, 8, 128, 20000, 0, 0.0, (15000, None),
     49, "float32"),
    # head dims the wrapper zero-pads to the next built one: the
    # quickstart's 4/2 heads of 24 and the 10m preset's 8/4 heads of 40
    ("hd 24 padded to 32, 4/2 heads", 2, 1, 4, 2, 24, 129, 0, 0.0, (1, 100),
     50, "float32"),
    ("hd 40 padded to 64, 8/4 heads", 2, 9, 8, 4, 40, 257, 0, 0.0, (1, 240),
     51, "float32"),
    ("hd 24 padded to 32, 4/2 heads", 2, 5, 4, 2, 24, 129, 0, 0.0, (1, 100),
     52, "bfloat16"),
]


def phase_sv_edge_cases(torch, np, card):
    """Every ``SV_EDGE_CASES`` row against the plain version within its
    type's tolerance; returns the largest error of each type."""
    from repro_torch.kernels.spec_verify import ops as sv_ops
    from repro_torch.kernels.spec_verify.ref import spec_verify_attention_ref

    worst = {"bfloat16": 0.0, "float32": 0.0}
    for (label, B, T, Hq, Hkv, hd, S1, window, softcap, (lo, hi), seed,
         dtype) in SV_EDGE_CASES:
        args = sv_inputs(torch, np, B, T, Hq, Hkv, hd, S1, dtype, seed, lo,
                         hi)
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
        what = f"spec_verify {dtype} {label}"
        check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
        err = float((got.float() - want.float()).abs().max())
        check(torch.allclose(got.float(), want.float(), **SV_TOL[dtype]),
              f"{what}: max |err| {err}")
        for b, t in blind:
            check(bool((got[b, t] == 0).all()),
                  f"{what}: a row that sees nothing is not 0")
        worst[dtype] = max(worst[dtype], err)
        log(f"spec_verify {dtype} edge case {label} (B={B} T={T} Hq={Hq} "
            f"Hkv={Hkv} hd={hd} S+1={S1} window={window} softcap={softcap}, "
            f"lengths [{lo}, {S1 - 1 - T if hi is None else hi})): max |err| "
            f"{err:.3e}  ok; "
            f"{sv_plan_line(torch, B, T, Hq, Hkv, hd, S1, dtype)}  [{card}]")
    return worst


def phase_sv_invariance(torch, np, card):
    """The float32 kernel's batch invariance, bit for bit, at 10b's shape
    (B 8, T 17, 32/8 heads, hd 128, S+1 577, the path's fill): a B-8 launch
    equals the same rows launched as two B-4 launches and as T = 1 launches
    of each query; and a row's output is unchanged when the other queries
    and positions of its batch are redrawn."""
    from repro_torch.kernels.spec_verify import ops as sv_ops

    B, T, Hq, Hkv, hd, S1 = 8, 17, 32, 8, 128, 577
    run = sv_ops.spec_verify_attention_cuda
    q, k, v, cpos, pos = sv_inputs(torch, np, B, T, Hq, Hkv, hd, S1,
                                   "float32", 60, *SV_PATH_FILL)
    full = run(q, k, v, cpos, pos)
    halves = torch.cat([run(q[i:i + 4], k[i:i + 4], v[i:i + 4],
                            cpos[i:i + 4], pos[i:i + 4]) for i in (0, 4)])
    singles = torch.cat([run(q[:, t:t + 1].contiguous(), k, v, cpos,
                             pos[:, t:t + 1].contiguous())
                         for t in range(T)], dim=1)
    rng = np.random.default_rng(61)
    q2, pos2 = q.clone(), pos.clone()
    q2[:, 1:] = torch.from_numpy(rng.normal(size=(B, T - 1, Hq, hd)).astype(
        np.float32)).cuda()
    pos2[:, 1:] = pos[:, 1:].flip(1) - 7
    redrawn = run(q2, k, v, cpos, pos2)
    torch.cuda.synchronize()
    check(torch.equal(full, halves), "spec_verify float32: a B-8 launch "
          "differs from the same rows as two B-4 launches")
    check(torch.equal(full, singles), "spec_verify float32: a T-17 launch "
          "differs from the same queries launched one at a time")
    check(torch.equal(full[:, 0], redrawn[:, 0]), "spec_verify float32: a "
          "row's output moved when the other rows were redrawn")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    plans = {(b, t): sv_ops.f32_split_plan(b, t, Hq, Hkv, S1, hd, n_sm)
             for b, t in ((8, 17), (4, 17), (8, 1))}
    log("spec_verify float32 batch invariance at (B=8 T=17 Hq=32 Hkv=8 "
        "hd=128 S+1=577): bit-identical as two B-4 launches, as 17 T-1 "
        "launches and with the other rows redrawn; row blocks x rows "
        + ", ".join(f"{p.row_blocks} x {p.cta_rows} at (B {b}, T {t})"
                    for (b, t), p in plans.items())
        + f", the same {plans[8, 17].n_split} splits  [{card}]")


def phase_spec_verify(torch, np, timer, card):
    """Phase 3a: the edge cases of both kernels, the float32 kernel's
    batch invariance and its shapes, then the bf16 main-path shapes.
    Returns the bf16 JSON entries and the largest float32 error."""
    edge_err = phase_sv_edge_cases(torch, np, card)
    phase_sv_invariance(torch, np, card)
    # float32 at the shapes 10b's and 10c's float32 runs launch: Qwen3-8B's
    # (B 8, T 17, GQA 32/8, S+1 577) at the path's fill and with a full
    # ring, Qwen2-1.5B's (B 4, T 17, GQA 12/2: 102 query rows a kv head,
    # S+1 129) with short prompts and with a full ring (logged; the JSON
    # entries are timed on the runs' own launches)
    f32_err = edge_err["float32"]
    for B, Hq, Hkv, S1, min_len, fill in (
            (8, 32, 8, 577, 128, SV_PATH_FILL),
            (4, 12, 2, 129, 8, SV_QWEN2_F32_FILL)):
        e = sv_main_shape(torch, np, timer, card, B, 17, Hq, Hkv, 128, S1,
                          S1, 0, min_len, fill, "float32")
        f32_err = max(f32_err, e["max_abs_err"])

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
        e["max_abs_err"] = max(e["max_abs_err"], edge_err["bfloat16"])
        entries.append(dict(name=name, **e))
    # phase 11's head layouts that no earlier path runs, at its batch, ring
    # (S+1 = 385: prompts of up to 256 tokens, 64 generated, 16 drafts)
    # and fill, and with a full ring: ChatGLM3's 32/2 (G = 16: 272 query
    # rows a kv head at T 17), Command R+'s 96/8 (G = 12) and Arctic's 56/8
    # (G = 7); their largest errors go to phase 11's entries
    family_err = {}
    for name, Hq, Hkv in (("spec_verify_attention_chatglm3", 32, 2),
                          ("spec_verify_attention_command_r", 96, 8),
                          ("spec_verify_attention_arctic", 56, 8)):
        e = sv_main_shape(torch, np, timer, card, 8, 17, Hq, Hkv, 128,
                          SV_FAMILY_RING, SV_FAMILY_RING, 0, 128,
                          SV_FAMILY_FILL)
        family_err[name] = max(e["max_abs_err"], edge_err["bfloat16"])
    # phase 12c's layout, which no earlier path runs: SeamlessM4T-medium's
    # decoder self-attention, 16/16 heads of 64 (G = 1), one query a row
    # (greedy decode, T 1) at B 4, its ring of 96 (+1) slots filled by the
    # 32-token prompt and up to 64 steps
    e = sv_main_shape(torch, np, timer, card, 4, 1, 16, 16, 64,
                      SEAMLESS_RING, SEAMLESS_RING, 0, SEAMLESS_PROMPT,
                      (SEAMLESS_PROMPT, SEAMLESS_RING - 1))
    family_err["spec_verify_attention_seamless"] = max(
        e["max_abs_err"], edge_err["bfloat16"])
    return entries, f32_err, family_err


# The path's fill: prompts of 128-256 tokens and up to 256 generated
# (phases 4, 5 and 7), so a block's first position lies in [128, 512].
SV_PATH_FILL = (128, 513)
# Phase 8b's fill: prompts of 2,100 and 2,200 tokens and up to 64
# generated, so a block's first position lies in [2100, 2264].
SV_LONG_FILL = (2100, 2265)
# Phase 11's ring and fill: prompts of 128-256 tokens, up to 64 generated
# and 16 drafted (a cache of 384 slots), so a block's first position lies
# in [128, 320].
SV_FAMILY_RING = 385
SV_FAMILY_FILL = (128, 321)
# 10c's fill: the pattern task's short prompts and 32 generated tokens in
# a ring of 128 (+1) slots.
SV_QWEN2_F32_FILL = (8, 80)


def sv_sdpa_call(torch, copies, window):
    """The library yardstick: one SDPA call with the same boolean mask on
    each of ``copies`` (``sv_inputs``-shaped argument tuples) in turn;
    never called by the port."""
    import torch.nn.functional as F

    Hq, Hkv = copies[0][0].shape[2], copies[0][1].shape[2]
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

    return lib_call


def time_sv_path_case(torch, np, timer, card, spy, name, where,
                      err_3a=0.0):
    """A spec-verify JSON entry at a path's own shape: the kernel, plain
    and SDPA times over the launches ``spy`` kept of the shape it kept
    most (cycled, so nothing stays warm), the bound on them, and the
    largest error of every kept launch against the plain version (and of
    phase 3a's launches of that type, ``err_3a``)."""
    from repro_torch.kernels.spec_verify import ops as sv_ops
    from repro_torch.kernels.spec_verify.ref import spec_verify_attention_ref

    copies = [c[:5] for c in spy.case]
    kw = spy.case[0][5]
    window = kw.get("window", 0)
    it = {"i": 0}

    def nxt():
        it["i"] += 1
        return copies[it["i"] % len(copies)]

    ms = timer.ms(lambda: sv_ops.spec_verify_attention_cuda(*nxt(), **kw), 50)
    plain_ms = timer.ms(lambda: spec_verify_attention_ref(*nxt(), **kw), 10)
    library_ms = timer.ms(sv_sdpa_call(torch, copies, window), 50)
    dtype = str(copies[0][0].dtype).replace("torch.", "")
    bound_ms, bound_by = sv_bound_ms(np, copies[0], window, dtype)
    q, k = copies[0][0], copies[0][1]
    log(f"{where} path case ({dtype}, q {tuple(q.shape)}, cache "
        f"{tuple(k.shape)}, window {window}; {len(copies)} kept launches "
        f"cycled): kernel {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, "
        f"SDPA {library_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.2f} us "
        f"({bound_by})  [{card}]")
    return dict(name=name, route="cuda",
                source="src/repro_torch/csrc/spec_verify.cu",
                replaces="src/repro/kernels/spec_verify/kernel.py:103",
                max_abs_err=max(spy.worst, err_3a), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def sv_main_shape(torch, np, timer, card, B, T, Hq, Hkv, hd, S1_path,
                  S1_full, window, min_len, path_fill=SV_PATH_FILL,
                  dtype="bfloat16"):
    """One main-path shape (bf16 unless ``dtype``) at the path's ring
    (S+1 = ``S1_path``) and fill (``path_fill``) and with a full ring of
    ``S1_full`` slots (lengths from ``min_len``): the kernel against the
    plain version,
    then kernel, plain, SDPA and bound times (the full ring's kernel
    time also without the timer's lead, once). The path fill's numbers
    are returned; the full ring's are logged."""
    from repro_torch.kernels.spec_verify import ops as sv_ops
    from repro_torch.kernels.spec_verify.ref import spec_verify_attention_ref

    res = {}
    for fill, S1, (lo, hi), seed in (
            ("path fill", S1_path, path_fill, 20),
            ("full ring", S1_full, (min_len, None), 10)):
        log(f"spec_verify {dtype} hd={hd} S+1={S1} "
            f"{sv_plan_line(torch, B, T, Hq, Hkv, hd, S1, dtype)}  [{card}]")
        copies = [sv_inputs(torch, np, B, T, Hq, Hkv, hd, S1, dtype,
                            seed + i, lo, hi) for i in range(4)]
        args = copies[0]
        got = sv_ops.spec_verify_attention_cuda(*args, window=window)
        want = spec_verify_attention_ref(*args, window=window)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()),
              f"spec_verify {dtype}: non-finite output")
        err = float((got.float() - want.float()).abs().max())
        check(torch.allclose(got.float(), want.float(), **SV_TOL[dtype]),
              f"spec_verify {dtype} hd={hd} {fill}: max |err| {err}")
        cp = args[3].cpu().numpy()
        log(f"spec_verify {dtype} (B={B} T={T} Hq={Hq} Hkv={Hkv} hd={hd} "
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
            log(f"spec_verify {dtype} hd={hd}: one call under "
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
        lib_call = sv_sdpa_call(torch, copies, window)
        library_ms = timer.ms(lib_call, 50)
        bound_ms, bound_by = sv_bound_ms(np, args, window, dtype)
        extra = ""
        if fill == "full ring":  # the timer's lead, on and off, once
            extra = (f"; without the timer's lead: kernel "
                     f"{timer.ms(kern, 50, lead=False) * 1e3:.1f} us, SDPA "
                     f"{timer.ms(lib_call, 50, lead=False) * 1e3:.1f} us")
        log(f"spec_verify {dtype} hd={hd} {fill} timing: kernel {ms * 1e3:.1f} "
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
    from repro_torch.launch.mesh import HBM_BW

    B = tails.shape[0]
    nbytes = 4 * (entries + n_query + 2 * B + B * n_prop_max)
    return nbytes / HBM_BW * 1e3, entries


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
        *args, *forest, n_prop_max=K, min_match=1), PLAIN_SLOW_REPS,
        warmup=0)
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
        *args, *cf, **kw), PLAIN_SLOW_REPS, warmup=0)
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


# The verify block's T on the main path: its one K bucket (16) + the head.
VERIFY_T = 17


def rglru_bytes(B, T, W, mask, skip_masked=True):
    """Bytes the scan's result depends on, and the steps it updates: x, r
    and i at the updated steps (at every step with ``skip_masked`` False,
    the count before the kernel skipped masked steps), hs written once,
    h0, Λ, h_final and the (B, T) mask once: the kernel's ``work`` (every
    step updated) less x, r and i at the steps this mask skips."""
    from repro_torch.kernels.rglru import ops as rg_ops

    kept = B * T if mask is None or not skip_masked else int(mask.sum())
    every = rg_ops.work(B, T, W, mask is not None)[1]
    return int(every) - 4 * 3 * (B * T - kept) * W, kept


def rglru_bound_ms(x, mask, skip_masked=True):
    """Least time for the same work, the larger of: ``rglru_bytes`` at the
    HBM rate; the scan's float32 operations at the updated steps at the
    card's float32 rate. Returns (ms, which bounds it)."""
    from repro_torch.kernels.rglru import ops as rg_ops

    B, T, W = x.shape
    nbytes, kept = rglru_bytes(B, T, W, mask, skip_masked)
    return roofline_ms(nbytes, rg_ops.OPS_PER_STEP * kept * W, "float32")


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
    plain_ms = timer.ms(lambda: rglru_scan_ref(*nxt(), mask),
                        PLAIN_SLOW_REPS, warmup=0)
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
# phase 3e: the xLSTM recurrences (mLSTM and sLSTM), forward and backward
# ---------------------------------------------------------------------------

# Gates: max |kernel - plain| over the finite entries, divided by max(1,
# max |plain|) (non-finite entries, the -inf of a fresh stabilizer, equal).
# The kernels and the plain versions round every state update alike; they
# part in the order of their sums (the mLSTM's read over hd rows, the
# sLSTM's h R, the backwards' adjoint sums over columns and (t, b)), a few
# float32 ulps a step that the recurrence carries over T.
XLSTM_TOL = {"fwd": 1e-4, "bwd": 1e-3}
XLSTM_HEADS, XLSTM_HD = 4, 192  # xLSTM-125M's heads
XLSTM_LONG_T = 2048  # launches at T >= this are the training entries'
# (tag, B, T, head dim, dtype, state, masks, commit_upto?, collect, the
# backward's checkpoint interval or None for the forward alone)
XLSTM_CASES = [
    ("verify", 8, VERIFY_T, XLSTM_HD, "bfloat16", "carried", "frozen row",
     False, True, None),
    ("commit", 8, VERIFY_T, XLSTM_HD, "bfloat16", "carried", "frozen row",
     True, False, None),
    ("prefill", 8, 256, XLSTM_HD, "bfloat16", "fresh", "left pads", False,
     False, None),
    ("train", 16, 256, XLSTM_HD, "bfloat16", "fresh", None, False, False,
     64),
    ("train_f32", 16, 256, XLSTM_HD, "float32", "carried", "left pads",
     False, False, 64),
    ("edges", 3, 37, 64, "float32", "tie", "left pads + frozen row", False,
     False, 5),
    ("ragged", 2, 9, 40, "float32", "fresh", None, False, False, 4),
    ("rows", 64, 40, XLSTM_HD, "float32", "carried", "left pads", False,
     False, 16),
    ("train_4k", 16, 4096, XLSTM_HD, "bfloat16", "fresh", None, False,
     False, 64),
]
# the case whose backward kernels are also held to torch.autograd.grad
# through the plain forward loops, at XLSTM_TOL["bwd"]: full width, K 64,
# float32 (autograd through the bf16 products rounds their adjoints to
# bf16, 2^-8 of the scale, where the kernels keep them in float32)
XLSTM_AUTOGRAD_CASE = "train_f32"


def xl_err(torch, g, w, what):
    """(max |g - w|, that over max(1, max |w|)) over w's finite entries;
    the non-finite entries must be equal."""
    fin = torch.isfinite(w)
    check(torch.equal(fin, torch.isfinite(g)), f"{what}: non-finite entries "
          "differ")
    check(torch.equal(g[~fin], w[~fin]), f"{what}: non-finite values differ")
    if not bool(fin.any()):
        return 0.0, 0.0
    d = float((g[fin].double() - w[fin].double()).abs().max())
    return d, d / max(1.0, float(w[fin].abs().max()))


def xl_masks(torch, np, rng, kind, B, T, dev):
    if kind is None:
        return None
    upd = np.ones((T, B), bool)
    if "left pads" in kind:
        for b in range(B):
            upd[:rng.integers(0, max(1, T // 2)), b] = False
    if "frozen row" in kind:
        upd[:, B - 1] = False
    return torch.from_numpy(upd).to(dev)


def xl_commit(torch, B, T, upd, dev):
    """commit_upto per row (0, inside, T and past both ends), as
    ``_gate_masks`` turns it into the committed mask."""
    upto = torch.tensor([(-1, 0, 1, T // 2, T - 1, T, T + 4, 3)[b % 8]
                         for b in range(B)], device=dev)
    t = torch.arange(T, device=dev)[:, None]
    return upd & (t < upto[None, :])


def mlstm_inputs(torch, np, B, T, hd, dtype, state, masks, seed, dev="cuda",
                 H=XLSTM_HEADS):
    """Seeded mLSTM scan inputs: (q, k, v, i_pre, f_pre, C0, n0, m0, upd).
    ``state`` "fresh" (m at -inf), "carried" or "tie" (m0 0.5 and step 0's
    i equal to log σ(30) + 0.5 = 0.5 exactly: a tie in the stabilizer's
    max)."""
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)

    def t(a, d=torch.float32):
        return torch.tensor(np.asarray(a, np.float32), device=dev).to(d)

    q = t(rng.normal(size=(T, B, H, hd)), dt)
    k = t(rng.normal(size=(T, B, H, hd)) / np.sqrt(hd), dt)
    v = t(rng.normal(size=(T, B, H, hd)), dt)
    i_pre = t(rng.normal(size=(T, B, H)))
    f_pre = t(rng.normal(3.0, 1.5, size=(T, B, H)))
    if state == "fresh":
        C0 = t(np.zeros((B, H, hd, hd)))
        n0 = t(np.zeros((B, H, hd)))
        m0 = t(np.full((B, H), -np.inf))
    else:
        C0 = t(rng.normal(size=(B, H, hd, hd)) * 0.3)
        n0 = t(rng.normal(size=(B, H, hd)) * 0.3)
        m0 = t(rng.normal(size=(B, H)))
    if state == "tie":
        m0 = t(np.full((B, H), 0.5))
        f_pre[0] = 30.0
        i_pre[0] = 0.5
    upd = xl_masks(torch, np, rng, masks, B, T, dev)
    return (q, k, v, i_pre, f_pre, C0, n0, m0, upd)


def slstm_inputs(torch, np, B, T, hd, state, masks, seed, dev="cuda",
                 H=XLSTM_HEADS):
    """Seeded sLSTM scan inputs: (z_in, i_in, f_in, o_sig, R, cnh0, m0,
    upd), float32, head-major; ``state`` as ``mlstm_inputs``'."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    z_in = t(rng.normal(size=(T, H, B, hd)))
    i_in = t(rng.normal(size=(T, H, B, hd)))
    f_in = t(rng.normal(2.0, 1.5, size=(T, H, B, hd)))
    o_sig = t(1 / (1 + np.exp(-rng.normal(size=(T, H, B, hd)))))
    R = t(rng.normal(size=(H, hd, hd)) * 0.2 / np.sqrt(hd))
    if state == "fresh":
        cnh0 = t(np.zeros((3, H, B, hd)))
        m0 = t(np.full((H, B, hd), -np.inf))
    else:
        cnh0 = t(np.abs(rng.normal(size=(3, H, B, hd))))
        m0 = t(rng.normal(size=(H, B, hd)))
    if state == "tie":
        m0 = t(np.full((H, B, hd), 0.5))
        f_in[0] = 30.0
        i_in[0] = 0.5
    upd = xl_masks(torch, np, rng, masks, B, T, dev)
    return (z_in, i_in, f_in, o_sig, R, cnh0, m0, upd)


def xl_compare(torch, names, got, want, what, tol):
    """The gate over output tuples; returns the largest absolute error and
    the largest error over its output's scale."""
    worst = worst_rel = 0.0
    for name, g, w in zip(names, got, want):
        check(tuple(g.shape) == tuple(w.shape), f"{what} {name}: shape "
              f"{tuple(g.shape)}, plain {tuple(w.shape)}")
        d, rel = xl_err(torch, g.float(), w.float(), f"{what} {name}")
        check(rel <= tol, f"{what} {name}: max |err| {d:.3e} ({rel:.3e} of "
              f"the scale) > {tol}")
        worst, worst_rel = max(worst, d), max(worst_rel, rel)
    return worst, worst_rel


def xl_case(torch, np, timer, card, block, case, seed, time_it=False,
            dev="cuda"):
    """One 3e case of ``block`` ("mlstm" or "slstm"): the forward kernel
    against the plain version (h, the state out or the staged states, and
    with a checkpoint interval the checkpoints it keeps), then the
    backward kernel against the plain reverse walk on the forward
    kernel's saved tensors and seeded cotangents, twice (bit-identical).
    With ``time_it`` the kernels, the plain versions and the bounds are
    timed. With ``dev="cpu"`` the wrappers run their plain versions (a
    rehearsal of the plumbing)."""
    from repro_torch.kernels.xlstm import ops as xo
    from repro_torch.kernels.xlstm import ref as xr

    tag, B, T, hd, dtype, state, masks, commit, collect, K = case
    what = (f"{block}_scan {tag} (B={B} T={T} H={XLSTM_HEADS} hd={hd} "
            f"{dtype}, {state} state, {masks or 'no mask'}"
            f"{', commit_upto' if commit else ''}"
            f"{', collect' if collect else ''}{f', K={K}' if K else ''})")
    if block == "mlstm":
        args = mlstm_inputs(torch, np, B, T, hd, dtype, state, masks, seed,
                            dev)
        fwd_k, fwd_p = xo.mlstm_scan_fwd, xr.mlstm_scan_ref
        names = ("h", "[C|n]", "m")
    else:
        args = slstm_inputs(torch, np, B, T, hd, state, masks, seed, dev)
        fwd_k, fwd_p = xo.slstm_scan_fwd, xr.slstm_scan_ref
        names = ("hs", "[c,n,h]", "m")
    upd = args[-1]
    com = None
    if commit:
        com = xl_commit(torch, B, T, (upd if upd is not None else
                                      torch.ones((T, B), dtype=torch.bool,
                                                 device=dev)), dev)
    got = fwd_k(*args, com=com, collect=collect, ckpt_every=K)
    kept = {}

    def plain():
        kept["out"] = fwd_p(*args, com=com, collect=collect, ckpt_every=K)

    # the training shape's plain run is timed cold, once (seconds); the
    # verify shape's after a warm-up
    plain_ms = (timer.ms(plain, 1 if T > 1024 else PLAIN_SLOW_REPS,
                         warmup=0 if T > 1024 else 1)
                if time_it else plain())
    want = kept.pop("out")
    sync(torch, dev)
    err, rel = xl_compare(torch, names, got[:3], want[:3], what,
                          XLSTM_TOL["fwd"])
    if K:
        saved_k = got[3] if block == "mlstm" else (got[3],)
        saved_p = want[3] if block == "mlstm" else (want[3],)
        e2, r2 = xl_compare(torch, ("ckpt", "mck", "q.n")[:len(saved_k)],
                            saved_k, saved_p, what + " saved",
                            XLSTM_TOL["fwd"])
        err, rel = max(err, e2), max(rel, r2)
    out = dict(err=err, bwd_err=None)
    fl, nb = (xo.mlstm_work(T, B, XLSTM_HEADS, hd, 2 if dtype == "bfloat16"
                            else 4, collect, K) if block == "mlstm" else
              xo.slstm_work(T, B, XLSTM_HEADS, hd, collect, K))
    if time_it:
        out["ms"] = timer.ms(lambda: fwd_k(*args, com=com, collect=collect,
                                           ckpt_every=K), 5 if T > 1024
                             else 30)
        out["plain_ms"] = plain_ms
        out["bound_ms"], out["bound_by"] = roofline_ms(nb, fl, "float32")
    line = (f"{what}: forward within {XLSTM_TOL['fwd']} of the plain "
            f"version (max |err| {err:.3e}, {rel:.2e} of the scale)")
    if K:
        rng = np.random.default_rng(seed + 7)

        def cot(shape):
            return torch.tensor(rng.normal(size=shape).astype(np.float32),
                                device=dev)

        if block == "mlstm":
            q, k, v, i_pre, f_pre = args[:5]
            h, cn, m, (ck, mck, s) = got
            bargs = (q, k, v, i_pre, f_pre, upd, h, s, ck, mck, K,
                     cot(h.shape), cot(cn.shape), cot(m.shape))
            bk, bp = xo.mlstm_scan_bwd, xr.mlstm_scan_bwd_ref
            bnames = ("dq", "dk", "dv", "di", "df", "dC0", "dn0", "dm0")
            bfl, bnb = xo.mlstm_bwd_work(T, B, XLSTM_HEADS, hd,
                                         2 if dtype == "bfloat16" else 4, K)
        else:
            z_in, i_in, f_in, o_sig, R, cnh0 = args[:6]
            hs, cnh, m, ck = got
            bargs = (z_in, i_in, f_in, o_sig, R, cnh0[2].contiguous(), upd,
                     hs, ck, K, cot(hs.shape), cot(cnh.shape), cot(m.shape))
            bk, bp = xo.slstm_scan_bwd, xr.slstm_scan_bwd_ref
            bnames = ("dz", "di", "df", "do", "dR", "dcnh0", "dm0")
            bfl, bnb = xo.slstm_bwd_work(T, B, XLSTM_HEADS, hd, K)
        gb = bk(*bargs)

        def bplain():
            kept["out"] = bp(*bargs)

        bplain_ms = timer.ms(bplain, 1, warmup=0) if time_it else bplain()
        wb = kept.pop("out")
        sync(torch, dev)
        out["bwd_err"], brel = xl_compare(torch, bnames, gb, wb,
                                          what + " backward", XLSTM_TOL["bwd"])
        again = bk(*bargs)
        sync(torch, dev)
        check(all(torch.equal(a, b) for a, b in zip(gb, again)),
              f"{what} backward: two launches differ (not deterministic)")
        line += (f"; backward within {XLSTM_TOL['bwd']} (max |err| "
                 f"{out['bwd_err']:.3e}, {brel:.2e} of the scale), "
                 "bit-identical from run to run")
        if tag == XLSTM_AUTOGRAD_CASE:
            # a witness independent of the walk's design: autograd through
            # the plain forward loops on the same inputs and cotangents
            leaves = [a.clone().requires_grad_(True) for a in args[:-1]]
            with torch.enable_grad():
                wa = torch.autograd.grad(fwd_p(*leaves, upd), leaves,
                                         bargs[-3:], allow_unused=True)
            wa = [torch.zeros_like(x) if w is None else w
                  for x, w in zip(leaves, wa)]
            sync(torch, dev)
            aerr, arel = xl_compare(torch, bnames, gb, wa,
                                    what + " backward against autograd",
                                    XLSTM_TOL["bwd"])
            out["autograd_err"] = aerr
            line += (f"; against torch.autograd.grad through the plain "
                     f"forward within {XLSTM_TOL['bwd']} (max |err| "
                     f"{aerr:.3e}, {arel:.2e} of the scale)")
            del leaves, wa
        if time_it:
            out["bwd_ms"] = timer.ms(lambda: bk(*bargs), 3 if T > 1024
                                     else 10)
            out["bwd_plain_ms"] = bplain_ms
            out["bwd_bound_ms"], out["bwd_bound_by"] = roofline_ms(
                bnb, bfl, "float32")
    if time_it:
        line += (f"; forward kernel {out['ms']:.3f} ms, plain "
                 f"{out['plain_ms']:.3f} ms, bound {out['bound_ms']:.4f} ms "
                 f"({out['bound_by']})")
        if K:
            line += (f"; backward kernel {out['bwd_ms']:.3f} ms, plain "
                     f"{out['bwd_plain_ms']:.3f} ms, bound "
                     f"{out['bwd_bound_ms']:.4f} ms ({out['bwd_bound_by']})")
    log(f"{line}  [{card}]")
    return out


def phase_xlstm_kernels(torch, np, timer, card):
    """Phase 3e: both recurrences' kernels at ``XLSTM_CASES`` (12a's
    verify shape with staged states and with a committed carry, its
    prefill shape, a training shape at full width with the backward,
    the edges: a tie in the stabilizer's max from a carried m, the first
    update from m = -inf, left pads and a frozen row, a head dim whose
    columns do not fill the last CTA, T not a multiple of the checkpoint
    interval, 64 rows (two a sLSTM CTA), and 13b's train_4k shape, timed).
    Returns the kernels JSON line's six entries (launches set later)."""
    from repro_torch.kernels import _build

    for name in ("mlstm", "slstm"):
        for ln in _build.ptxas_lines(name):
            log(f"  [{name}] {ln}")
    entries = []
    t0 = time.perf_counter()
    for block, line in (("mlstm", 844), ("slstm", 930)):
        res = {c[0]: xl_case(torch, np, timer, card, block, c, 300 + 7 * i,
                             time_it=c[0] in ("verify", "train_4k"))
               for i, c in enumerate(XLSTM_CASES)}
        common = dict(route="cuda", library_ms=None,
                      source=f"src/repro_torch/csrc/{block}.cu",
                      replaces=f"src/repro/models/layers.py:{line}")
        fwd_err = max(r["err"] for r in res.values())
        bwd_err = max(r["bwd_err"] for r in res.values()
                      if r["bwd_err"] is not None)
        v, tr = res["verify"], res["train_4k"]
        entries += [
            dict(name=f"{block}_scan", max_abs_err=fwd_err, ms=v["ms"],
                 plain_ms=v["plain_ms"], bound_ms=v["bound_ms"],
                 bound_by=v["bound_by"], **common),
            dict(name=f"{block}_scan_train", max_abs_err=fwd_err,
                 ms=tr["ms"], plain_ms=tr["plain_ms"],
                 bound_ms=tr["bound_ms"], bound_by=tr["bound_by"], **common),
            dict(name=f"{block}_scan_bwd", max_abs_err=bwd_err,
                 ms=tr["bwd_ms"], plain_ms=tr["bwd_plain_ms"],
                 bound_ms=tr["bwd_bound_ms"], bound_by=tr["bwd_bound_by"],
                 **common)]
        torch.cuda.empty_cache()
    log(f"phase 3e: {time.perf_counter() - t0:.1f} s  [{card}]")
    return entries


def check_xlstm_launches(cfg, launches, n_fwd, where):
    """One mLSTM launch per mLSTM layer and one sLSTM launch per sLSTM
    layer per forward (prefills and verify rounds alike), none for a model
    without them."""
    for block in ("mlstm", "slstm"):
        n_layers = sum(k == block for k in cfg.layer_kinds)
        got = launches[f"{block}_scan"] + launches[f"{block}_scan_train"]
        check(got == n_layers * n_fwd,
              f"{where}: {got} {block} launches, expected {n_layers} layers"
              f" x {n_fwd} forwards")


# ---------------------------------------------------------------------------
# phase 4: the lock-step path at full width
# ---------------------------------------------------------------------------

def reset_launches():
    from repro_torch.kernels.rglru import ops as rg_ops
    from repro_torch.kernels.spec_verify import ops as sv_ops
    from repro_torch.kernels.suffix_match import ops as sm_ops

    reset_flash_launches()
    sv_ops.LAUNCHES = 0
    sm_ops.LAUNCHES = 0
    sm_ops.LAUNCHES_CHUNKED = 0
    rg_ops.LAUNCHES = 0
    rg_ops.LAUNCHES_BY_SHAPE.clear()
    rg_ops.BWD_LAUNCHES = 0
    reset_xlstm_launches()


def reset_xlstm_launches():
    from repro_torch.kernels.xlstm import ops as xo

    xo.MLSTM_LAUNCHES = xo.MLSTM_BWD_LAUNCHES = 0
    xo.SLSTM_LAUNCHES = xo.SLSTM_BWD_LAUNCHES = 0
    xo.MLSTM_LAUNCHES_BY_SHAPE.clear()
    xo.SLSTM_LAUNCHES_BY_SHAPE.clear()


def reset_flash_launches():
    from repro_torch.kernels.flash import ops as fl_ops

    fl_ops.FWD_LAUNCHES = fl_ops.BWD_LAUNCHES = 0


def read_flash_launches():
    from repro_torch.kernels.flash import ops as fl_ops

    return {"flash_attn_fwd": fl_ops.FWD_LAUNCHES,
            "flash_attn_bwd": fl_ops.BWD_LAUNCHES}


def read_xlstm_launches():
    """The xLSTM kernels' launches under their JSON entries' names: the
    forwards split at ``XLSTM_LONG_T`` (serving below, training at and
    above it)."""
    from repro_torch.kernels.xlstm import ops as xo

    out = {}
    for block, n, by, bwd in (
            ("mlstm", xo.MLSTM_LAUNCHES, xo.MLSTM_LAUNCHES_BY_SHAPE,
             xo.MLSTM_BWD_LAUNCHES),
            ("slstm", xo.SLSTM_LAUNCHES, xo.SLSTM_LAUNCHES_BY_SHAPE,
             xo.SLSTM_BWD_LAUNCHES)):
        long_n = sum(c for (_, t), c in by.items() if t >= XLSTM_LONG_T)
        out.update({f"{block}_scan": n - long_n, f"{block}_scan_train": long_n,
                    f"{block}_scan_bwd": bwd})
    return out


def read_launches():
    from repro_torch.kernels.rglru import ops as rg_ops
    from repro_torch.kernels.spec_verify import ops as sv_ops
    from repro_torch.kernels.suffix_match import ops as sm_ops

    return {"spec_verify_attention": sv_ops.LAUNCHES,
            **read_flash_launches(),
            "suffix_match_propose": sm_ops.LAUNCHES,
            "suffix_match_propose_chunked": sm_ops.LAUNCHES_CHUNKED,
            "rglru_scan": rg_ops.LAUNCHES,
            "rglru_scan_by_shape": Counter(rg_ops.LAUNCHES_BY_SHAPE),
            "rglru_scan_bwd": rg_ops.BWD_LAUNCHES, **read_xlstm_launches()}


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


def has_attention(cfg):
    return any(k in ("attn", "local_attn") for k in cfg.layer_kinds)


def check_sv_spy(torch, card, cfg, spy, where):
    """Holds a run's kept spec-verify launches to the plain version; a
    model with no attention layer (xLSTM) must have launched none, a gate
    stated rather than skipped (its count, 0, is ``check_sv_launches``')."""
    if has_attention(cfg):
        spy.check(torch, card, where)
        return
    check(spy.n == 0, f"{where}: spec-verify launched {spy.n} times in a "
          "model with no attention layer")
    log(f"{where}: spec-verify launched 0 times, as a model with no "
        f"attention layer must  [{card}]")


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
    version after the run, outside its timing, and counts every launch by
    its block's T (``by_t``). Adds no launch. After
    ``check``, ``case`` holds up to four kept launches of the shape kept
    most (``time_sv_path_case``) and ``worst`` the largest error."""

    EVERY = 64

    def __init__(self):
        from repro_torch.kernels.spec_verify import ops as sv_ops

        self.ops = sv_ops
        self.real = sv_ops.spec_verify_attention_cuda
        self.kept = []
        self.n = 0
        self.by_t = Counter()  # launches by the block's T
        self.first = True

    def new_epoch(self):
        self.first = True

    def __call__(self, q, k, v, cache_pos, positions, **kw):
        out = self.real(q, k, v, cache_pos, positions, **kw)
        self.by_t[q.shape[1]] += 1
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
        by_shape = {}
        for q, k, v, cpos, pos, got, kw in self.kept:
            want = spec_verify_attention_ref(q, k, v, cpos, pos, **kw)
            err = float((got.float() - want.float()).abs().max())
            tol = SV_TOL[str(q.dtype).replace("torch.", "")]
            check(bool(torch.isfinite(got).all()) and torch.allclose(
                got.float(), want.float(), **tol),
                f"{where}: a kept spec-verify launch differs from the plain "
                f"version, max |err| {err}")
            worst = max(worst, err)
            sig = (tuple(q.shape), tuple(k.shape), kw.get("window", 0))
            shapes.add(sig)
            by_shape.setdefault(sig, []).append((q, k, v, cpos, pos, kw))
        # the path case: the last four kept launches of the shape kept most
        self.case = max(by_shape.values(), key=len)[-4:]
        self.worst = worst
        log(f"{where}: {len(self.kept)} of {self.n} spec-verify launches kept "
            f"(each epoch's first, every {self.EVERY}th), within the "
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
    plain_ms = timer.ms(lambda: spy.plain(forest, *q, **kw),
                        PLAIN_SLOW_REPS, warmup=0)
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


def lockstep_requests(np, vocab, prompt_len=(128, 256)):
    """Phase 4's requests: 8 over 4 problems, seeded prompts of
    ``prompt_len`` (128-256) tokens."""
    rng = np.random.default_rng(1)
    lo, hi = prompt_len
    problems = [[int(t) for t in rng.integers(2, vocab,
                                              size=int(rng.integers(lo, hi + 1)))]
                for _ in range(4)]
    return [problems[i // 2] for i in range(8)], [f"p{i // 2}"
                                                  for i in range(8)]


# Depth cuts of earlier paths that make room for phases 11 and 12 inside
# the script's time (widths stay the published ones): 10b's float32 drain
# and resume on the first 6 of Qwen3-8B's 36 layers, phase 7 on the first
# 14 of RecurrentGemma-9B's 38 (its lock-step runs at R = 1 and R = 4
# took ~57 s of a slow host's 1,175 s at all 38), 10c's trainers on 7 of
# Qwen2-1.5B's 28 (8a-8d keep all 28), and phase 9
# (``HYBRID_TRAIN_LAYERS``).
F32_RESUME_LAYERS = 6
HYBRID_SERVE_LAYERS = 14
MULTIWORKER_LAYERS = 7
# 8e's ``Trainer.run`` (and its checkpoint resume) on the first 7 of
# Qwen2-1.5B's 28 layers, to make room for phase 13: its checkpoint is
# 5.23 GiB instead of 14.38, whose save and load took ~50 s on an NVIDIA
# H100 80GB HBM3 host (700 W); 8a-8d keep 28
TRAINER_LAYERS = 7


def cut_depth(torch, params, cfg, n):
    """Keeps the first ``n`` layers of a model, in place (the others'
    memory goes back to the allocator); returns the cut config. The
    layers' kinds are the block pattern tiled, so the first ``n`` layers
    are ``cfg.replace(num_layers=n)``'s."""
    from torch import nn

    params.layers = nn.ModuleList(list(params.layers)[:n])
    params.cfg = cfg = cfg.replace(num_layers=n)
    gc.collect()
    torch.cuda.empty_cache()
    return cfg


def phase_main_path(torch, np, card, cfg, params, micro_rounds=1,
                    limits=(32, 64, 128, 256), dev="cuda", sv_spy=None,
                    spies=(), tag="", prompt_len=(128, 256)):
    """Phase 4's lock-step traffic (phase 7's for the hybrid, phase 11's
    with ``limits`` (32, 64)), with up to ``micro_rounds`` fused rounds a
    dispatch: 8 requests over 4 problems (prompts of ``prompt_len``
    tokens), token limits cycling through ``limits`` a problem. Epoch 2
    must equal epoch 1, but for an MoE model, whose capacity makes a token
    depend on the other tokens of its forward. ``sv_spy`` (an ``SvSpy``, kept by the
    caller for timing) and ``spies`` (each with ``new_epoch``) wrap the
    run. The kernel gates hold on the card (``dev``). Returns the
    launches, the flat suffix-match spy and each epoch's (outputs, stats,
    wall s)."""
    from repro_torch.core.drafter import DrafterConfig, SuffixDrafter
    from repro_torch.core.spec_engine import EngineConfig, SpecEngine
    from repro_torch.models import model as M

    # One K bucket (16): every verify round runs the same (8, 17) block
    # shape, so the GEMMs of both epochs use the same kernels and T=0
    # identity across epochs does not rest on cuBLAS picking the same
    # kernel for two shapes.
    eng = SpecEngine(
        params, cfg,
        EngineConfig(max_draft=16, block_buckets=(16,),
                     max_new_tokens=max(limits), eos_token=1,
                     fuse_rounds="auto", micro_rounds=micro_rounds),
        drafter=SuffixDrafter(DrafterConfig(scope="problem")),
        device=dev,
    )
    where = (f"{tag} " if tag else "") + f"{cfg.name} lock-step" + (
        f" R={micro_rounds}" if micro_rounds > 1 else "")
    prompts, pids = lockstep_requests(np, cfg.vocab_size, prompt_len)
    max_new = [limits[(i // 2) % len(limits)] for i in range(8)]

    # the prefill's logits at full width are finite and of the right shape
    Tp = 256
    toks = torch.zeros((8, Tp), dtype=torch.int32, device=dev)
    mask = torch.zeros((8, Tp), dtype=torch.bool, device=dev)
    for b, p in enumerate(prompts):
        toks[b, Tp - len(p):] = torch.tensor(p, dtype=torch.int32)
        mask[b, Tp - len(p):] = True
    with torch.inference_mode():
        last, _ = M.prefill(params, cfg, toks, mask, max_len=576)
    check(tuple(last.shape) == (8, cfg.padded_vocab), "prefill logits shape")
    check(bool(torch.isfinite(last).all()), "prefill logits not finite")

    reset_launches()
    epochs = []
    spy = SvSpy() if sv_spy is None else sv_spy
    sm_spy = SmSpy(chunked=False)
    on_card = dev == "cuda"
    for ep in range(2):
        eng.begin_iteration(ep)
        for s_ in (spy, sm_spy, *spies):
            s_.new_epoch()
        sync(torch, dev)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with spy, sm_spy, contextlib.ExitStack() as stack:
            for s_ in spies:
                stack.enter_context(s_)
            outs, st = eng.generate(prompts, pids, max_new_tokens=max_new)
        sync(torch, dev)
        wall = time.perf_counter() - t0
        epochs.append((outs, st, wall))
        toks_n = st.n_toks_emitted
        peak = (f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
                if on_card else "not measured")
        log(f"{where} epoch {ep + 1}: wall {wall * 1e3:.1f} ms, rounds "
            f"{st.n_rounds}, "
            f"tokens {toks_n}, {toks_n / wall:.1f} tok/s, drafted "
            f"{st.n_drafted}, accepted {st.n_accepted} "
            f"({st.acceptance_per_round:.2f}/round), peak memory "
            f"{peak}  [{card}]")
    launches = read_launches()
    log(f"{where} path launches: {launches}")
    (o1, s1, _), (o2, s2, _) = epochs
    for b, o in enumerate(o1):
        check(len(o) <= max_new[b], f"row {b} emitted {len(o)} > {max_new[b]}")
        check(all(0 <= t < cfg.vocab_size for t in o), f"row {b}: bad token")
    if cfg.num_experts == 0:
        check(o2 == o1,
              f"{where}: epoch 2 outputs differ from epoch 1 (T=0 is "
              "lossless)")
        check(s2.n_rounds < s1.n_rounds,
              f"{where}: epoch 2 did not cut verify rounds")
    else:
        log(f"{where}: {sum(a == b for a, b in zip(o1, o2))} of {len(o1)} "
            "epoch-2 outputs equal epoch 1's (not gated: see the MoE spy)")
    check(s2.n_accepted > 0, f"{where}: epoch 2 accepted no drafts")
    if on_card:
        check(launches["suffix_match_propose"] > 0,
              "suffix_match_propose never launched on the lock-step path")
        # every dispatched micro-round launches, the rounds past the loop's
        # exit (``n_idle_rounds``) included
        idle = s1.n_idle_rounds + s2.n_idle_rounds
        check_sv_launches(cfg, launches, s1.n_rounds + s2.n_rounds + idle,
                          where)
        check_sv_spy(torch, card, cfg, spy, where)
        sm_spy.check(torch, card, where)
        check(launches["suffix_match_propose_chunked"] == 0,
              "the chunked kernel launched on the flat lock-step path")
        check_rglru_launches(cfg, launches, s1.n_fwd + s2.n_fwd + idle,
                             where)
        check_xlstm_launches(cfg, launches, s1.n_fwd + s2.n_fwd + idle,
                             where)
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


class GcTimer:
    """Passes and seconds of Python's cyclic garbage collector while
    active (``gc.callbacks``): host time a round loses to it."""

    def __init__(self):
        self.n, self.s, self._t0 = 0, 0.0, None

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.n += 1
            self.s += time.perf_counter() - self._t0
            self._t0 = None

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)


def serve_epochs(torch, eng, prompts, pids, max_new, slots, dev, card, tag,
                 on_epoch=None, journal=None):
    """Two epochs of ``SpecEngine.serve`` over the same requests; returns
    per epoch the outputs, per-request rounds and admission rounds, the
    stats and the wall. ``on_epoch()`` is called as each epoch begins;
    with a ``journal`` each request is journaled under ``e<epoch>-<i>``."""
    from repro_torch.core.scheduler import Request
    from repro_torch.core.spec_engine import RolloutStats

    runs = []
    for ep in range(2):
        eng.begin_iteration(ep)
        if on_epoch is not None:
            on_epoch()
        reqs = [Request(rid=i, problem_id=pids[i], prompt=list(prompts[i]),
                        max_new_tokens=max_new[i], journal_key=f"e{ep}-{i}")
                for i in range(len(prompts))]
        st = RolloutStats()
        gc.collect()  # each epoch starts from the same collector state
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with GcTimer() as gct:
            for _ in eng.serve(reqs, slots=slots, stats=st, journal=journal):
                pass
        if dev == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        toks = st.n_toks_emitted
        log(f"{tag} epoch {ep + 1}: makespan {st.n_rounds} rounds, wall "
            f"{wall * 1e3:.1f} ms, tokens {toks}, {toks / wall:.1f} tok/s, "
            f"drafted {st.n_drafted}, accepted {st.n_accepted}; host "
            f"bookkeeping {st.host_time_s * 1e3:.1f} ms, {gct.n} collector "
            f"passes {gct.s * 1e3:.1f} ms  [{card}]")
        runs.append(dict(outputs=[r.output for r in reqs],
                         rounds=[r.rounds for r in reqs],
                         admit=[r.admit_round for r in reqs],
                         makespan=st.n_rounds, accepted=st.n_accepted,
                         stats=st, wall=wall, gc_s=gct.s))
    return runs


def serving_engine(cfg, params, dev, max_new, layout="chunked", tel=None):
    """Phase 5's engine: fused rounds, scope ``problem``, one K bucket
    (16), so every verify round runs one (slots, 17) block."""
    from repro_torch.core.drafter import DrafterConfig, SuffixDrafter
    from repro_torch.core.spec_engine import EngineConfig, SpecEngine

    return SpecEngine(
        params, cfg,
        EngineConfig(max_draft=16, block_buckets=(16,),
                     max_new_tokens=max(max_new), eos_token=1,
                     fuse_rounds="auto"),
        drafter=SuffixDrafter(DrafterConfig(scope="problem",
                                            forest_layout=layout)),
        telemetry=tel, device=dev)


def continuous_layouts(torch, np, cfg, params, dev, card, *, slots,
                       n_problems, n_requests, limits, prompt_len,
                       layouts=("chunked", "flat"), lockstep=True,
                       sv_spy=None, spies=()):
    """The continuous path with the chunked forest, then (unless
    ``layouts`` leaves it out) with the flat one on a fresh engine and
    drafter; gated as ``phase_continuous`` says. ``sv_spy`` (one
    ``SvSpy`` for every layout, kept by the caller) and ``spies`` (each
    with ``new_epoch``) wrap the runs. Returns each run's launches (by
    layout), the chunked run's runs, the prompts, the lock-step outputs
    of the same prompts (None without ``lockstep``) and the chunked run's
    suffix-match spy (its second epoch's launches kept for timing)."""
    prompts, pids, max_new = continuous_requests(
        np, cfg.vocab_size, n_problems, n_requests, limits, prompt_len)
    result = {}
    for layout in layouts:
        eng = serving_engine(cfg, params, dev, max_new, layout)
        sv = SvSpy() if sv_spy is None else sv_spy
        sm_spy = SmSpy(chunked=layout == "chunked")

        def on_epoch():
            for s_ in (sv, sm_spy, *spies):
                s_.new_epoch()

        reset_launches()
        with sv, sm_spy, contextlib.ExitStack() as stack:
            for s_ in spies:
                stack.enter_context(s_)
            runs = serve_epochs(torch, eng, prompts, pids, max_new, slots,
                                dev, card, f"continuous ({layout})",
                                on_epoch=on_epoch)
        launches = read_launches()
        log(f"{cfg.name} continuous ({layout}) launches: {launches}")
        if dev == "cuda":
            where = f"{cfg.name} continuous ({layout})"
            check_sv_launches(cfg, launches,
                              sum(r["stats"].n_rounds for r in runs), where)
            check_sv_spy(torch, card, cfg, sv, where)
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
        check_xlstm_launches(cfg, c_launch,
                             sum(r["stats"].n_fwd for r in c_runs),
                             f"{cfg.name} continuous (chunked)")
        check(c_spy.trees >= n_problems,
              f"the chunked forest held {c_spy.trees} trees")
    lock = (f_eng.generate(prompts, pids, max_new_tokens=max_new)[0]
            if lockstep else None)
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
    launches (by layout), the chunked run's suffix-match spy and the
    chunked run's epochs (phase 10a's reference)."""
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
    return launches, spy, runs


# The most a bf16 engine's token may fall short of plain greedy's top
# logit on the same prefix: 8 bfloat16 ulps at the top logits' magnitude
# here (4 to 8, one ulp 2^-5). Two bf16 computations of the same logits
# whose every logit differs by at most e pick tokens at most 2e apart;
# a token picked on a wrong context falls short by about the top logit.
TOL_LOGIT_BF16 = 0.25


def greedy_shortfalls(torch, cfg, params, prompt, out):
    """Plain greedy decoding's view of ``out`` after ``prompt``: one
    full-sequence forward (no cache, no kernels: the RG-LRU scan swapped
    for its plain version) over prompt + output gives the logits at each
    position on the output's own prefix; returns each token's shortfall
    from the top logit there and the top-2 gap, as numpy arrays."""
    from repro_torch.models import model as M

    dev = params.embed.device
    x = torch.tensor([list(prompt) + list(out)], dtype=torch.int32,
                     device=dev)
    with torch.inference_mode(), plain_rglru_scan():
        logits, _ = M.forward(params, cfg, x)
        lg = logits[0, len(prompt) - 1:len(prompt) - 1 + len(out),
                    :cfg.vocab_size]
        top2 = torch.topk(lg, 2, dim=-1).values
        chosen = lg.gather(1, torch.tensor(list(out), device=dev)[:, None])
        sf = (top2[:, 0] - chosen[:, 0]).cpu().numpy()
        gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    return sf, gap


def first_divergence(o, r, res_o, res_r, label):
    """Where output ``o`` first differs from ``r``, with both tokens'
    shortfalls there (``res_*``: ``greedy_shortfalls``' arrays) and the
    reference's top-2 gap; None when equal."""
    if o == r:
        return None
    j = next((j for j, (a, b) in enumerate(zip(o, r)) if a != b),
             min(len(o), len(r)))
    if j == min(len(o), len(r)):
        return f"{label}: length {len(o)} vs {len(r)}"
    return (f"{label}@{j}: {float(res_o[0][j]):.4f}/"
            f"{float(res_r[0][j]):.4f} (top-2 gap {float(res_r[1][j]):.4f})")


def plain_greedy_full_width(torch, np, cfg, params, prompts, outputs, card):
    """Every token of every output set (name -> one output per prompt)
    against plain greedy decoding (``greedy_shortfalls``): the output's
    token must be the top or within ``TOL_LOGIT_BF16`` of it. An output
    that is a prefix of one already checked for the same prompt reuses
    its forward. Logs, per set, the tokens checked, how many are the top,
    the largest shortfall, and, for outputs that differ from the first
    set's, the first position they differ at with both tokens'
    shortfalls there."""
    done = {}  # prompt -> list of (tokens, shortfalls, top-2 gaps)

    def measure(p, out):
        for toks, sf, gap in done.get(tuple(p), []):
            if toks[:len(out)] == out:
                return sf[:len(out)], gap[:len(out)]
        sf, gap = greedy_shortfalls(torch, cfg, params, p, out)
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
        div = [] if name == ref_name else [
            d for i, o in enumerate(outs) if (d := first_divergence(
                o, outputs[ref_name][i], res[name][i], res[ref_name][i],
                f"r{i}")) is not None]
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
# phase 10: telemetry and durability (10a and 10b after phase 5, 10c after
# phase 8, 10d with the CLIs)
# ---------------------------------------------------------------------------

# 10b requests the drain at the first request that finishes once epoch 1
# has dispatched this many rounds (phase 5's traffic: the first limits are
# 32 tokens, so requests finish from about round 32 on).
DRAIN_AFTER_ROUNDS = 48


def prom_values(text):
    """The unlabelled samples of a Prometheus exposition, by name."""
    out = {}
    for ln in text.splitlines():
        if ln and not ln.startswith("#"):
            name, _, val = ln.rpartition(" ")
            if "{" not in name:
                out[name] = float(val)
    return out


def journal_summary(sess):
    fs = [s for s in sess.values()]
    return (f"{len(fs)} sessions, {sum(s.finished for s in fs)} finished, "
            f"{sum(len(s.tokens) for s in fs)} tokens")


def fsync_line(tel):
    h = tel.registry.get("das_journal_fsync_seconds")
    n, tot = h.count, h.sum
    return (f"{int(n)} fsyncs, {tot * 1e3:.3f} ms in all"
            + (f" ({tot / n * 1e6:.1f} us each)" if n else ""))


def phase_telemetry(torch, np, card, cfg, params, ref_runs, ref_launches,
                    dev="cuda", slots=8, n_problems=12, n_requests=24,
                    limits=(32, 64, 128, 256), prompt_len=(128, 256)):
    """10a: phase 5's continuous traffic (chunked forest) on a fresh
    engine with one ``obs.Telemetry`` (flight recorder on) and one
    ``RolloutJournal`` in a temporary directory. Gated: every token, round
    count and host/device crossing (``n_d2h``, ``n_h2d``) of both epochs
    equal to phase 5's chunked run (``ref_runs``), and so are the
    spec-verify and chunked-drafting launches (``ref_launches``); the
    kept launches held to the plain versions; the Prometheus text's
    ``das_rounds_total`` and drafted/accepted token counters equal to the
    stats; the journal's recovered sessions equal to the outputs, all
    finished; the exported trace validates; the attribution report has a
    component table for each length class. Logged: the wall a round
    beside phase 5's and the journal's fsync times. Returns the launches
    and the engine's telemetry."""
    import tempfile

    from repro_torch import obs
    from repro_torch.fault import RolloutJournal

    prompts, pids, max_new = continuous_requests(
        np, cfg.vocab_size, n_problems, n_requests, limits, prompt_len)
    tel = obs.Telemetry()
    tel.attach_flight(worker="w0")
    eng = serving_engine(cfg, params, dev, max_new, tel=tel)
    sv_spy, sm_spy = SvSpy(), SmSpy(chunked=True)

    def on_epoch():
        sv_spy.new_epoch()
        sm_spy.new_epoch()

    where = f"10a {cfg.name} continuous (telemetry, journal)"
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "serve.wal")
        jrnl = RolloutJournal(path, telemetry=tel)
        reset_launches()
        with sv_spy, sm_spy:
            runs = serve_epochs(torch, eng, prompts, pids, max_new, slots,
                                dev, card, where, on_epoch=on_epoch,
                                journal=jrnl)
        launches = read_launches()
        jrnl.close()
        sess = RolloutJournal.recover(path)
        trace = obs.export_trace(os.path.join(tmp, "trace.json"), [tel])
    for ep, (got, want) in enumerate(zip(runs, ref_runs)):
        g, w = got["stats"], want["stats"]
        check(got["outputs"] == want["outputs"],
              f"{where} epoch {ep + 1}: tokens differ from phase 5's")
        check((g.n_rounds, g.n_drafted, g.n_accepted)
              == (w.n_rounds, w.n_drafted, w.n_accepted),
              f"{where} epoch {ep + 1}: rounds/drafted/accepted differ")
        check((g.n_d2h, g.n_h2d) == (w.n_d2h, w.n_h2d),
              f"{where} epoch {ep + 1}: n_d2h/n_h2d {g.n_d2h}/{g.n_h2d}, "
              f"phase 5's {w.n_d2h}/{w.n_h2d}: telemetry or the journal "
              "added a crossing")
        per = 1e3 / g.n_rounds
        log(f"{where} epoch {ep + 1}: wall a round "
            f"{got['wall'] * per:.2f} ms beside phase 5's "
            f"{want['wall'] * per:.2f} ms; host bookkeeping "
            f"{g.host_time_s * per:.2f} ms beside {w.host_time_s * per:.2f}, "
            f"the collector {got['gc_s'] * per:.2f} ms beside "
            f"{want['gc_s'] * per:.2f} ({g.n_rounds} rounds; n_d2h "
            f"{g.n_d2h}, n_h2d {g.n_h2d} in both)  [{card}]")
    if dev == "cuda":
        for name in ("spec_verify_attention", "suffix_match_propose_chunked",
                     "suffix_match_propose"):
            check(launches[name] == ref_launches[name],
                  f"{where}: {launches[name]} {name} launches, phase 5's "
                  f"chunked run {ref_launches[name]}")
        sv_spy.check(torch, card, where)
        sm_spy.check(torch, card, where)
    prom = prom_values(tel.prometheus())
    for name, field in (("das_rounds_total", "n_rounds"),
                        ("das_tokens_drafted_total", "n_drafted"),
                        ("das_tokens_accepted_total", "n_accepted"),
                        ("das_tokens_emitted_total", "n_toks_emitted"),
                        ("das_d2h_transfers_total", "n_d2h")):
        want = sum(getattr(r["stats"], field) for r in runs)
        check(prom.get(name) == want,
              f"{where}: {name} {prom.get(name)} in the Prometheus text, "
              f"the stats {want}")
    for ep, r in enumerate(runs):
        for i, out in enumerate(r["outputs"]):
            s = sess.get(f"e{ep}-{i}")
            check(s is not None and s.finished and s.tokens == out,
                  f"{where}: journal session e{ep}-{i} differs from its "
                  "output")
    problems = obs.validate_chrome_trace(trace)
    check(not problems, f"{where}: the exported trace is invalid: "
          f"{problems[:3]}")
    spans = [sp.to_dict() for sp in tel.tracer.recent(4096)]
    rep = obs.attribute(tel.flight.events(), spans)
    check(rep["n_rollouts"] == 2 * n_requests
          and all("components_s" in c for c in rep["classes"].values())
          and sum(c["n"] for c in rep["classes"].values()) == 2 * n_requests,
          f"{where}: attribution report {rep.get('n_rollouts')} rollouts, "
          f"classes {sorted(rep.get('classes', {}))}")
    comp = {k: {n: round(v, 3) for n, v in c["components_s"].items()}
            for k, c in rep["classes"].items()}
    log(f"{where}: Prometheus counters equal to the stats "
        f"(das_rounds_total {prom['das_rounds_total']:g}, drafted "
        f"{prom['das_tokens_drafted_total']:g}, accepted "
        f"{prom['das_tokens_accepted_total']:g}); journal "
        f"{journal_summary(sess)}, {fsync_line(tel)}; trace "
        f"{len(trace['traceEvents'])} events, valid; attribution by length "
        f"class (s): {comp}; top decile's makespan share "
        f"{rep['top_decile']['makespan_share']:.3f}  [{card}]")
    return launches, tel


def phase_drain_resume(torch, np, card, cfg, params, dev="cuda",
                       slots=8, n_problems=12, n_requests=24,
                       limits=(32, 64, 128, 256), prompt_len=(128, 256),
                       drain_after=DRAIN_AFTER_ROUNDS, reference=None):
    """10b: phase 5's epoch-1 traffic with a journal and a
    ``DrainController`` on a virtual clock. At the first request that
    finishes once ``drain_after`` rounds were dispatched, the caller
    requests the drain and moves the clock past its deadline: ``serve``
    preempts the residents, stops admitting, fsyncs the journal and
    returns. A fresh engine on the same parameters recovers the journal
    (``RolloutJournal.recover``, ``resume_requests``) and runs
    ``generate_continuous(resume=...)``. The reference is ``reference``
    (phase 5's epoch-1 run: outputs and makespan) or, without one, the
    same traffic uninterrupted on a fresh engine. Gated: the serve
    stopped early with requests finished, preempted and queued; every
    journaled prefix equals the reference's (the drained serve runs the
    reference's rounds until the drain); ``das_resumed_tokens_total``
    equals the salvaged tokens; and the resumed outputs: in float32 equal
    to the reference token for token; in bf16, where a GEMM rounds by
    its shapes and the re-prefill of ``prompt + salvage[:-1]`` and the
    admissions after the drain run other shapes than the rounds they
    stand in for, every token of both within ``TOL_LOGIT_BF16`` of plain
    greedy's top logit on its own prefix, with both tokens' shortfalls
    logged where an output first departs from the reference (the
    witness that a divergence is a near-tie). Returns the launches of
    the runs and the spec-verify spy."""
    import tempfile

    from repro_torch import obs
    from repro_torch.core.scheduler import Request
    from repro_torch.core.spec_engine import RolloutStats
    from repro_torch.fault import (
        DrainController,
        RolloutJournal,
        VirtualClock,
    )

    prompts, pids, max_new = continuous_requests(
        np, cfg.vocab_size, n_problems, n_requests, limits, prompt_len)
    keys = [f"r{i}" for i in range(len(prompts))]
    exact = cfg.dtype == "float32"
    where = f"10b {cfg.name} ({cfg.dtype}) drain and resume"
    reset_launches()
    sv_spy, sm_spy = SvSpy(), SmSpy(chunked=True)
    ref_rounds = 0  # verify rounds this phase ran for its reference
    if reference is None:
        ref = serving_engine(cfg, params, dev, max_new)
        ref.begin_iteration(0)
        sync(torch, dev)
        t0 = time.perf_counter()
        with sv_spy, sm_spy:
            want, st0 = ref.generate_continuous(prompts, pids, slots=slots,
                                                max_new_tokens=max_new)
        sync(torch, dev)
        t_ref = time.perf_counter() - t0
        del ref
        makespan = ref_rounds = st0.n_rounds
        ref_line = (f"the uninterrupted reference {st0.n_rounds} rounds in "
                    f"{t_ref:.1f} s")
    else:
        want, makespan = reference["outputs"], reference["makespan"]
        ref_line = f"the reference phase 5's epoch 1 ({makespan} rounds)"
    clk = VirtualClock()
    drain = DrainController(deadline_s=5.0, clock=clk)
    eng = serving_engine(cfg, params, dev, max_new)
    eng.begin_iteration(0)
    reqs = [Request(rid=i, problem_id=pids[i], prompt=list(prompts[i]),
                    max_new_tokens=max_new[i], journal_key=keys[i])
            for i in range(len(prompts))]
    st = RolloutStats()
    sv_spy.new_epoch()
    sm_spy.new_epoch()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "drain.wal")
        jrnl = RolloutJournal(path)
        t0 = time.perf_counter()
        with sv_spy, sm_spy:
            for _ in eng.serve(reqs, slots=slots, stats=st, journal=jrnl,
                               drain=drain, clock=clk):
                if not drain.draining and st.n_rounds >= drain_after:
                    drain.request("phase 10b")
                    clk.advance(drain.deadline_s + 1.0)
                    at_round = st.n_rounds
        jrnl.close()
        sync(torch, dev)
        t_serve = time.perf_counter() - t0
        del eng
        states = Counter(r.state for r in reqs)
        check(drain.draining and drain.expired(),
              f"{where}: the drain was never requested")
        check(states["finished"] > 0 and states["preempted"] > 0
              and states["queued"] > 0 and st.n_rounds < makespan,
              f"{where}: states {dict(states)} after {st.n_rounds} rounds "
              f"(the reference's makespan {makespan})")
        t0 = time.perf_counter()
        sess = RolloutJournal.recover(path)
        t_recover = time.perf_counter() - t0
    for i, k in enumerate(keys):
        s = sess[k]
        check(s.tokens == want[i][: len(s.tokens)]
              and (not s.finished or s.tokens == want[i]),
              f"{where}: journaled {k} ({len(s.tokens)} tokens, finished "
              f"{s.finished}) is not a prefix of the reference's output")
    salvaged = sum(len(s.tokens) for s in sess.values()
                   if s.resumable and s.tokens)
    n_res = sum(1 for s in sess.values() if s.resumable and s.tokens)
    tel = obs.Telemetry()
    eng2 = serving_engine(cfg, params, dev, max_new, tel=tel)
    eng2.begin_iteration(0)
    t0 = time.perf_counter()
    sv_spy.new_epoch()
    sm_spy.new_epoch()
    with sv_spy, sm_spy:
        outs, st2 = eng2.generate_continuous(
            prompts, pids, slots=slots, max_new_tokens=max_new,
            journal_keys=keys, resume=sess)
    sync(torch, dev)
    t_resume = time.perf_counter() - t0
    del eng2
    launches = read_launches()
    if dev == "cuda":
        check_sv_launches(cfg, launches,
                          ref_rounds + st.n_rounds + st2.n_rounds, where)
        sv_spy.check(torch, card, where)
        sm_spy.check(torch, card, where)
    resumed = tel.registry.value("das_resumed_tokens_total")
    same = sum(a == b for a, b in zip(outs, want))
    log(f"{where}: {ref_line}; drain requested at round {at_round}, serve "
        f"returned after {st.n_rounds} rounds in {t_serve:.1f} s with states "
        f"{dict(states)}; journal recovered in {t_recover * 1e3:.1f} ms "
        f"({journal_summary(sess)}); {n_res} resumed by prefix re-prefill "
        f"({salvaged} salvaged tokens, das_resumed_tokens_total "
        f"{resumed:g}), rest served in {st2.n_rounds} rounds, "
        f"{t_resume:.1f} s; {same} / {len(want)} outputs equal the "
        f"reference  [{card}]")
    check(resumed == salvaged and salvaged > 0,
          f"{where}: das_resumed_tokens_total {resumed}, salvaged "
          f"{salvaged}")
    for i, (o, w) in enumerate(zip(outs, want)):
        if o != w:
            d = next((j for j, (a, b) in enumerate(zip(o, w)) if a != b),
                     min(len(o), len(w)))
            log(f"{where}: request {i} ({len(sess[keys[i]].tokens)} "
                f"journaled) diverges from the reference at token {d} of "
                f"{len(w)}")
    if exact:
        check(same == len(want), f"{where}: {len(want) - same} resumed "
              "outputs differ from the uninterrupted run's")
    else:
        plain_greedy_full_width(
            torch, np, cfg, params, prompts,
            {"10b reference": want, "10b drained and resumed": outs}, card)
    return launches, sv_spy


class SliceTimer:
    """A rollout-worker proxy (as ``fault.FlakyWorker`` is one): times
    each ``rollout`` call, a slice or a re-queued one, to the card's
    sync, and records the trainer step, the worker, the problems, the
    tokens it resumed, its verify rounds and how it ended."""

    def __init__(self, worker, index, step, torch, dev, out):
        self._worker, self._index, self._step = worker, index, step
        self._torch, self._dev, self._out = torch, dev, out

    def __getattr__(self, name):
        return getattr(self._worker, name)

    def rollout(self, problems, *a, resume=None, **k):
        t0 = time.perf_counter()
        rec = dict(step=self._step() + 1, worker=self._index,
                   problems=len(problems),
                   resumed=sum(len(x.tokens) for x in (resume or {}).values()))
        try:
            part = self._worker.rollout(problems, *a, resume=resume, **k)
        except Exception as exc:
            rec.update(end=type(exc).__name__, rounds=None)
            raise
        else:
            rec.update(end="ok", rounds=part.stats.n_rounds)
            return part
        finally:
            sync(self._torch, self._dev)
            rec["s"] = time.perf_counter() - t0
            self._out.append(rec)


class StackSampler:
    """A sampling profiler of the calling thread: a daemon thread reads
    its stack every ``interval_s`` (``sys._current_frames``) and counts
    the innermost frame of the repository's code and the innermost frame
    of all; ``top()`` gives each count's share of the samples. The
    service's shard threads are not sampled."""

    def __init__(self, interval_s=0.005):
        import threading

        self.interval_s = interval_s
        self.ident = threading.get_ident()
        self.ours, self.leaf = Counter(), Counter()
        self.n = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.wait(self.interval_s):
            f = sys._current_frames().get(self.ident)
            if f is None:
                continue
            self.n += 1
            self.leaf[f"{f.f_code.co_name} "
                      f"({os.path.basename(f.f_code.co_filename)})"] += 1
            while f is not None and "repro_torch" not in f.f_code.co_filename:
                f = f.f_back
            if f is not None:
                self.ours[f"{f.f_code.co_name} "
                          f"({os.path.basename(f.f_code.co_filename)}:"
                          f"{f.f_lineno})"] += 1

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    def top(self, counter, k=6):
        return "; ".join(f"{name} {c / max(self.n, 1):.0%}"
                         for name, c in counter.most_common(k))


def span_profile(tracer, t_a, t_b):
    """The engine's spans (``obs`` tracer) that began in [t_a, t_b], by
    name: total ms and count, the outermost (depth 0) first; and their
    sum beside the window."""
    agg = {}
    for sp in tracer.recent():
        if t_a <= sp.t0 <= t_b:
            a = agg.setdefault((sp.depth, sp.name), [0.0, 0])
            a[0] += sp.dur_s
            a[1] += 1
    top = sum(v[0] for (d, _), v in agg.items() if d == 0)
    return (f"{(t_b - t_a) * 1e3:.1f} ms, of it {top * 1e3:.1f} ms in "
            "outermost spans; " + "; ".join(
                f"{n} (depth {d}) {v[0] * 1e3:.1f} ms x{v[1]}"
                for (d, n), v in sorted(agg.items(),
                                        key=lambda kv: (kv[0][0],
                                                        -kv[1][0]))))


def phase_multiworker(torch, np, card, cfg=None, dev="cuda", tag="10c",
                      steps=3, n_problems=8, max_new_tokens=32,
                      resume=True):
    """10c: ``Trainer.run`` with two workers over the in-process sharded
    history service (2 shards), ``fault_tolerant``, ``journal_dir`` and
    ``flight_recorder``, at T = 0 on 8e's pattern task (no SFT), with a
    seeded ``FaultPlan``: shard 1 killed by its hook after its second
    publish, worker 1's watchdog stalled (a virtual clock) at its third
    check and ``FlakyWorker`` stalling worker 1 on its first call; with
    ``resume``, a checkpoint after step 2, from which a fresh two-worker
    trainer (the shards' states in its sidecar) runs step 3. Before it, a
    single-worker run of the same steps. Gated: the supervisor restarted
    the shard; ``plan.fired`` lists the kill and the stall; two worker
    failures re-queued with salvage; handoff and resume flight events;
    spec-verify once per attention layer per verify round of every
    trainer (``das_rounds_total``, failed slices included) and its kept
    launches within the tolerance of the plain version; the flat drafting
    kernel's kept launches bit-identical to its plain version, and it
    drafted from the remote packs; and the responses: in float32 every
    step's equal to the single-worker run's and the resumed step 3 equal
    to the uninterrupted one (with ``resume``); in bf16, where a slice
    verifies half the
    rows (other GEMM shapes than the single worker's) and a re-queued
    slice re-prefills, every response token of every run within
    ``TOL_LOGIT_BF16`` of plain greedy's top logit on its own prefix
    under the weights it was sampled with, and where a response first
    departs from the other run's both tokens' shortfalls are logged (at
    step 1 and for the resumed step 3 the two runs' weights are the
    same). Logged: each slice's wall, rounds and end, the rollout time a
    step beside the single-worker run's, the shard restart time, the
    peak memory, and the last step's rollout in the single- and the
    two-worker run: its engine spans (``span_profile``), collector passes
    and the stack samples of the host loop (``StackSampler``). Returns
    the launches and the spec-verify spy."""
    import tempfile

    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.core.drafter import DrafterConfig
    from repro_torch.core.spec_engine import EngineConfig
    from repro_torch.data.tasks import PatternTask
    from repro_torch.fault import FaultPlan, FlakyWorker, RolloutWatchdog
    from repro_torch.fault import VirtualClock
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.rl.trainer import Trainer, TrainerConfig

    cfg = cfg or get_config("qwen2-1.5b")
    exact = cfg.dtype == "float32"
    where = f"{cfg.name} ({cfg.dtype}) {tag}"

    def trainer(n_workers, **over):
        return Trainer(
            cfg, PatternTask(n_problems=n_problems),
            TrainerConfig(
                steps=steps, prompts_per_step=4, group_size=2,
                max_new_tokens=max_new_tokens, temperature=0.0, seed=0,
                sft_warmup_steps=0, optim=AdamWConfig(lr=STEP_LR,
                                                      warmup_steps=2),
                engine=EngineConfig(max_draft=16, block_buckets=(16,),
                                    eos_token=1),
                drafter=DrafterConfig(scope="problem"),
                n_workers=n_workers, history_shards=2,
                supervise_interval_s=0.5, **over),
            telemetry=obs.Telemetry(), device=dev)

    client_stats = Counter()
    rounds = []  # das_rounds_total of each trainer

    def run(tr, profile=False):
        """Every step's responses and, in bf16, their shortfalls under
        the weights they were sampled with; the history."""
        rolls, short = [], []
        orig = tr.worker.rollout

        def wrapped(*a, **k):
            if profile and tr._step + 1 == steps:
                tr.telemetry.tracer.recent()  # fold the earlier spans
                t_a = time.perf_counter()
                with StackSampler() as smp, GcTimer() as gct:
                    batch = orig(*a, **k)
                    sync(torch, dev)
                spans = span_profile(tr.telemetry.tracer, t_a,
                                     time.perf_counter())
                log(f"{where} step {steps} rollout with "
                    f"{len(tr.engines)} worker(s), its spans: {spans}; "
                    f"{gct.n} collector passes {gct.s * 1e3:.1f} ms; "
                    f"{smp.n} stack samples, innermost repro_torch frame: "
                    f"{smp.top(smp.ours)}; innermost frame: "
                    f"{smp.top(smp.leaf)}  [{card}]")
            else:
                batch = orig(*a, **k)
            resp = [list(r) for r in batch.responses]
            rolls.append(resp)
            if not exact:
                short.append([greedy_shortfalls(
                    torch, cfg, tr.params, p.prompt, r) if r else
                    (np.zeros(0), np.zeros(0))
                    for p, r in zip(batch.problems, resp)])
            return batch

        tr.worker.rollout = wrapped
        try:
            hist = tr.run()
            for c in tr._clients:
                client_stats.update(c.stats)
            rounds.append(tr.telemetry.registry.value("das_rounds_total"))
        finally:
            tr.close()
        return rolls, short, hist

    reset_launches()
    sv_spy, sm_spy = SvSpy(), SmSpy(chunked=False)
    with sv_spy, sm_spy:
        want, want_sf, hist1 = run(trainer(1), profile=True)
    sync(torch, dev)
    gc.collect()  # a trainer's engines and telemetry form cycles
    if dev == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        tr = trainer(2, fault_tolerant=True, flight_recorder=True,
                     journal_dir=os.path.join(tmp, "jrnl"), ckpt_path=tmp,
                     ckpt_every=2 if resume else 0)
        plan = FaultPlan(seed=0, telemetry=tr.telemetry).kill_shard(
            1, op="publish", at=2)
        for i, srv in enumerate(tr.service.servers):
            srv.fault_hook = plan.server_hook(i)
        mw = tr.worker
        w1 = mw.workers[1]
        w1.watchdog = plan.stall_watchdog(
            RolloutWatchdog(60.0, clock=VirtualClock(),
                            flight=tr.telemetry.flight), at_check=3)
        mw.workers[1] = FlakyWorker(w1, fail_calls=(0,))
        slices = []
        mw.workers = [SliceTimer(w, i, lambda: tr._step, torch, dev, slices)
                      for i, w in enumerate(mw.workers)]
        sup = tr.supervisor
        restarts = []
        orig_respawn = tr.service.respawn_shard

        def timed_respawn(i, *a, **k):
            t0 = time.perf_counter()
            out = orig_respawn(i, *a, **k)
            restarts.append(time.perf_counter() - t0)
            return out

        tr.service.respawn_shard = timed_respawn
        flushes = []  # the epoch barrier after each slice, timed
        orig_flush = mw._flush_worker

        def timed_flush(worker):
            t0 = time.perf_counter()
            orig_flush(worker)
            flushes.append(time.perf_counter() - t0)

        mw._flush_worker = timed_flush
        flight = tr.telemetry.flight
        with sv_spy, sm_spy:
            got, got_sf, hist2 = run(tr, profile=True)
        sync(torch, dev)
        peak = (torch.cuda.max_memory_allocated() / 2**30
                if dev == "cuda" else 0.0)
        fired = sorted(f["kind"] for f in plan.fired)
        stats = dict(mw.stats)
        felt = {k: client_stats[k] for k in (
            "published_batches", "publish_failures", "rpc_timeouts",
            "sync_failures", "backoff_skips", "shard_restarts", "reconnects",
            "packs_applied")}
        kinds = Counter(e["kind"] for e in flight.events())
        fired_log, n_restarts = list(plan.fired), sup.stats["restarts"]
        # the plan and the flight recorder reach the engines through the
        # telemetry's registry
        del tr, mw, w1, plan, flight, sup, orig_respawn, timed_respawn, \
            orig_flush, timed_flush
        gc.collect()
        if dev == "cuda":
            torch.cuda.empty_cache()
        resumed, resumed_sf, load_line = None, [], ""
        if resume:
            tr = trainer(2)
            t0 = time.perf_counter()
            tr.load_checkpoint(os.path.join(tmp, "step2.npz"))
            load_line = (f"step-2 checkpoint with the shards' sidecar "
                         f"loaded in {time.perf_counter() - t0:.1f} s; ")
            check(tr._step == 2 and tr.service is not None,
                  f"{where}: the resumed trainer's cursor {tr._step}")
            with sv_spy, sm_spy:
                resumed, resumed_sf, _ = run(tr)
    launches = read_launches()
    check(len(got) == len(want) == steps
          and (resumed is None or len(resumed) == 1),
          f"{where}: {len(want)} and {len(got)} rollouts, resumed "
          f"{resumed and len(resumed)}")
    check(fired == ["shard", "watchdog"], f"{where}: plan.fired {fired}")
    check(n_restarts >= 1, f"{where}: no shard was restarted")
    check(stats.get("worker_failures") == 2
          and stats.get("salvaged_tokens", 0) > 0,
          f"{where}: multi-worker stats {stats}")
    check(kinds["handoff"] >= 1 and kinds["resume"] >= 1,
          f"{where}: flight events {dict(kinds)}")
    if dev == "cuda":
        check(launches["suffix_match_propose"] > 0
              and launches["suffix_match_propose_chunked"] == 0
              and launches["rglru_scan"] == 0
              and launches["rglru_scan_bwd"] == 0,
              f"{where}: launches {launches}")
        check_sv_launches(cfg, launches, int(sum(rounds)), where)
        sv_spy.check(torch, card, where)
        sm_spy.check(torch, card, where)
    same = [sum(a == b for a, b in zip(g, w)) for g, w in zip(got, want)]
    n_tok = sum(len(r) for rs in got for r in rs)
    if exact:
        check(got == want, f"{where}: the two-worker fault-tolerant run's "
              "responses differ from the single-worker run's")
        check(resumed is None or resumed == got[2:],
              f"{where}: the resumed step 3 differs")
        verdict = (f"{steps} steps token-identical to the single-worker run "
                   f"({n_tok} tokens)" + (", step 3 resumed token-identical"
                                          if resumed else ""))
    else:
        div, worst = [], 0.0
        for s_i, (g, w, gs, ws) in enumerate(zip(got, want, got_sf,
                                                 want_sf)):
            div += [d for i, (a, b) in enumerate(zip(g, w)) if (
                d := first_divergence(a, b, gs[i], ws[i],
                                      f"s{s_i + 1}r{i}")) is not None]
        res_line = ""
        if resumed:
            res_div = [d for i, (a, b) in enumerate(zip(resumed[0], got[2]))
                       if (d := first_divergence(a, b, resumed_sf[0][i],
                                                 got_sf[2][i], f"r{i}"))
                       is not None]
            res_line = (f"; the resumed step 3's equal to the "
                        f"uninterrupted one's "
                        f"{sum(a == b for a, b in zip(resumed[0], got[2]))} "
                        f"of {len(got[2])}, first divergence: "
                        f"{'; '.join(res_div) or 'none'}")
        for sfs in (want_sf, got_sf, resumed_sf):
            for step in sfs:
                for sf, _ in step:
                    worst = max(worst, float(sf.max(initial=0.0)))
        check(worst <= TOL_LOGIT_BF16,
              f"{where}: a response token falls {worst:.4f} short of plain "
              f"greedy's top logit (tolerance {TOL_LOGIT_BF16})")
        verdict = (f"responses equal to the single-worker run's by step "
                   f"{same} of {len(want[0])}; every token of the runs "
                   f"({n_tok} in the two-worker run) within {worst:.4f} of "
                   f"plain greedy's top logit (tolerance {TOL_LOGIT_BF16}); "
                   f"first divergence from the single-worker run, shortfall "
                   f"this/that: {'; '.join(div) or 'none'}{res_line}")
    log(f"{where}: {verdict}; faults fired {fired_log}; supervisor restarts "
        f"{n_restarts} ({', '.join(f'{t * 1e3:.1f} ms' for t in restarts)}); "
        f"publish flushes after each slice "
        f"({', '.join(f'{t * 1e3:.1f}' for t in flushes)}) ms; "
        f"multi-worker stats {stats}; the clients' {felt}; flight events "
        f"{dict(kinds)}; verify rounds by trainer {[int(r) for r in rounds]}; "
        f"{load_line}peak memory {peak:.2f} GiB  [{card}]")
    log(f"{where} slices: " + "; ".join(
        f"step {r['step']} worker {r['worker']} {r['problems']} problems"
        + (f" resuming {r['resumed']} tokens" if r["resumed"] else "")
        + f": {r['s'] * 1e3:.1f} ms, {r['rounds']} rounds, {r['end']}"
        for r in slices) + f"  [{card}]")
    for a, b in zip(hist1, hist2):
        log(f"{where} step {a['step'] + 1}: rollout {b['gen_time_s']:.3f} s "
            f"with two workers and faults, {a['gen_time_s']:.3f} s single "
            f"worker; accept/round {b['accept_per_round']:.3f} vs "
            f"{a['accept_per_round']:.3f}; train step "
            f"{b['train_time_s']:.3f} s  [{card}]")
    return launches, sv_spy


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


# 8a's checks of the flash kernels against their plain version on the
# card, each in float32 and bf16 (within FLASH_TOL; lse within the float32
# atol/rtol, the rows that see no key -1e30 in both; the backward twice,
# bit-identical): (label, B, S, Hkv, G, hd, window, mask). "left pads"
# pads each row's start (position -1, kval 0) and the last row wholly, so
# whole rows of queries see no key. S 1000, 2300 and 700 are not
# multiples of the kernels' 64-row tiles (the kernels are called on the
# unpadded lengths); hd 96 runs zero-padded to 128. 8a's own shape, as
# the layer pads it, is checked too.
FLASH_KERNEL_CASES = (
    ("hd 64, left pads", 2, 1000, 4, 1, 64, 0, "left pads"),
    ("hd 128, window 257, left pads", 3, 1000, 2, 6, 128, 257, "left pads"),
    ("hd 256, window 2048", 2, 2300, 1, 4, 256, 2048, None),
    ("hd 96 (padded to 128), window 257", 2, 700, 2, 2, 96, 257, None),
)


def flash_layer_cases():
    """8a's checks of the flash kernels at the other paths' own shapes, as
    the layer pads them, no mask: (label, arch, B, S, window) for phase
    9's GRPO step (RecurrentGemma-9B's local attention: 16 query heads on
    one kv head of 256, ``TRAIN_S``, its window) and 13c's
    (SeamlessM4T-medium's decoder self-attention: 16/16 heads of 64, B
    ``SEAMLESS_TRAIN_BATCH``, S 4,096, causal)."""
    from repro_torch.configs import get_config

    return (("phase 9's shape", "recurrentgemma-9b", 4, TRAIN_S,
             get_config("recurrentgemma-9b").local_window),
            ("13c's shape", "seamless-m4t-medium", SEAMLESS_TRAIN_BATCH,
             p13_jobs()["13c"][1].seq_len, 0))


def flash_positions(torch, B, S, mask, dev="cuda"):
    """(positions (B, S) int32, valid (B, S) bool or None) as prefill
    gives them: with "left pads" row b's first (0, 37, S // 3, ...)
    tokens are pads at position -1 and the last row is pads throughout."""
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None].repeat(B, 1)
    if mask is None:
        return pos, None
    valid = torch.ones((B, S), dtype=torch.bool, device=dev)
    for b in range(B):
        n = S if b == B - 1 else (0, 37, S // 3)[b % 3]
        valid[b, :n] = False
        pos[b, :n] = -1
        pos[b, n:] = torch.arange(S - n, dtype=torch.int32, device=dev)
    return pos, valid


def flash_case_inputs(torch, np, B, S, Hkv, G, hd, window, mask, dtype,
                      seed, dev="cuda"):
    """The flash kernels' arguments at one shape: q (B, S, Hkv, G, hd), k,
    v (B, S, Hkv, hd), dout like q, from a seed, and float positions."""
    rng = np.random.default_rng(seed)
    mk = [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
          .to(dev, dtype) for shape in ((B, S, Hkv, G, hd), (B, S, Hkv, hd),
                                        (B, S, Hkv, hd), (B, S, Hkv, G, hd))]
    pos, valid = flash_positions(torch, B, S, mask, dev)
    kval = (torch.ones((B, S), device=dev) if valid is None
            else valid.float())
    posf = pos.float()
    return (*mk[:3], posf, posf.clone(), kval), mk[3]


def flash_check(torch, card, where, args, dout, window, dtype, qc, kc):
    """Both kernels against the plain version on the same inputs (see
    FLASH_KERNEL_CASES); the backward launched twice, bit-identical.
    Returns (forward max |err|, backward max |err|)."""
    from repro_torch.kernels.flash import ops as fl_ops
    from repro_torch.kernels.flash import ref as fl_ref

    tol = FLASH_TOL[dtype]
    lse_tol = FLASH_TOL["float32"]
    out, lse = fl_ops.flash_fwd_cuda(*args, window)
    rout, rlse = fl_ref.flash_fwd_ref(*args, window, qc, kc)
    grads = fl_ops.flash_bwd_cuda(*args, out, lse, dout, window)
    again = fl_ops.flash_bwd_cuda(*args, out, lse, dout, window)
    rgrads = fl_ref.flash_bwd_ref(*args, out, lse, dout, window, qc, kc)
    torch.cuda.synchronize()
    err = float((out.float() - rout.float()).abs().max())
    check(bool(torch.isfinite(out).all()) and torch.allclose(
        out.float(), rout.float(), atol=tol["atol"], rtol=tol["rtol"]),
        f"{where} forward: out max |err| {err} against the plain version")
    empty = rlse <= -1e29
    check(torch.equal(lse <= -1e29, empty),
          f"{where} forward: the rows that see no key differ from the plain "
          "version's")
    lerr = float((lse[~empty] - rlse[~empty]).abs().max()) \
        if bool((~empty).any()) else 0.0
    check(torch.allclose(lse[~empty], rlse[~empty], atol=lse_tol["atol"],
                         rtol=lse_tol["rtol"]),
          f"{where} forward: lse max |err| {lerr}")
    rel, berr = [], 0.0
    for name, g, g2, r in zip(("dq", "dk", "dv"), grads, again, rgrads):
        check(torch.equal(g, g2), f"{where} {name}: two backward launches "
              "differ")
        e = float((g.float() - r.float()).abs().max())
        berr = max(berr, e)
        e = e / float(r.float().abs().max().clamp(min=1e-30))
        check(bool(torch.isfinite(g).all()) and e <= tol["grad"],
              f"{where} {name}: max |err| / max |ref| {e}")
        rel.append(f"{name} {e:.2e}")
    n_empty = int(empty.sum())
    log(f"{where}: out max |err| {err:.3e} (atol {tol['atol']}, rtol "
        f"{tol['rtol']}), lse {lerr:.3e}, {n_empty} (query, head) rows see "
        f"no key in both; gradients max |err| / max |ref| {', '.join(rel)} "
        f"(<= {tol['grad']}), the backward bit-identical over two launches"
        f"  [{card}]")
    return err, berr


def flash_bound_ms(torch, args, hd, S, backward):
    """Least time of one launch at this run's inputs (``flash_work``: the
    visible pairs counted from the positions, the unpadded length's
    bytes)."""
    from repro_torch.kernels.flash import ops as fl_ops

    q, _, _, qpos, kpos, kval = args
    B, _, Hkv, G, _ = q.shape
    pairs = fl_ops.visible_pairs(qpos, kpos, kval, 0)
    dtype = "bfloat16" if q.dtype == torch.bfloat16 else "float32"
    return roofline_ms(*reversed(fl_ops.flash_work(
        B, S, S, Hkv, G, hd, q.element_size(), pairs, backward)), dtype)


def phase_flash(torch, np, timer, card, B=4, S=2304, Hq=12, Hkv=2, hd=128):
    """8a: the flash kernels against their plain version on the card
    (``FLASH_KERNEL_CASES`` and 8a's own shape, float32 and bf16), then
    ``_flash_attn_train`` forward and backward at Qwen2-1.5B's attention
    shape and a long-tail length against autograd through the plain dense
    attention (``_attn_core``); times the kernels' forward, backward and
    forward + backward beside the plain version's, the dense version's
    and SDPA's (the boolean mask and ``is_causal``), with each one's peak
    memory. Returns the bf16 8a numbers of the JSON entries
    ``flash_attn_fwd`` and ``flash_attn_bwd``."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash import ops as fl_ops
    from repro_torch.kernels.flash import ref as fl_ref
    from repro_torch.models import layers as L

    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for i, (label, cB, cS, cHkv, cG, chd, w, mk) in enumerate(
                FLASH_KERNEL_CASES):
            args, dout = flash_case_inputs(torch, np, cB, cS, cHkv, cG, chd,
                                           w, mk, dt, 90 + i)
            flash_check(torch, card, f"8a flash {dtype} {label} (B={cB} "
                        f"S={cS} Hkv={cHkv} G={cG})", args, dout, w, dtype,
                        cS, cS)
            del args, dout
        for i, (label, arch, cB, cS, w) in enumerate(flash_layer_cases()):
            c = get_config(arch)
            rng = np.random.default_rng(95 + i)
            q, k, v, dout = (
                torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                .to("cuda", dt) for shape in (
                    (cB, cS, c.num_heads, c.head_dim),
                    (cB, cS, c.num_kv_heads, c.head_dim),
                    (cB, cS, c.num_kv_heads, c.head_dim),
                    (cB, cS, c.num_heads, c.head_dim)))
            pos = torch.arange(cS, dtype=torch.int32,
                               device="cuda")[None].expand(cB, cS)
            *args, qc, kc = L._flash_inputs(q, k, v, pos, None)
            dpad = L._flash_inputs(dout, k, v, pos, None)[0]
            del q, k, v, dout
            flash_check(torch, card, f"8a flash {dtype} {label} (B={cB} "
                        f"S={cS} Hq={c.num_heads} Hkv={c.num_kv_heads} "
                        f"hd={c.head_dim} window={w}, as the layer pads it)",
                        args, dpad, w, dtype, qc, kc)
            del args, dpad
            torch.cuda.empty_cache()
    for built in fl_ops.FLASH_HDS:  # (hd is 8a's own head dim)
        for dt in (torch.bfloat16, torch.float32):
            plan = fl_ops.flash_plan(built, dt)
            check(all(p["threads"] <= 1024 and p["smem"] <= 232_448
                      for p in plan.values())
                  and plan["dkdv"]["rows"] == fl_ops.KEY_TILE,
                  f"flash_attn plan at hd {built} {dt}: {plan}")
            log(f"flash_attn plan at hd {built} {dt}: {plan}")
    cfg = get_config("qwen2-1.5b")
    rng = np.random.default_rng(80)
    base = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda()
            for shape in ((B, S, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd),
                          (B, S, Hq, hd))]
    pos = torch.arange(S, dtype=torch.int32, device="cuda")[None].expand(B, S)
    mask = (pos[:, None, :] <= pos[:, :, None])[:, None]  # (B, 1, S, S)
    entries = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        q, k, v = (t.to(dt).requires_grad_() for t in base[:3])
        dout = base[3].to(dt)
        # the kernels' arguments as the layer pads them (8a's own shape)
        *args, qc, kc = L._flash_inputs(q.detach(), k.detach(), v.detach(),
                                        pos, None)
        dpad = L._flash_inputs(dout, k.detach(), v.detach(), pos, None)[0]
        ferr, berr = flash_check(torch, card, f"8a flash {dtype} 8a shape "
                                 f"(B={B} S={S} Hq={Hq} Hkv={Hkv}, as the "
                                 "layer pads it)", args, dpad, 0, dtype, qc,
                                 kc)

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
        # SDPA yardsticks: the same boolean mask, and is_causal (no mask
        # tensor: the route PyTorch's own flash kernel can take); (B, H,
        # S, hd) layout made outside the timing
        qs, ks, vs = (t.detach().transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        ds = dout.transpose(1, 2).contiguous()

        def sdpa(causal):
            if causal:
                return F.scaled_dot_product_attention(
                    qs, ks, vs, is_causal=True, enable_gqa=True)
            return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                  enable_gqa=True)

        def sdpa_fwd():
            with torch.no_grad():
                return sdpa(False)

        so = sdpa(False)

        def sdpa_bwd():
            return torch.autograd.grad(so, (qs, ks, vs), ds,
                                       retain_graph=True)

        def fwd():
            with torch.no_grad():
                return flash()

        def fb():
            return torch.autograd.grad(flash(), (q, k, v), dout)

        kout, klse = fl_ops.flash_fwd_cuda(*args, 0)

        def kfwd():
            return fl_ops.flash_fwd_cuda(*args, 0)

        def kbwd():
            return fl_ops.flash_bwd_cuda(*args, kout, klse, dpad, 0)

        def plain_fwd():
            return fl_ref.flash_fwd_ref(*args, 0, qc, kc)

        def plain_bwd():
            return fl_ref.flash_bwd_ref(*args, kout, klse, dpad, 0, qc, kc)

        def plain_fb():
            o, lse_ = fl_ref.flash_fwd_ref(*args, 0, qc, kc)
            return fl_ref.flash_bwd_ref(*args, o, lse_, dpad, 0, qc, kc)

        def dense_fb():
            return torch.autograd.grad(dense(), (q, k, v), dout)

        res = {}
        for name, fn, reps in (
                ("forward", fwd, 10), ("kernel forward", kfwd, 10),
                ("backward", kbwd, 10),
                ("forward + backward", fb, 10),
                ("plain forward", plain_fwd, 2),
                ("plain backward", plain_bwd, 2),
                ("plain forward + backward", plain_fb, 2),
                ("dense forward + backward", dense_fb, 3),
                ("SDPA (mask) forward", sdpa_fwd, 10),
                ("SDPA (mask) backward", sdpa_bwd, 10),
                ("SDPA (mask) forward + backward",
                 lambda: torch.autograd.grad(sdpa(False), (qs, ks, vs), ds),
                 10),
                ("SDPA (is_causal) forward + backward",
                 lambda: torch.autograd.grad(sdpa(True), (qs, ks, vs), ds),
                 10)):
            res[name] = (timer.ms(fn, reps, warmup=1), peak_mb(torch, fn))
        log(f"_flash {dtype} (B={B} S={S} Hq={Hq} Hkv={Hkv} hd={hd}, causal): "
            f"against dense autograd: forward max |err| {err:.3e} (atol "
            f"{tol['atol']}, rtol {tol['rtol']}), gradients max |err| / max "
            f"|ref|: {', '.join(rel)} (<= {tol['grad']})  ok; "
            + "; ".join(f"{n} {ms:.3f} ms, peak {mb:.0f} MB"
                        for n, (ms, mb) in res.items()) + f"  [{card}]")
        fb_bound = (flash_bound_ms(torch, args, hd, S, False)[0]
                    + flash_bound_ms(torch, args, hd, S, True)[0])
        log(f"_flash {dtype} kernels at 8a: forward + backward "
            f"{res['forward + backward'][0]:.3f} ms against a bound of "
            f"{fb_bound:.3f} ms (bound/time "
            f"{fb_bound / res['forward + backward'][0]:.3f}); "
            f"{res['plain forward + backward'][0] / res['forward + backward'][0]:.1f}"
            f"x the plain version, "
            f"{res['SDPA (mask) forward + backward'][0] / res['forward + backward'][0]:.2f}"
            f"x SDPA with the mask, "
            f"{res['SDPA (is_causal) forward + backward'][0] / res['forward + backward'][0]:.2f}"
            f"x SDPA is_causal (time ratios: above 1 the kernels are faster)"
            f"  [{card}]")
        if dtype == "bfloat16":
            # the kernels' own launches on the layer's padded arguments,
            # beside the plain version's and SDPA's (mask) on the same work
            for name, key, e, bwd in (("flash_attn_fwd", "forward", ferr,
                                       False),
                                      ("flash_attn_bwd", "backward", berr,
                                       True)):
                bound, by = flash_bound_ms(torch, args, hd, S, bwd)
                check(by == "operations", f"{name}: bound by {by}")
                entries[name] = dict(
                    name=name, route="cuda",
                    source="src/repro_torch/csrc/flash_attn.cu",
                    replaces="src/repro/models/layers.py:201 _flash "
                             "(custom_vjp lax.scan, no pallas_call)",
                    max_abs_err=e,
                    ms=res["backward" if bwd else "kernel forward"][0],
                    plain_ms=res[f"plain {key}"][0], bound_ms=bound,
                    bound_by=by, library_ms=res[f"SDPA (mask) {key}"][0])
        del q, k, v, qs, ks, vs, so, args, dpad, kout, klse
        torch.cuda.empty_cache()
    return list(entries.values())


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
        check((launches["flash_attn_fwd"], launches["flash_attn_bwd"])
              == (flash.n, 0),
              f"{where}: {launches['flash_attn_fwd']} flash forward and "
              f"{launches['flash_attn_bwd']} backward launches, expected "
              f"one forward per _flash call ({flash.n}) and none backward")
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


def flash_launch_delta(before, after):
    return (after["flash_attn_fwd"] - before["flash_attn_fwd"],
            after["flash_attn_bwd"] - before["flash_attn_bwd"])


def n_flash_layers(cfg, S):
    """Attention layers whose full-sequence forward at length S takes
    ``_flash_attn_train`` (one flash launch each): every causal self-
    attention layer at S >= 2048; an encoder's layers never do."""
    from repro_torch.models import layers as L

    n = sum(k in ("attn", "local_attn") for k in cfg.layer_kinds)
    return n if S >= L._FLASH_THRESHOLD else 0


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
    n_fl = n_flash_layers(cfg, tokens.shape[1])
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
    ffwd, fbwd = flash_launch_delta(before, read_launches())
    old_fl = before["flash_attn_fwd"]
    check(dev != "cuda" or (old_fl, ffwd, fbwd) == (n_fl, n_fl, n_fl),
          f"{tag}: {old_fl} flash forward launches in compute_old_logprobs,"
          f" {ffwd} forward and {fbwd} backward in the step, expected "
          f"{n_fl} each (one per attention layer)")
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
        rffwd, rfbwd = flash_launch_delta(before, read_launches())
        check(dev != "cuda" or (rffwd, rfbwd) == (2 * n_fl, n_fl),
              f"{tag} remat: {rffwd} forward and {rfbwd} backward flash "
              f"launches, expected {2 * n_fl} and {n_fl}")
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
                 f"backward RG-LRU launches, {rffwd} forward / {rfbwd} "
                 f"backward flash launches, {t_remat:.3f} s")
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
        f"RG-LRU launches; {old_fl} flash forward launches in "
        f"compute_old_logprobs, {ffwd} forward / {fbwd} backward in the "
        f"step; loss + gradients {t_grad:.3f} s, with the AdamW "
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
    spec-verify ones at the 12/2-head shape) and 8a's JSON entries."""
    entries = phase_flash(torch, np, timer, card)
    t0 = time.perf_counter()
    cfg, params = full_width_model(torch, "qwen2-1.5b")
    eng, prompts, pids, outs, l8b = phase_rl_rollouts(torch, np, card, cfg,
                                                      params)
    un, l8c = phase_rl_step(torch, np, card, cfg, params, prompts, outs)
    l8d = phase_rl_after_update(torch, np, card, cfg, params, eng, prompts,
                                pids, un)
    del eng, params
    torch.cuda.empty_cache()
    l8e = phase_trainer(torch, np, card,
                        cfg=cfg.replace(num_layers=TRAINER_LAYERS))
    torch.cuda.empty_cache()
    total = Counter()
    for run in (l8b, l8c, l8d, l8e):
        total.update({k: v for k, v in run.items()
                      if k != "rglru_scan_by_shape"})
    check(total["rglru_scan"] == 0 and total["rglru_scan_bwd"] == 0 and
          total["suffix_match_propose_chunked"] == 0,
          f"phase 8 launched a kernel off its path: {dict(total)}")
    check(total["flash_attn_fwd"] > 0 and total["flash_attn_bwd"] > 0,
          f"phase 8 left a flash kernel unlaunched: {dict(total)}")
    total["spec_verify_attention_qwen2"] = total.pop("spec_verify_attention")
    log(f"phase 8 (8b-8e) in {time.perf_counter() - t0:.1f} s; launches "
        f"{dict(total)}  [{card}]")
    return total, entries


# ---------------------------------------------------------------------------
# phase 9: RecurrentGemma-9B training (published widths, depth cut)
# ---------------------------------------------------------------------------

# Bf16 weights and gradients with float32 moments (12 bytes a parameter:
# no master copy, the reference's rule) of all 38 layers take about 102
# GB, more than the card's 80: phase 9 keeps one (rglru, rglru,
# local_attn) triple, 1.64 B parameters, every width as published (one
# triple rather than two makes room for phase 11 in the script's time:
# 9c's checkpoint is ~15 GiB instead of 20.74).
HYBRID_TRAIN_LAYERS = 3
# The GRPO step's sequence length in 9b (prompts of 2,100 and 2,200 tokens
# and 64 new ones, packed): the backward kernel's training shape.
TRAIN_S = 2272
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
# The backward kernel's tiling (csrc/rglru_bwd.cu): a CTA owns 32 lanes of
# a row and walks chunks of 32 steps through a ring of 2 stages, each six
# 32 x 32 float32 tiles (x, r, i, h_{t-1}, dhs / d, a / the dΛ term) and
# the chunk's 32 mask bytes.
RGLRU_BWD_LANES = 32
RGLRU_BWD_CHUNK = 32
RGLRU_BWD_STAGES = 2
RGLRU_BWD_STAGE_BYTES = 6 * RGLRU_BWD_CHUNK * RGLRU_BWD_LANES * 4 + 32


def rglru_bwd_smem_bytes(T):
    """The backward kernel's dynamic shared memory a CTA at length T: a
    stage a chunk, at most RGLRU_BWD_STAGES."""
    chunks = -(-T // RGLRU_BWD_CHUNK)
    return min(chunks, RGLRU_BWD_STAGES) * RGLRU_BWD_STAGE_BYTES


def rglru_bwd_waves(B, W, ctas_per_sm, n_sm):
    """Waves of the backward kernel's B * ceil(W / 32) CTAs with
    ``ctas_per_sm`` resident on each of ``n_sm`` SMs: each CTA walks all
    of T, so a second wave doubles the kernel's time."""
    ctas = B * -(-W // RGLRU_BWD_LANES)
    return -(-ctas // (ctas_per_sm * n_sm))


def rglru_bwd_bytes(B, T, W, mask):
    """Bytes the backward's result depends on, and the updated steps: x,
    r, i and h_{t-1} at the updated steps, dhs at every step, dx, dr and di
    written at every step (32 bytes a (b, t, w) without a mask), h0,
    dh_final and dh0, Λ and dΛ once, and the mask: the kernel's
    ``bwd_work`` (every step updated) less x, r, i and h_{t-1} at the
    steps this mask skips."""
    from repro_torch.kernels.rglru import ops as rg_ops

    kept = B * T if mask is None else int(mask.sum())
    every = rg_ops.bwd_work(B, T, W, mask is not None)[1]
    return int(every) - 4 * 4 * (B * T - kept) * W, kept


def rglru_bwd_bound_ms(B, T, W, mask):
    from repro_torch.kernels.rglru import ops as rg_ops

    nbytes, kept = rglru_bwd_bytes(B, T, W, mask)
    return roofline_ms(nbytes, rg_ops.BWD_OPS_PER_STEP * kept * W,
                       "float32")


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
    plain_ms = timer.ms(lambda: rglru_scan_bwd_ref(*args), 1, warmup=0)
    bound_ms, bound_by = rglru_bwd_bound_ms(B, T, W, mask)
    log(f"{where}: dx, dr, di, dh0 bit-identical to the plain version, dΛ "
        f"{'bit-identical' if dlam_exact else 'within the tolerance'} (max "
        f"|err| {err:.3e}); kernel {ms * 1e3:.1f} us, plain "
        f"{plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.2f} us "
        f"({bound_by})  [{card}]")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def phase_rglru_bwd(torch, np, timer, card):
    """9a: the backward kernel's ptxas report and resident CTAs a SM at
    the training shape, then the kernel at RGLRU_BWD_CASES after the
    timer's floor, and the forward kernel timed at the training shape.
    Returns the kernels JSON line's entries ``rglru_scan_bwd`` and
    ``rglru_scan_long`` (the forward at T >= 2048), launches set after
    phase 9."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.rglru import ops as rg_ops

    timer_floor(torch, np, timer, card)
    for ln in _build.ptxas_lines("rglru_bwd"):
        log(f"  [rglru_bwd] {ln}")
    _, B, T, W, _ = RGLRU_BWD_CASES[0]  # the training shape
    ctas, smem = rg_ops.rglru_scan_bwd_residency(T)
    check(smem == rglru_bwd_smem_bytes(T), f"rglru_scan_bwd: the kernel "
          f"takes {smem} B of shared memory a CTA, not "
          f"{rglru_bwd_smem_bytes(T)}")
    check(ctas > 0, "rglru_scan_bwd: no CTA fits an SM")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"rglru_scan_bwd at the training shape (B={B} T={T} W={W}): "
        f"{B * -(-W // RGLRU_BWD_LANES)} CTAs, {smem} B of dynamic shared "
        f"memory a CTA, {ctas} resident a SM on {n_sm} SMs: "
        f"{rglru_bwd_waves(B, W, ctas, n_sm)} wave(s)  [{card}]")
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
    with the remat check; 9c, ``Trainer.run``. Returns the JSON entries of
    9a, the launches
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
          and total["suffix_match_propose"] > 0
          and total["flash_attn_fwd"] > 0 and total["flash_attn_bwd"] > 0,
          f"phase 9 left a kernel of its path unlaunched: {dict(total)}")
    check(total["suffix_match_propose_chunked"] == 0,
          f"phase 9 launched the chunked kernel: {dict(total)}")
    total["spec_verify_attention_hd256"] = total.pop("spec_verify_attention")
    log(f"phase 9 (9b-9c, {cfg.num_layers} layers) in "
        f"{time.perf_counter() - t0:.1f} s; launches {dict(total)}; RG-LRU "
        f"forward launches by (B, T) {dict(shapes)}  [{card}]")
    return entries, total, shapes


# ---------------------------------------------------------------------------
# phase 11: the remaining decoder families at their published widths
# ---------------------------------------------------------------------------

# (tag, arch, layers kept (None: all), the JSON entry of its spec-verify
# launches). A depth is cut where the whole model does not fit one card:
# Command R+ 16 of 64 layers (56.6 GB of bf16 weights), Mixtral 16 of 32
# (47.0 GB), Arctic 2 of 35 (55.4 GB: one layer's 128 experts are 26.8
# GB). Widths are the published ones.
FAMILY_CASES = (
    ("11a", "yi-9b", None, "spec_verify_attention_yi"),
    ("11b", "chatglm3-6b", None, "spec_verify_attention_chatglm3"),
    ("11c", "command-r-plus-104b", 16, "spec_verify_attention_command_r"),
    ("11d", "qwen2-vl-2b", None, "spec_verify_attention_qwen2_vl"),
    ("11e", "mixtral-8x7b", 16, "spec_verify_attention_mixtral"),
    ("11f", "arctic-480b", 2, "spec_verify_attention_arctic"),
)
# phase 4's lock-step traffic, shortened: limits of 32 and 64 new tokens
FAMILY_LIMITS = (32, 64)
# a kept MoE call's output against the layer's plain float32 computation
MOE_TOL = dict(atol=3e-2, rtol=1e-2)


def moe_plain(torch, p, x, cfg):
    """The MoE layer's plain float32 computation from its definition (the
    reference's ``apply_moe``), on ``x`` (B, T, d): routing from the
    float32 router (top-k by a stable descending sort: ties to the lower
    expert), a (token, k) pair's slot as its rank among the pairs routed
    to its expert in token-major, k-minor order (counted here by a sort,
    not a cumulative one-hot), pairs at or past the capacity dropped; then
    each routed expert's SwiGLU in float32 on the tokens it kept (one
    expert's weights upcast at a time), weighted by the gates, and the
    dense residual branch. Returns (gate_idx, slot, keep, y float32)."""
    F = torch.nn.functional
    B, T, d = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    N = B * T
    xt = x.reshape(N, d).float()
    probs = torch.softmax(xt @ p["router"].float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_idx = idx[:, :K]
    gates = vals[:, :K]
    gates = (gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)).reshape(-1)
    cap = max(1, int(cfg.capacity_factor * N * K / E))
    e_flat = gate_idx.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(N * K, device=x.device)
    counts = torch.bincount(e_flat, minlength=E)
    slot = rank - (torch.cumsum(counts, 0) - counts)[e_flat]
    keep = slot < cap
    tok = torch.arange(N * K, device=x.device) // K
    y = torch.zeros((N, d), dtype=torch.float32, device=x.device)
    for e in torch.unique(e_flat[keep]).tolist():
        sel = keep & (e_flat == e)
        rows = tok[sel]
        xe = xt[rows]
        h = F.silu(xe @ p["wg"][e].float()) * (xe @ p["wi"][e].float())
        y.index_add_(0, rows, (h @ p["wo"][e].float()) * gates[sel][:, None])
    if cfg.moe_dense_residual:
        dp = p["dense"]
        h = F.silu(xt @ dp["wg"].float()) * (xt @ dp["wi"].float())
        y += h @ dp["wo"].float()
    return gate_idx, slot, keep, y.reshape(B, T, d)


class MoeSpy:
    """Wraps ``models.layers.apply_moe`` (and, inside it, ``moe_route``)
    on the main path: counts the (token, k) pairs each call dropped (on
    the device: no host sync), and keeps the input, output and routing of
    each epoch's first call and of every ``EVERY``-th, to be replayed
    after the run through ``moe_plain``: top-k experts, slots and the kept
    mask equal, the output within ``MOE_TOL``. Adds no launch of a kernel
    under test."""

    EVERY = 64

    def __init__(self):
        from repro_torch.models import layers as L

        self.L = L
        self.real = L.apply_moe
        self.real_route = L.moe_route
        self.kept = []
        self.n = 0
        self.first = True
        self.route = None
        self.dropped = 0
        self.pairs = 0

    def new_epoch(self):
        self.first = True

    def _route(self, p, xt, cfg):
        self.route = self.real_route(p, xt, cfg)
        return self.route

    def __call__(self, p, x, cfg):
        y, aux = self.real(p, x, cfg)
        r = self.route
        self.dropped = self.dropped + (~r.keep).sum()
        self.pairs += r.keep.numel()
        if self.first or self.n % self.EVERY == 0:
            self.kept.append((p, x.clone(), y.clone(), r.gate_idx.clone(),
                              r.slot.clone(), r.keep.clone()))
        self.n += 1
        self.first = False
        return y, aux

    def __enter__(self):
        self.L.apply_moe = self
        self.L.moe_route = self._route
        return self

    def __exit__(self, *exc):
        self.L.apply_moe = self.real
        self.L.moe_route = self.real_route

    def check(self, torch, card, cfg, where):
        check(len(self.kept) >= 2,
              f"{where}: only {len(self.kept)} MoE calls kept")
        worst = 0.0
        kept_drop = kept_pairs = 0
        shapes = set()
        for p, x, y, gate_idx, slot, keep in self.kept:
            g2, s2, k2, want = moe_plain(torch, p, x, cfg)
            check(torch.equal(gate_idx, g2),
                  f"{where}: a kept MoE call's top-k experts differ from "
                  "the plain computation's")
            check(torch.equal(slot, s2) and torch.equal(keep, k2),
                  f"{where}: a kept MoE call's capacity slots differ from "
                  "the plain computation's")
            err = float((y.float() - want).abs().max())
            check(bool(torch.isfinite(y).all()) and torch.allclose(
                y.float(), want, **MOE_TOL),
                f"{where}: a kept MoE call's output differs from the plain "
                f"float32 computation, max |err| {err}")
            worst = max(worst, err)
            kept_drop += int((~keep).sum())
            kept_pairs += keep.numel()
            shapes.add(tuple(x.shape[:2]))
        dropped = int(self.dropped)
        log(f"{where}: {len(self.kept)} of {self.n} apply_moe calls kept "
            f"(each epoch's first, every {self.EVERY}th; (B, T) "
            f"{sorted(shapes)}): top-k experts, capacity slots and kept "
            f"masks equal to the plain computation's, outputs within "
            f"{MOE_TOL} of its float32 result, max |err| {worst:.3e}; "
            f"(token, k) pairs dropped at capacity: {dropped} of "
            f"{self.pairs} ({dropped / max(self.pairs, 1):.2%}) on the "
            f"path, {kept_drop} of {kept_pairs} in the kept calls  [{card}]")
        self.kept.clear()
        self.dropped, self.pairs, self.n = 0, 0, 0
        return worst


def phase_family(torch, np, card, cfg, params, tag, dev="cuda",
                 serve=False, limits=FAMILY_LIMITS, prompt_len=(128, 256)):
    """11a-11f: one family at its published widths through the normal
    entry points: phase 4's lock-step traffic with ``limits`` (and
    with ``serve``, 16 requests over 8 problems in 8 slots through
    ``SpecEngine.serve``, chunked forest, two epochs). Gated on the card
    as phase 4: the drafting kernel's kept launches bit-identical,
    spec-verify once per attention layer per verify round and its kept
    launches within the bf16 tolerance, epoch 2 accepting drafts. A
    dense family's epoch 2 equals epoch 1 and every token is plain
    greedy's within ``TOL_LOGIT_BF16``; an MoE family's witness is the
    layer itself (``MoeSpy``): with capacity dropping, a token depends on
    the other tokens of its forward, so neither epoch identity nor plain
    greedy's full-sequence forward can witness it. Returns the launches
    (summed over the runs) and the spec-verify spy (its path case kept
    for timing)."""
    moe = cfg.num_experts > 0
    sv = SvSpy()
    spies = (MoeSpy(),) if moe else ()
    launches = Counter()
    run, _, epochs = phase_main_path(
        torch, np, card, cfg, params, limits=limits, dev=dev, sv_spy=sv,
        spies=spies, tag=tag, prompt_len=prompt_len)
    launches.update({k: v for k, v in run.items()
                     if k != "rglru_scan_by_shape"})
    where = f"{tag} {cfg.name}"
    if moe:
        spies[0].check(torch, card, cfg, f"{where} lock-step")
    else:
        prompts, _ = lockstep_requests(np, cfg.vocab_size, prompt_len)
        plain_greedy_full_width(torch, np, cfg, params, prompts,
                                {"lock-step epoch 1": epochs[0][0]}, card)
    if serve:
        by_layout, _, _, _, _ = continuous_layouts(
            torch, np, cfg, params, dev, card, slots=8, n_problems=8,
            n_requests=16, limits=limits, prompt_len=prompt_len,
            layouts=("chunked",), lockstep=False, sv_spy=sv, spies=spies)
        launches.update({k: v for k, v in by_layout["chunked"].items()
                         if k != "rglru_scan_by_shape"})
        if moe:
            spies[0].check(torch, card, cfg, f"{where} continuous")
    if dev == "cuda":
        torch.cuda.empty_cache()
    return launches, sv


def phase_vlm(torch, np, card, cfg, params, dev="cuda", B=4, S=1024,
              tag="11d"):
    """11d's extra: the Qwen2-VL backbone over stub vision embeddings (B
    4, S 1,024) with three distinct M-RoPE position streams (t, and h and
    w over a 32-wide grid): bf16 logits finite and within
    ``TOL_LOGIT_BF16`` of the same forward on the weights upcast to
    float32; M-RoPE on text positions gives the same logits as standard
    RoPE, bit for bit; then one GRPO step on that batch: the surrogate at
    ratio 1, every gradient finite and every attention layer's wq/wk/wv
    gradient non-zero, the update norm, a lower surrogate after it."""
    import copy

    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.rl import grpo

    rng = np.random.default_rng(111)
    dt = getattr(torch, cfg.dtype)
    embeds = torch.tensor(0.02 * rng.normal(size=(B, S, cfg.d_model)),
                          dtype=torch.float32, device=dev).to(dt)
    ar = np.arange(S)
    pos3 = torch.tensor(np.broadcast_to(np.stack([ar, ar // 32, ar % 32])[
        :, None], (3, B, S)).copy(), dtype=torch.int32, device=dev)
    tok = torch.tensor(rng.integers(2, cfg.vocab_size, size=(B, S)),
                       dtype=torch.int32, device=dev)
    V = cfg.vocab_size
    t0 = time.perf_counter()
    with torch.inference_mode():
        lg = M.forward(params, cfg, embeds=embeds,
                       mrope_positions=pos3)[0][..., :V]
        check(tuple(lg.shape) == (B, S, V) and bool(torch.isfinite(lg).all()),
              f"{tag}: embeds forward logits not finite or of a wrong shape")
        p32 = copy.deepcopy(params).float()
        lg32 = M.forward(p32, cfg.replace(dtype="float32"), embeds=embeds,
                         mrope_positions=pos3)[0][..., :V]
        del p32
        diff = (lg - lg32).abs()
        err, mean = float(diff.max()), float(diff.mean())
        del lg, lg32, diff
        text = tok[:2, :256]
        std = M.forward(params, cfg.replace(rope="standard"), text)[0]
        mro = M.forward(params, cfg, text)[0]
        same = torch.equal(std, mro)
        del std, mro
    sync(torch, dev)
    check(err <= TOL_LOGIT_BF16, f"{tag}: bf16 logits over embeds differ "
          f"from the float32 forward's by {err:.4f}")
    check(same, f"{tag}: M-RoPE on text positions differs from standard "
          "RoPE")
    log(f"{cfg.name} {tag} forward over stub embeds (B={B}, S={S}, three "
        f"position streams): bf16 logits within {err:.4f} (mean "
        f"{mean:.2e}) of the float32 forward's (tolerance "
        f"{TOL_LOGIT_BF16}); M-RoPE on text positions equal to standard "
        f"RoPE bit for bit; {time.perf_counter() - t0:.2f} s  [{card}]")

    M.set_trainable(params)
    plen = rng.integers(S // 4, S // 2, size=B)
    resp = np.zeros((B, S), bool)
    for b in range(B):
        resp[b, plen[b]:plen[b] + int(rng.integers(S // 8, S - plen[b]))] = True
    adv = rng.normal(size=B).astype(np.float32)
    with torch.no_grad():
        hid = M.forward(params, cfg, tok, embeds=embeds,
                        mrope_positions=pos3, return_hidden=True)[0]
        old = grpo.chunked_token_logprobs(params, cfg, hid, tok)
        del hid
    batch = {"tokens": tok, "resp_mask": torch.tensor(resp, device=dev),
             "advantages": torch.tensor(adv, device=dev),
             "old_logprobs": old, "embeds": embeds,
             "mrope_positions": pos3}
    ocfg = adamw.AdamWConfig(lr=STEP_LR)
    opt = adamw.init_state(params)
    gcfg = grpo.GRPOConfig()
    sync(torch, dev)
    t0 = time.perf_counter()
    loss, metrics = grpo.grpo_loss(params, cfg, gcfg, batch)
    grads = grpo.param_grads(params, loss)
    loss = float(loss.detach())
    params, opt, om = adamw.apply_updates(ocfg, params, grads, opt)
    sync(torch, dev)
    t_step = time.perf_counter() - t0
    want = float(-(adv[:, None] * resp).sum() / resp.sum())
    check(abs(loss - want) <= SURROGATE_RTOL * abs(want),
          f"{tag}: surrogate {loss} at ratio 1, expected {want}")
    bad = [k for k, g in grads.items() if not bool(torch.isfinite(g).all())]
    check(not bad, f"{tag}: non-finite gradients in {bad[:4]}")
    check_layer_grads(cfg, grads, tag)
    gn, lr, un = (float(om[k]) for k in ("grad_norm", "lr", "update_norm"))
    un_want = lr * min(1.0, ocfg.grad_clip / gn) * gn
    check(np.isfinite(gn) and gn > 0 and abs(un - un_want) <= 1e-5 * un_want,
          f"{tag}: grad_norm {gn}, update_norm {un} (expected {un_want})")
    del grads, opt
    with torch.no_grad():
        after = float(grpo.grpo_loss(params, cfg, gcfg, batch)[0])
    check(after < loss, f"{tag}: surrogate after the step {after} is not "
          f"below {loss}")
    log(f"{cfg.name} {tag} GRPO step over the embeds batch ({int(resp.sum())}"
        f" response tokens): surrogate {loss:.6f} at ratio 1 (expected "
        f"{want:.6f}), after the step {after:.6f}; grad_norm {gn:.4f}, "
        f"update_norm {un:.6f}; every gradient finite; loss + gradients + "
        f"AdamW {t_step:.3f} s  [{card}]")


def phase_families(torch, np, card, timer, err_3a):
    """Phase 11: each of ``FAMILY_CASES`` in turn, one model resident at a
    time. Returns the JSON entries of the families' spec-verify launches
    (timed on each run's kept launches) and the launches of the other
    kernels, summed."""
    entries, launches = [], Counter()
    for tag, arch, layers, name in FAMILY_CASES:
        t0 = time.perf_counter()
        cfg, params = full_width_model(torch, arch, layers)
        run, sv = phase_family(torch, np, card, cfg, params, tag,
                               serve=arch == "mixtral-8x7b")
        if cfg.rope == "mrope":
            phase_vlm(torch, np, card, cfg, params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        e = time_sv_path_case(torch, np, timer, card, sv, name,
                              f"{tag} {cfg.name}", err_3a.get(name, 0.0))
        e["launches"] = run.pop("spec_verify_attention")
        entries.append(e)
        launches.update(run)
        del sv
        log(f"{tag} {cfg.name}: {time.perf_counter() - t0:.1f} s  [{card}]")
    return entries, launches



# ---------------------------------------------------------------------------
# phase 12: xLSTM-125M and the SeamlessM4T-medium encoder-decoder
# ---------------------------------------------------------------------------

# 12b: 12a's lock-step traffic in float32 on xLSTM-125M's first 4 of 12
# layers (two mLSTM/sLSTM pairs; the cut keeps the script's time)
XLSTM_F32_LAYERS = 4
# 12c: B 4 stub utterances of 1,024 frames (the reference's workloads'
# S_ENC, src/repro/launch/workloads.py:33), a 32-token prompt and 64
# greedy steps through the ring and the cross cache; its float32 rerun on
# the first 2 of the 12 encoder and of the 12 decoder layers
SEAMLESS_S_ENC = 1024
SEAMLESS_PROMPT = 32
SEAMLESS_STEPS = 64
SEAMLESS_F32_LAYERS = 2
# 12c's ring: the prompt and the steps (max_len), plus the trash slot
SEAMLESS_RING = SEAMLESS_PROMPT + SEAMLESS_STEPS + 1


def greedy_witness_batched(torch, np, cfg, params, triples, card, tol,
                           where, ref_params=None):
    """Each (label, prompt, output) of ``triples`` against plain greedy
    decoding: full-sequence forwards (no cache, the RG-LRU scan's plain
    version) over prompt + output, all sequences right-padded into one
    batch (a position's logits see only its prefix), the head applied
    per row at the positions that emitted. With ``tol`` a token may fall
    at most ``tol`` short of the top logit there (0: it is the argmax);
    with ``tol`` None the shortfalls are only reported. ``ref_params``
    (the same weights upcast to float32) runs the same forward again and
    reports how far the model's own logits move between the two
    precisions at those positions: the bf16 noise floor of a witness. An
    output that is a prefix of another one checked for the same prompt
    is covered by it. Logs, per label, the tokens, how many are the top,
    the largest shortfall and the smallest top-2 gap; returns the
    largest shortfall."""
    from repro_torch.models import model as M

    seqs = {}  # prompt -> the longest outputs, none a prefix of another
    for _, p, o in triples:
        have = seqs.setdefault(tuple(p), [])
        if any(h[:len(o)] == list(o) for h in have):
            continue
        have[:] = [h for h in have if list(o)[:len(h)] != h] + [list(o)]
    rows = [(p, o) for p, outs in seqs.items() for o in outs if o]
    dev = params.embed.device
    T = max(len(p) + len(o) for p, o in rows)
    x = torch.zeros((len(rows), T), dtype=torch.int32, device=dev)
    for b, (p, o) in enumerate(rows):
        x[b, :len(p) + len(o)] = torch.tensor(list(p) + o, dtype=torch.int32)

    def emitted_logits(prm, c):
        with torch.inference_mode(), plain_rglru_scan():
            hidden, _ = M.forward(prm, c, x, return_hidden=True)
            return [M.head(prm, c, hidden[b:b + 1, len(p) - 1:
                                         len(p) - 1 + len(o)])
                    [0, :, :c.vocab_size].float()
                    for b, (p, o) in enumerate(rows)]

    lgs = emitted_logits(params, cfg)
    res = {}
    for lg, (p, o) in zip(lgs, rows):
        top2 = torch.topk(lg, 2, dim=-1).values
        chosen = lg.gather(1, torch.tensor(o, device=dev)[:, None])[:, 0]
        res[(tuple(p), tuple(o))] = (
            (top2[:, 0] - chosen).cpu().numpy(),
            (top2[:, 0] - top2[:, 1]).cpu().numpy())
    if ref_params is not None:
        spread = max(float((a - b).abs().max()) for a, b in zip(
            lgs, emitted_logits(ref_params, ref_params.cfg)))
        log(f"{where}: the same forward on the weights upcast to float32 "
            f"moves the logits at the emitted positions by up to "
            f"{spread:.4f}: the model's own {cfg.dtype} noise  [{card}]")
    worst = 0.0
    by_label = {}
    for label, p, o in triples:
        if not o:
            continue
        sf, gap = next(v for (pp, oo), v in res.items()
                       if pp == tuple(p) and oo[:len(o)] == tuple(o))
        by_label.setdefault(label, []).append((sf[:len(o)], gap[:len(o)]))
    for label, parts in by_label.items():
        sf = np.concatenate([a for a, _ in parts])
        gap = np.concatenate([g for _, g in parts])
        mx = float(sf.max(initial=0.0))
        worst = max(worst, mx)
        log(f"{where}: plain greedy ({cfg.dtype}, {len(rows)} sequences in "
            f"one forward) vs {label}: {sf.size} tokens, "
            f"{int((sf == 0).sum())} the top logit, largest shortfall "
            f"{mx:.4f} ({'reported' if tol is None else f'tolerance {tol}'}"
            f"), smallest top-2 gap {float(gap.min()):.2e}  [{card}]")
    if tol is not None:
        check(worst <= tol, f"{where}: a token falls {worst:.4f} short of "
              f"plain greedy's top logit (tolerance {tol})")
    return worst


def profile_verify_forward(torch, np, cfg, params, dev, card, where, B=8,
                           T=VERIFY_T, prompt=128):
    """The model's part of one verify round at the path's shape, alone:
    B prompts prefilled, then a (B, T) block forward with staged states
    and their gather at per-row acceptance counts. On the card its kernel
    launches are counted by ``torch.profiler`` (CUDA kernel events) and
    its wall is the median of 5 synchronized runs; everywhere the aten
    ops it dispatches are counted."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models import model as M

    class OpCount(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    g = torch.Generator(device=dev).manual_seed(5)
    toks = torch.randint(2, cfg.vocab_size, (B, prompt), generator=g,
                         device=dev)
    block = torch.randint(2, cfg.vocab_size, (B, T), generator=g, device=dev)
    valid = torch.ones((B, T), dtype=torch.bool, device=dev)
    n_commit = torch.arange(B, device=dev) % (T + 1)
    with torch.inference_mode():
        _, cache = M.prefill(params, cfg, toks,
                             torch.ones((B, prompt), dtype=torch.bool,
                                        device=dev), max_len=prompt + 2 * T)

        def one():
            _, staged = M.forward(params, cfg, block, cache=cache,
                                  valid=valid, collect_states=True)
            M.commit_staged_cache(cfg, cache, staged, n_commit)

        one()
        with OpCount() as oc:
            one()
        kernels, walls = "not measured", []
        if dev == "cuda":
            from torch.profiler import ProfilerActivity, profile

            try:  # instrumentation only: a tracer that fails says so
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    one()
                    torch.cuda.synchronize()
                n_k = sum(1 for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA)
                kernels = (str(n_k) if n_k
                           else "not measured (no device events)")
            except RuntimeError as exc:
                kernels = f"not measured (profiler: {exc})"
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                one()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
    wall = (f"{float(np.median(walls)) * 1e3:.2f} ms (median of 5)"
            if walls else "not measured")
    log(f"{where}: one verify forward (B {B}, T {T}, staged states and "
        f"their gather): {oc.n} aten ops dispatched, {kernels} kernel "
        f"launches, wall {wall}  [{card}]")
    return oc.n


def phase_xlstm(torch, np, card, cfg, params, dev="cuda",
                limits=FAMILY_LIMITS, prompt_len=(128, 256), slots=8,
                n_problems=8, n_requests=16):
    """12a: xLSTM-125M (all 12 layers, bf16) through the normal entry
    points: phase 4's lock-step traffic with ``limits`` (flat forest) and
    11e's continuous traffic (``n_requests`` over ``n_problems`` in
    ``slots`` slots, chunked forest), two epochs each, gated as phase 4:
    the drafting kernels' kept launches bit-identical, epoch 2 equal to
    epoch 1 and accepting drafts. The model has no attention layer, so
    spec-verify must launch exactly zero times (stated, not skipped).
    The continuous run's epochs are compared (reported). Every token's
    shortfall from plain greedy's top by a full-sequence forward is
    reported, not gated, beside that forward's own move on the weights
    upcast to float32: on an H100 it reached 3.83 logit, so no bf16
    witness of a fixed tolerance holds for xLSTM (12b is the exact one).
    Logs the wall a round and one verify forward's launches. Returns the
    launches, summed over the runs."""
    where = f"12a {cfg.name}"
    launches = Counter()
    run, _, epochs = phase_main_path(
        torch, np, card, cfg, params, limits=limits, dev=dev, tag="12a",
        prompt_len=prompt_len)
    launches.update({k: v for k, v in run.items()
                     if k != "rglru_scan_by_shape"})
    by_layout, c_runs, c_prompts, _, _ = continuous_layouts(
        torch, np, cfg, params, dev, card, slots=slots,
        n_problems=n_problems, n_requests=n_requests, limits=limits,
        prompt_len=prompt_len, layouts=("chunked",), lockstep=False)
    launches.update({k: v for k, v in by_layout["chunked"].items()
                     if k != "rglru_scan_by_shape"})
    if dev == "cuda":
        check(launches["spec_verify_attention"] == 0,
              f"{where}: spec-verify launched "
              f"{launches['spec_verify_attention']} times without an "
              "attention layer")
        check(launches["suffix_match_propose"] > 0
              and launches["suffix_match_propose_chunked"] > 0,
              f"{where}: a drafting kernel never launched")
    same = sum(a == b for a, b in zip(c_runs[0]["outputs"],
                                      c_runs[1]["outputs"]))
    log(f"{where} continuous: {same} of {len(c_runs[0]['outputs'])} epoch-2 "
        f"outputs equal epoch 1's  [{card}]")
    prompts, _ = lockstep_requests(np, cfg.vocab_size, prompt_len)
    triples = [(f"lock-step epoch {e + 1}", p, o)
               for e, (outs, _, _) in enumerate(epochs)
               for p, o in zip(prompts, outs)]
    triples += [(f"continuous epoch {e + 1}", p, o)
                for e, r in enumerate(c_runs)
                for p, o in zip(c_prompts, r["outputs"])]
    # reported, not gated: xLSTM amplifies a bf16 rounding past any logit
    # tolerance (the float32 forward on the same weights is the noise
    # floor logged beside it); 12b is the exact witness
    ref = copy.deepcopy(params).float()
    ref.cfg = cfg.replace(dtype="float32")
    greedy_witness_batched(torch, np, cfg, params, triples, card, None,
                           where, ref_params=ref)
    del ref
    for label, st, wall in (
            [(f"lock-step epoch {e + 1}", s_, w) for e, (_, s_, w)
             in enumerate(epochs)]
            + [(f"continuous epoch {e + 1}", r["stats"], r["wall"])
               for e, r in enumerate(c_runs)]):
        log(f"{where} {label}: {st.n_rounds} rounds, "
            f"{wall / max(st.n_rounds, 1) * 1e3:.2f} ms a round  [{card}]")
    profile_verify_forward(torch, np, cfg, params, dev, card, where)
    return launches


def phase_xlstm_f32(torch, np, card, cfg, params, dev="cuda",
                    limits=FAMILY_LIMITS, prompt_len=(128, 256)):
    """12b: 12a's lock-step traffic in float32 (the caller cuts the depth
    and upcasts): epoch 2 equals epoch 1 (``phase_main_path``) and every
    token is plain greedy's argmax, DAS's output identity, exact; then
    the two commit schemes on the card: staged states gathered at
    n_commit (``commit_staged_cache``, the serving path) equal, bit for
    bit, a ``commit_upto`` forward's committed carry (the reference's
    dual carry) in every layer, n_commit from 0 to T. Returns the
    launches."""
    from repro_torch.models import model as M

    where = f"12b {cfg.name}"
    run, _, epochs = phase_main_path(
        torch, np, card, cfg, params, limits=limits, dev=dev, tag="12b",
        prompt_len=prompt_len)
    prompts, _ = lockstep_requests(np, cfg.vocab_size, prompt_len)
    greedy_witness_batched(
        torch, np, cfg, params,
        [(f"lock-step epoch {e + 1}", p, o)
         for e, (outs, _, _) in enumerate(epochs)
         for p, o in zip(prompts, outs)], card, 0.0, where)
    B, T = len(prompts), VERIFY_T
    Tp = max(map(len, prompts))
    toks = torch.zeros((B, Tp), dtype=torch.int32, device=dev)
    mask = torch.zeros((B, Tp), dtype=torch.bool, device=dev)
    for b, p in enumerate(prompts):
        toks[b, Tp - len(p):] = torch.tensor(p, dtype=torch.int32)
        mask[b, Tp - len(p):] = True
    g = torch.Generator(device=dev).manual_seed(9)
    block = torch.randint(2, cfg.vocab_size, (B, T), generator=g, device=dev)
    valid = torch.ones((B, T), dtype=torch.bool, device=dev)
    valid[-1] = False  # a frozen row
    n_commit = torch.tensor([0, 1, 5, 9, 13, 16, T, 0], device=dev)[:B]
    with torch.inference_mode():
        caches = [M.prefill(params, cfg, toks, mask, max_len=Tp + 2 * T)[1]
                  for _ in range(2)]
        la, staged = M.forward(params, cfg, block, cache=caches[0],
                               valid=valid, collect_states=True)
        M.commit_staged_cache(cfg, caches[0], staged, n_commit)
        lb, _ = M.forward(params, cfg, block, cache=caches[1], valid=valid,
                          commit_upto=n_commit)
    check(torch.equal(la, lb), f"{where}: the staged and the committed "
          "forwards' logits differ")
    for li, (a, b) in enumerate(zip(caches[0].layers, caches[1].layers)):
        for key in a:
            check(torch.equal(a[key], b[key]),
                  f"{where}: layer {li} {key}: the staged states gathered "
                  "at n_commit differ from commit_upto's committed carry")
    log(f"{where}: staged states gathered at n_commit {n_commit.tolist()} "
        f"equal commit_upto's committed carry bit for bit in all "
        f"{len(caches[0].layers)} layers ({', '.join(sorted(a))} of the "
        f"last)  [{card}]")
    return {k: v for k, v in run.items() if k != "rglru_scan_by_shape"}


def seamless_decode(torch, np, cfg, params, dev, card, where, spy,
                    enc_embeds, enc_mask, toks, steps):
    """``encode`` → ``build_cross_cache`` → ``prefill(enc_out=)`` of the
    prompt ``toks`` → ``steps`` greedy steps of one token through the
    ring cache and the cross cache, under ``spy`` (spec-verify, one
    launch per decoder layer a step). Then one full ``forward(enc_out=)``
    over prompt + generated tokens. Returns the generated tokens (B,
    steps), the cached logits at the positions P-1 .. P+steps-1 and the
    full forward's there (B, steps+1, vocab) float32, the launches of
    the steps and the wall a step."""
    from repro_torch.models import model as M

    B, P = toks.shape
    with torch.inference_mode():
        enc_out = M.encode(params, cfg, enc_embeds, enc_mask)
        check(tuple(enc_out.shape) == (B, enc_embeds.shape[1], cfg.d_model)
              and bool(torch.isfinite(enc_out).all()),
              f"{where}: encoder output {tuple(enc_out.shape)} not finite "
              "or misshapen")
        cross = M.build_cross_cache(params, cfg, enc_out)
        last, cache = M.prefill(params, cfg, toks,
                                torch.ones_like(toks, dtype=torch.bool),
                                max_len=P + steps, enc_out=enc_out,
                                enc_mask=enc_mask)
        one = torch.ones((B, 1), dtype=torch.bool, device=dev)
        step_logits, out = [last[:, :cfg.vocab_size]], []
        reset_launches()
        sync(torch, dev)
        t0 = time.perf_counter()
        with spy:
            spy.new_epoch()
            for _ in range(steps):
                nxt = step_logits[-1].argmax(-1).to(torch.int32)
                out.append(nxt)
                lg, cache = M.forward(params, cfg, nxt[:, None], cache=cache,
                                      valid=one, cross_cache=cross,
                                      enc_mask=enc_mask)
                cache.lengths += 1
                step_logits.append(lg[:, 0, :cfg.vocab_size])
        sync(torch, dev)
        wall = (time.perf_counter() - t0) / steps
        launches = read_launches()
        gen = torch.stack(out, 1)
        hidden, _ = M.forward(params, cfg, torch.cat([toks, gen], 1),
                              enc_out=enc_out, enc_mask=enc_mask,
                              return_hidden=True)
        full = M.head(params, cfg, hidden[:, P - 1:])[..., :cfg.vocab_size]
        cached = torch.stack(step_logits, 1)
    check(bool(torch.isfinite(cached).all() and torch.isfinite(full).all()),
          f"{where}: non-finite logits")
    return gen, cached, full, launches, wall


def phase_seamless(torch, np, card, cfg, params, dev="cuda", B=4,
                   S_enc=SEAMLESS_S_ENC, prompt=SEAMLESS_PROMPT,
                   steps=SEAMLESS_STEPS, f32_layers=SEAMLESS_F32_LAYERS):
    """12c: SeamlessM4T-medium's encoder over B stub utterances of
    ``S_enc`` frames (the last row's mask cut to three quarters), its
    cross cache, a ``prompt``-token prefill and ``steps`` greedy steps
    (``seamless_decode``), in bf16: spec-verify once per decoder layer a
    step, its kept launches (one or more a step, every ``EVERY``-th)
    within the bf16 tolerance of the plain version; the cached logits
    within ``TOL_LOGIT_BF16`` of the full forward's and every greedy token
    within it of the full forward's top. Then the same on the model cut to
    its first ``f32_layers`` encoder and decoder layers and upcast to
    float32 (in place): the tokens equal the full forward's argmax at
    every step. Returns the bf16 and the float32 runs' spec-verify spies
    and launches."""
    from torch import nn

    where = f"12c {cfg.name}"
    g = torch.Generator(device=dev).manual_seed(12)
    enc = torch.randn((B, S_enc, cfg.d_model), generator=g, device=dev)
    enc_mask = torch.ones((B, S_enc), dtype=torch.bool, device=dev)
    enc_mask[-1, 3 * S_enc // 4:] = False  # a shorter utterance
    toks = torch.randint(2, cfg.vocab_size, (B, prompt), generator=g,
                         device=dev, dtype=torch.int32)
    n_attn = sum(k in ("attn", "local_attn") for k in cfg.layer_kinds)
    out = {}
    for dtype in ("bf16", "float32"):
        if dtype == "float32":
            params.layers = nn.ModuleList(list(params.layers)[:f32_layers])
            params.encoder = nn.ModuleList(list(params.encoder)[:f32_layers])
            params.float()
            params.cfg = cfg = cfg.replace(
                num_layers=f32_layers, num_encoder_layers=f32_layers,
                dtype="float32")
            n_attn = f32_layers
            gc.collect()
            if dev == "cuda":
                torch.cuda.empty_cache()
        tag = f"{where} ({cfg.dtype}, {cfg.num_encoder_layers}+" \
              f"{cfg.num_layers} layers)"
        spy = SvSpy()
        spy.EVERY = n_attn - 1 if n_attn > 1 else 1
        gen, cached, full, launches, wall = seamless_decode(
            torch, np, cfg, params, dev, card, tag, spy, enc, enc_mask, toks,
            steps)
        diff = float((cached - full).abs().max())
        top2 = torch.topk(full[:, :-1], 2, dim=-1).values
        chosen = full[:, :-1].gather(-1, gen.long()[..., None])[..., 0]
        sf = float((top2[..., 0] - chosen).max())
        gap = float((top2[..., 0] - top2[..., 1]).min())
        log(f"{tag}: encoder over B {B} x {S_enc} frames, {prompt}-token "
            f"prompt, {steps} greedy steps at {wall * 1e3:.2f} ms a step; "
            f"cached logits vs the full forward: max |diff| {diff:.4f}; "
            f"greedy tokens' shortfall from the full forward's top "
            f"{sf:.4f}, smallest top-2 gap {gap:.2e}; launches "
            f"{ {k: v for k, v in launches.items() if v and k != 'rglru_scan_by_shape'} }  [{card}]")
        if dtype == "bf16":
            check(diff <= TOL_LOGIT_BF16 and sf <= TOL_LOGIT_BF16,
                  f"{tag}: the cached decode departs from the full forward "
                  f"(max |diff| {diff:.4f}, shortfall {sf:.4f}; tolerance "
                  f"{TOL_LOGIT_BF16})")
        else:
            check(sf == 0.0, f"{tag}: a greedy token is not the full "
                  f"forward's argmax (shortfall {sf:.3e})")
        if dev == "cuda":
            check(launches["spec_verify_attention"] == n_attn * steps,
                  f"{tag}: {launches['spec_verify_attention']} spec-verify "
                  f"launches, expected {n_attn} decoder layers x {steps} "
                  "steps")
            spy.check(torch, card, tag)
        out[dtype] = (spy, launches["spec_verify_attention"])
    return out


# ---------------------------------------------------------------------------
# phase 13: the launch tooling's count beside the card
# ---------------------------------------------------------------------------

# The per-device share of each workload's global batch over the production
# mesh's 16-way data axis: decode_32k and verify_8 (128), train_4k (256).
P13_BATCH = 8
P13_TRAIN_BATCH = 16
# 13c's batch, cut from 16: SeamlessM4T's step at B 16 and B 14 ran out
# of an NVIDIA H100 80GB HBM3's memory (700 W; the dry run counts 83.06
# GB at B 16, 64.62 at 12: the 256,512-entry head's float32 logits chunks
# and the encoder's saved scores grow with B); B 12 fits (B 13 untried).
# Counted with the flash kernels' work in place of the plain tiles, the
# peaks are the same (the tiles were never at the peak), so B 16 stays
# past the card even before the dry run's known undercount
SEAMLESS_TRAIN_BATCH = 12
# 13b's sequence: train_4k's own 4,096 (each mLSTM and sLSTM layer one
# forward kernel launch, one more in remat's recompute and one backward).
XLSTM_TRAIN_S = 4096
P13_REPS = 7  # timed calls a step (the median is kept), after 2 warm-ups
P13_LEAD_US = 50_000  # device wait before a whole step's start event


def p13_jobs():
    """{key: (arch, shape)} of the steps phase 13 counts: 13a's decode_32k
    and verify_8, 13b's and 13c's train steps."""
    from repro_torch.launch import workloads as W

    return {
        "decode_32k": ("qwen3-8b", W.with_batch(W.SHAPES["decode_32k"],
                                                P13_BATCH)),
        "verify_8": ("qwen3-8b", W.with_batch(W.SHAPES["verify_8"],
                                              P13_BATCH)),
        "13b": ("xlstm-125m", W.InputShape("train_4k", XLSTM_TRAIN_S,
                                           P13_TRAIN_BATCH, "train")),
        "13c": ("seamless-m4t-medium", W.InputShape(
            "train_4k", 4096, SEAMLESS_TRAIN_BATCH, "train")),
    }


def start_p13_counts():
    """Start the dry run's counts of ``p13_jobs`` in a process of their
    own: they need no card and take seconds of one core, which then
    overlap phases 1-12.
    Returns (the executor, {key: future of the record}); the caller shuts
    the executor down (so does the interpreter's exit, if a phase fails
    first)."""
    import concurrent.futures
    import multiprocessing

    ex = concurrent.futures.ProcessPoolExecutor(
        max_workers=1, mp_context=multiprocessing.get_context("spawn"))
    return ex, {key: ex.submit(p13_counted, arch, shape)
                for key, (arch, shape) in p13_jobs().items()}


def p13_counted(arch, shape, cfg=None):
    """The dry run's record for ``shape`` on the one card's mesh (of
    ``cfg`` where given, else of ``arch``'s published config)."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_local_mesh

    rec = D.dry_run_one(arch, shape.name, mesh=make_local_mesh(),
                        shape=shape, verbose=False, cfg_override=cfg)
    check(rec["status"] == "ok", f"dry run of {arch} {shape}: {rec}")
    return rec


def counted_line(rec):
    """A dry-run record's counted terms (NVIDIA H100 data-sheet peaks).
    Its bytes are the port's eager traffic: every op's operands and
    results (the slice gradients among them; the hand-written kernels'
    reported work in their place), not the least a step must move (the
    phases' floor)."""
    return (f"counted eager traffic: {rec['total_flops'] / 1e12:.3f} TFLOP,"
            f" {rec['total_bytes'] / 1e9:.2f} GB, t_compute "
            f"{rec['t_compute_s'] * 1e3:.3f} ms, t_memory "
            f"{rec['t_memory_s'] * 1e3:.3f} ms ({rec['dominant']}), "
            f"peak_memory {rec['peak_memory'] / 1e9:.2f} GB "
            f"({rec['bytes_per_device'] / 1e9:.2f} GB state)")


def tensor_bytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def device_events(torch, fn):
    """(device ms summed over one call's kernel events, their count) by
    ``torch.profiler``, or (None, why) where it shows none."""
    from torch.profiler import ProfilerActivity, profile

    try:  # instrumentation only: a tracer that fails says so
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    except RuntimeError as exc:
        return None, f"not measured (profiler: {exc})"
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not evs:
        return None, "not measured (no device events)"
    return sum(e.time_range.elapsed_us() for e in evs) / 1e3, len(evs)


def step_samples(torch, timer, fn, reps=P13_REPS, warmup=2,
                 lead_us=P13_LEAD_US, dev="cuda"):
    """Per-call ms of ``reps`` calls of a whole step by CUDA events, each
    after an L2 flush and a device wait of ``lead_us`` that lets the host
    enqueue ahead of the start event (a step issues thousands of
    launches, so the window can still hold host time where the host
    falls behind)."""
    for _ in range(warmup):
        fn()
    sync(torch, dev)
    out = []
    for _ in range(reps):
        if dev != "cuda":  # a rehearsal: the host's clock
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
            continue
        timer.flush_buf.zero_()
        torch.cuda._sleep(int(lead_us * timer.cycles_per_us))
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        out.append(s.elapsed_time(e))
    return out


def phase_verify_economics(torch, np, card, cfg, params, timer,
                           dev="cuda", B=P13_BATCH, reps=P13_REPS,
                           counts=None):
    """13a: the paper's economics on the card. Qwen3-8B's decode_32k and
    verify_8 steps (``workloads.make_decode_fn``) at B 8 on the
    workloads' cache layout (33,024 slots at ``SLOT_MULTIPLE`` 256),
    filled with seeded K/V, every slot valid and visible, lengths 32,768:
    both steps read the whole ring. Gates: layer 0's spec-verify launch
    at this ring within ``SV_TOL`` of the plain version, on values a
    dropped or doubled split would move by more than 10 x its atol
    (checked on the plain version); the verify step's next tokens equal
    ``verify_block`` on that step's logits and its lengths advance by
    1 + accepted (rows 0-3 draft the model's own first token, so each
    accepts at least one). Each step's time (CUDA events, median of
    ``P13_REPS``), its kernels' device time (``torch.profiler``) and its
    peak memory beside its floor (``roofline_ms``) and the dry run's count
    of the same work on the one card's mesh (from ``counts``, futures of
    ``start_p13_counts``, where given). Returns the steps' kernel
    launches (the timed calls and their warm-ups)."""
    from repro_torch.core.verify import verify_block
    from repro_torch.kernels.spec_verify import ops as sv_ops
    from repro_torch.kernels.spec_verify.ref import spec_verify_attention_ref
    from repro_torch.launch import workloads as W
    from repro_torch.models import model as M

    where = f"13a {cfg.name}"
    K = W.VERIFY_K
    n_sm = (torch.cuda.get_device_properties(0).multi_processor_count
            if dev == "cuda" else 132)  # the H100 SXM's, rehearsed on CPU
    dshape = W.with_batch(W.SHAPES["decode_32k"], B)
    vshape = W.with_batch(W.SHAPES["verify_8"], B)
    S = dshape.seq_len
    cache = M.init_cache(cfg, B, S + K + 2, headroom=K + 8, device=dev,
                         slot_multiple=W.SLOT_MULTIPLE)
    S1 = cache.layers[0][0].shape[1]
    g = torch.Generator(device=dev).manual_seed(13)
    tags = (torch.arange(S1, dtype=torch.int32, device=dev) % S)[None]
    for k, v, cpos in cache.layers:
        k.normal_(generator=g)
        v.normal_(generator=g)
        cpos.copy_(tags.expand_as(cpos))
    cache.lengths.fill_(S)
    ring_gb = sum(t.numel() * t.element_size() for e in cache.layers
                  for t in e) / 1e9
    log(f"{where}: ring of {S1} slots a row (S {S} + {K + 2} rounded up to "
        f"{W.SLOT_MULTIPLE}), B {B}, {cfg.num_layers} layers: {ring_gb:.2f} "
        f"GB of seeded K/V, every slot valid, lengths {S}  [{card}]")
    # gate: one layer's launch at this ring against the plain version, on
    # values that tell its splits apart. Scores are about N(0, 1), so
    # every slot weighs alike; V adds hd to one lane of each kv head for
    # each hd-th of the ring (the lane turned by 37 a head), so every
    # output lane is about 1, and a split the kernel dropped or took twice
    # moves the ~hd / n_split lanes it lights by about 1.
    Hq, hd, Hkv = cfg.num_heads, cfg.head_dim, cfg.num_kv_heads
    q = torch.randn((B, K + 1, Hq, hd), generator=g, device=dev).to(
        torch.bfloat16)
    pos = (S + torch.arange(K + 1, dtype=torch.int32, device=dev))[None] \
        .expand(B, K + 1).contiguous()
    k0, v0, c0 = cache.layers[0]
    lane = (torch.arange(S1, device=dev)[:, None] * hd // S1
            + 37 * torch.arange(Hkv, device=dev)[None]) % hd
    vg = v0 + (torch.nn.functional.one_hot(lane, hd) * hd).to(v0.dtype)
    got = sv_ops.spec_verify_attention(q, k0, vg, c0, pos).float()
    want = spec_verify_attention_ref(q, k0, vg, c0, pos).float()
    err = float((got - want).abs().max())
    check(bool(torch.allclose(got, want, **SV_TOL["bfloat16"])),
          f"{where}: spec-verify at the {S1}-slot ring departs from the "
          f"plain version by {err:.3e}")
    # what the gate would see of a kernel that dropped the plan's middle
    # split, or took it twice: the plain version without those slots, and
    # with them appended again
    plan = sv_ops.split_plan(B, K + 1, Hq, Hkv, S1, hd, n_sm)
    span = plan.tiles_per_split * plan.tile
    lo = (plan.n_split // 2) * span
    hi = min(lo + span, S1)
    c_drop = c0.clone()
    c_drop[:, lo:hi] = -1
    dropped = spec_verify_attention_ref(q, k0, vg, c_drop, pos).float()
    twice = spec_verify_attention_ref(
        q, torch.cat([k0, k0[:, lo:hi]], 1), torch.cat([vg, vg[:, lo:hi]], 1),
        torch.cat([c0, c0[:, lo:hi]], 1), pos).float()
    e_drop = float((dropped - want).abs().max())
    e_twice = float((twice - want).abs().max())
    atol = SV_TOL["bfloat16"]["atol"]
    check(min(e_drop, e_twice) > 10 * atol,
          f"{where}: a dropped or doubled split moves the output by only "
          f"{e_drop:.3e} / {e_twice:.3e}: the gate could not see it")
    plans = "" if dev != "cuda" else (
        f"; {sv_plan_line(torch, B, K + 1, Hq, Hkv, hd, S1)}"
        f"; decode: {sv_plan_line(torch, B, 1, Hq, Hkv, hd, S1)}")
    log(f"{where}: layer 0's spec-verify launch (B {B}, T {K + 1}, ring "
        f"{S1}, V lighting a lane a {S1 // hd}-slot range) within "
        f"{SV_TOL['bfloat16']} of the plain version, max |err| {err:.3e} "
        f"(outputs up to {float(want.abs().max()):.3f}); the plain version "
        f"without split {plan.n_split // 2} of {plan.n_split} (slots "
        f"{lo}-{hi}) departs by {e_drop:.3f}, with it twice by "
        f"{e_twice:.3f}{plans}  [{card}]")
    del q, vg, lane, got, want, c_drop, dropped, twice
    # the least a step moves: every weight but the input embedding (B x T
    # rows of it) and the whole ring, each read once
    floor_bytes = tensor_bytes(params.parameters()) + ring_gb * 1e9
    if params.lm_head is not None:
        floor_bytes -= tensor_bytes([params.embed])
    dec = W.make_decode_fn(cfg, dshape)
    ver = W.make_decode_fn(cfg, vshape)
    head = torch.randint(2, cfg.vocab_size, (B, 1), generator=g, device=dev,
                         dtype=torch.int32)
    dbatch = {"block": head}
    # the steps leave ``cache``'s lengths alone (each returns a new
    # Cache) and rewrite the same slots: every call does the same work.
    # Rows 0-3 draft the token a (B, K+1) forward predicts at their head:
    # the block's first position sees only the cache and the head, and a
    # forward of the same shape rounds it alike, so each accepts it
    drafts = torch.randint(2, cfg.vocab_size, (B, K), generator=g,
                           device=dev, dtype=torch.int32)
    ones = torch.ones((B, K + 1), dtype=torch.bool, device=dev)
    with torch.no_grad():
        logits, _ = M.forward(params, cfg, torch.cat([head, drafts], 1),
                              cache=cache, valid=ones)
    drafts[:4, 0] = logits[:4, 0, : cfg.vocab_size].argmax(-1).to(
        torch.int32)
    block = torch.cat([head, drafts], 1)
    budgets = torch.full((B,), K, dtype=torch.int32, device=dev)
    vbatch = {"block": block, "budgets": budgets}
    # gate: the step's tokens and lengths against verify_block on the
    # same forward's logits
    nxt, c1 = ver(params, cache, vbatch)
    with torch.no_grad():
        logits, _ = M.forward(params, cfg, block, cache=cache, valid=ones)
    res = verify_block(logits[:, :, : cfg.vocab_size], block, budgets)
    acc = res.accepted.cpu().numpy()
    check(bool(torch.equal(nxt, res.next_token)),
          f"{where}: the verify step's tokens differ from verify_block's")
    check(bool(torch.equal(c1.lengths.cpu(),
                           (S + 1 + res.accepted).to(torch.int32).cpu())),
          f"{where}: lengths {c1.lengths.tolist()} do not advance by 1 + "
          f"accepted {acc.tolist()}")
    check(bool((acc[:4] >= 1).all()),
          f"{where}: rows drafting the model's own token accepted {acc}")
    del logits, c1
    sync(torch, dev)
    reset_launches()
    out = {}
    for name, fn, shape in (("decode_32k", lambda: dec(params, cache, dbatch),
                             dshape),
                            ("verify_8", lambda: ver(params, cache, vbatch),
                             vshape)):
        if dev == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        times = step_samples(torch, timer, fn, reps=reps, dev=dev)
        peak = (torch.cuda.max_memory_allocated() / 1e9 if dev == "cuda"
                else float("nan"))
        busy, n_ev = (device_events(torch, fn) if dev == "cuda"
                      else (None, "not measured (CPU)"))
        rec = (counts[name].result() if counts else
               p13_counted("qwen3-8b", shape, None if dev == "cuda" else cfg))
        counted = max(rec["t_compute_s"], rec["t_memory_s"]) * 1e3
        bound, by = roofline_ms(floor_bytes, rec["total_flops"])
        ms = float(np.median(times))
        busy_s = (n_ev if busy is None else
                  f"{busy:.3f} ms in {n_ev} device events "
                  f"(floor/busy {bound / busy:.3f})")
        log(f"{where} {name} (B {B}, T {1 if shape.kind == 'decode' else K + 1}): "
            f"{ms:.3f} ms a step (median of {len(times)}: "
            f"{min(times):.3f}-{max(times):.3f}), floor {bound:.3f} ms "
            f"({by}: {floor_bytes / 1e9:.2f} GB of weights and ring read "
            f"once, the counted FLOPs), floor/time {bound / ms:.3f}; "
            f"kernels {busy_s}; peak memory {peak:.2f} GB; "
            f"{counted_line(rec)}  [{card}]")
        out[name] = (ms, busy, counted, rec)
    launches = read_launches()
    n_calls = 2 * (reps + 2 + 1)
    check(dev != "cuda"
          or launches["spec_verify_attention"] == cfg.num_layers * n_calls,
          f"{where}: {launches['spec_verify_attention']} spec-verify "
          f"launches, expected {cfg.num_layers} layers x {n_calls} steps")
    (dms, dbusy, dcount, _), (vms, vbusy, vcount, _) = (out["decode_32k"],
                                                        out["verify_8"])
    busy_ratio = ("not measured" if dbusy is None or vbusy is None
                  else f"{vbusy / dbusy:.3f}")
    log(f"{where}: verify/decode {vms / dms:.3f} measured (kernels' device "
        f"time {busy_ratio}), {vcount / dcount:.3f} counted; a verify pass "
        f"scores {K + 1} tokens, so at full acceptance a token costs "
        f"{vms / dms / (K + 1):.3f} of a decode step  [{card}]")
    del cache
    return launches


def phase_grpo_card(torch, np, card, arch, B, S, tag, dev="cuda",
                    cfg=None, counted=None, warm=False, launches=None):
    """13b / 13c: one GRPO + AdamW step (``workloads.make_train_fn``:
    group 8, remat, lr 3e-4) of ``arch`` at its published config, random
    bf16 weights from seed 0, on a seeded batch of B × S tokens (the
    second half the response; an encoder-decoder's batch adds stub
    ``enc_embeds`` of ``S_ENC`` frames, one row's mask cut to three
    quarters) with ``old_logprobs`` from the same weights. Gates, as 9b's:
    the loss finite and, at ratio 1, within ``SURROGATE_RTOL`` of
    -sum(adv·mask)/sum(mask); every gradient (read by a spy on the step's
    AdamW call) finite and non-zero somewhere; AdamW moved the
    parameters. Reports the step's time and peak memory beside its floor
    (``roofline_ms``) and the dry run's count of the same work on the one
    card's mesh (``counted``, a future of ``start_p13_counts``, where
    given). With ``warm`` a second step, on the updated weights, is timed
    after the gated one. The gated step's xLSTM and flash kernel launches
    are added to the Counter ``launches`` where given. ``cfg`` (with ``dev="cpu"``) rehearses it at
    a small width."""
    from repro_torch.launch import workloads as W
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.rl import grpo

    gc.collect()
    if dev == "cuda":  # the step's peak leaves a sixth of the card free
        torch.cuda.empty_cache()
    if cfg is None:
        cfg, params = full_width_model(torch, arch)
    else:
        params = M.init_params(cfg, seed=0, device=dev)
    where = f"{tag} {cfg.name}"
    M.set_trainable(params)
    g = torch.Generator(device=dev).manual_seed(131)
    tokens = torch.randint(2, cfg.vocab_size, (B, S), generator=g,
                           device=dev, dtype=torch.int32)
    resp = torch.zeros((B, S), dtype=torch.bool, device=dev)
    resp[:, S // 2:] = True
    adv = np.random.default_rng(132).normal(size=B).astype(np.float32)
    check(bool((adv != 0).all()), f"{where}: an advantage is 0")
    batch = {"tokens": tokens, "resp_mask": resp,
             "advantages": torch.tensor(adv, device=dev)}
    with torch.no_grad():
        enc_out = None
        if cfg.is_encoder_decoder:
            enc_mask = torch.ones((B, W.S_ENC), dtype=torch.bool, device=dev)
            enc_mask[-1, 3 * W.S_ENC // 4:] = False
            batch["enc_embeds"] = torch.randn(
                (B, W.S_ENC, cfg.d_model), generator=g, device=dev).to(
                    L.torch_dtype(cfg.dtype))
            batch["enc_mask"] = enc_mask
            enc_out = M.encode(params, cfg, batch["enc_embeds"], enc_mask)
        hidden, _ = M.forward(params, cfg, tokens, enc_out=enc_out,
                              enc_mask=batch.get("enc_mask"),
                              return_hidden=True)
        batch["old_logprobs"] = grpo.chunked_token_logprobs(
            params, cfg, hidden, tokens)
        del hidden, enc_out
    before = {k: p.detach().clone() for k, p in params.named_parameters()}
    seen = {}
    real = adamw.apply_updates

    def spy(ocfg, p, grads, state):
        seen["n"] = len(grads)
        seen["bad"] = [k for k, v in grads.items()
                       if not bool(torch.isfinite(v).all())]
        seen["zero"] = [k for k, v in grads.items() if not bool(v.any())]
        return real(ocfg, p, grads, state)

    step = W.make_train_fn(cfg)
    opt = adamw.init_state(params)
    # the least a step moves: the weights read and written, their
    # gradients written and read, the AdamW moments read and written,
    # each once (the saved activations, which the layout decides, left out)
    floor_bytes = 2 * (2 * tensor_bytes(params.parameters())
                       + tensor_bytes([*opt.mu.values(), *opt.nu.values()]))
    sync(torch, dev)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    adamw.apply_updates = spy
    reset_xlstm_launches()
    reset_flash_launches()
    try:
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, batch)
        sync(torch, dev)
        t_step = time.perf_counter() - t0
    finally:
        adamw.apply_updates = real
    xl = read_xlstm_launches()
    fl = read_flash_launches()
    if launches is not None:  # added to the counts already there
        for name, n in {**xl, **fl}.items():
            launches[name] += n
    if dev == "cuda":  # remat: a forward launch, its recompute, a backward
        n = n_flash_layers(cfg, S)
        check((fl["flash_attn_fwd"], fl["flash_attn_bwd"]) == (2 * n, n),
              f"{where}: {fl['flash_attn_fwd']} flash forward and "
              f"{fl['flash_attn_bwd']} backward launches in the step, "
              f"expected {2 * n} and {n}")
        if n:
            log(f"{where}: the step's flash launches {fl} (remat: a forward,"
                f" its recompute and a backward a decoder self-attention "
                f"layer)  [{card}]")
        for block in ("mlstm", "slstm"):
            n = sum(k == block for k in cfg.layer_kinds)
            fwd = xl[f"{block}_scan"] + xl[f"{block}_scan_train"]
            check(fwd == 2 * n and xl[f"{block}_scan_bwd"] == n,
                  f"{where}: {fwd} {block} forward and "
                  f"{xl[f'{block}_scan_bwd']} backward launches in the step,"
                  f" expected {2 * n} and {n}")
        if any(xl.values()):
            log(f"{where}: the step's xLSTM kernel launches {xl}  [{card}]")
    peak = (torch.cuda.max_memory_allocated() / 1e9 if dev == "cuda"
            else float("nan"))
    loss = float(loss)
    want = float(-(adv[:, None] * resp.cpu().numpy()).sum()
                 / resp.cpu().numpy().sum())
    check(np.isfinite(loss) and abs(loss - want) <= SURROGATE_RTOL
          * abs(want), f"{where}: loss {loss} at ratio 1, expected {want}")
    n_params = len(before)
    check(seen.get("n") == n_params, f"{where}: the step's AdamW saw "
          f"{seen.get('n')} gradients of {n_params} parameters")
    check(not seen["bad"], f"{where}: non-finite gradients in "
          f"{seen['bad'][:4]}")
    check(not seen["zero"], f"{where}: all-zero gradients in "
          f"{seen['zero'][:4]}")
    moved = sum(not torch.equal(before[k], p.detach())
                for k, p in params.named_parameters())
    check(moved == n_params, f"{where}: AdamW moved {moved} of {n_params} "
          "parameters")
    t_warm = None
    if warm:
        t0 = time.perf_counter()
        params, opt, _ = step(params, opt, batch)
        sync(torch, dev)
        t_warm = time.perf_counter() - t0
    shape = W.InputShape("train_4k", S, B, "train")
    rec = (counted.result() if counted else
           p13_counted(arch, shape, None if dev == "cuda" else cfg))
    bound, by = roofline_ms(floor_bytes, rec["total_flops"])
    log(f"{where} GRPO step (B {B}, S {S}"
        f"{f', S_ENC {W.S_ENC}' if cfg.is_encoder_decoder else ''}, remat, "
        f"AdamW): loss {loss:.6f} at ratio 1 (expected {want:.6f}); "
        f"{n_params} gradients finite and non-zero, every parameter moved; "
        f"one step {t_step:.3f} s (the first at this shape)"
        f"{'' if t_warm is None else f', a second {t_warm:.3f} s (warm)'}"
        f", floor "
        f"{bound / 1e3:.4f} s ({by}: {floor_bytes / 1e9:.2f} GB of weights,"
        f" gradients and moments each moved once, the counted FLOPs), "
        f"floor/time {bound / 1e3 / t_step:.4f}; peak memory {peak:.2f} GB; "
        f"{counted_line(rec)}  [{card}]")
    del params, opt, batch, before
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    return t_step, peak, rec


# ---------------------------------------------------------------------------
# phase 14: the paper's RL run through the examples' own configs
# ---------------------------------------------------------------------------

# Steps a run: 14a at T 0 (three epochs of rl_math's 16 problems, 8
# prompts a step), 14b at the example's T 0.6, 14c rl_code at T 0.
P14_STEPS = {"14a": 6, "14b": 8, "14c": 4}
# rl_math's SFT warmup for phase 14, raised from the example's default of
# 10 (--sft-warmup): at the 100m preset 10 steps leave the CE at 0.97 and
# every T 0 rollout at the 64-token limit (no EOS: no learned lengths);
# 20 leave it at 0.066 with 10 of 16 rows ending in EOS, 6 at the limit
# (the long tail), 40 at 0.0011 with every row exact. rl_code keeps its
# own 15.
P14_SFT = 20


def example(name):
    """``examples/<name>.py`` as a module: phase 14 takes the entry
    points' own configs from them."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def p14_trainers(mod, argv, arms, dev, sd=None, sft=0, **over):
    """One ``Trainer`` per arm (name -> (extra flags, drafter scope or
    None for the example's)) on the example ``mod``'s configs for ``argv``
    with ``over`` replacing trainer-config fields, each with its SFT
    warmup off: without ``sd`` the first arm runs ``sft`` warmup steps
    (``Trainer.sft_warmup``, its own optimizer) and its weights become
    ``sd``. Every arm loads ``sd`` into its policy and hands it to its
    engine (``set_params``), so the arms start GRPO from the same weights,
    a fresh GRPO optimizer each, an empty drafter history and the same
    generator seed. Returns (trainers, the SFT losses, sd)."""
    import dataclasses

    from repro_torch.rl.trainer import Trainer

    trs, losses = {}, []
    for name, (flags, scope) in arms.items():
        cfg, task, tcfg = mod.configs(mod.parse_args([*argv, *flags]))
        tcfg = dataclasses.replace(tcfg, sft_warmup_steps=0, **over)
        if scope is not None:
            tcfg.drafter = dataclasses.replace(tcfg.drafter, scope=scope)
        tr = Trainer(cfg, task, tcfg, device=dev)
        if sd is None:
            tr.sft_warmup(sft)
            losses = list(tr.sft_losses)
            sd = {k: v.detach().clone()
                  for k, v in tr.params.state_dict().items()}
        tr.params.load_state_dict(sd)
        tr.engine.set_params(tr.params)
        trs[name] = tr
    return trs, losses, sd


class P14Watch:
    """Wraps one arm's ``worker.rollout`` and its engine's
    ``_round_budgets``: per rollout the responses, rewards and stats, the
    epoch, each kernel's launches during it (spec-verify's also by its
    block's T, from ``sv_spy``) and every round's active rows and budgets.
    Adds no launch and no host sync."""

    def __init__(self, np, tr, sv_spy):
        self.tr = tr
        self.rolls = []
        self._rounds = []
        orig, orig_b = tr.worker.rollout, tr.engine._round_budgets

        def budgets(pids, emitted, active, remaining):
            b = orig_b(pids, emitted, active, remaining)
            self._rounds.append((np.array(active, bool), np.array(b)))
            return b

        def rollout(*a, **k):
            before, by_t = read_launches(), Counter(sv_spy.by_t)
            self._rounds = []
            batch = orig(*a, **k)
            after = read_launches()
            d = {key: after[key] - before[key] for key in (
                "spec_verify_attention", "suffix_match_propose",
                "suffix_match_propose_chunked")}
            self.rolls.append(dict(
                responses=[list(map(int, r)) for r in batch.responses],
                rewards=np.array(batch.rewards), stats=batch.stats,
                epoch=tr._epoch, launches=d,
                by_t=Counter(sv_spy.by_t) - by_t, rounds=self._rounds))
            return batch

        tr.worker.rollout = rollout
        tr.engine._round_budgets = budgets


def p14_run(trs, steps):
    """The arms' GRPO steps in turns (step k of every arm, then k + 1),
    so that a host's drift reaches each arm alike; returns each arm's
    step records."""
    for k in range(1, steps + 1):
        for tr in trs.values():
            tr.run(steps=k)
    return {name: tr.history for name, tr in trs.items()}


def p14_lengths(np, roll, max_new, lp):
    """(p50, p90, max, EOS share, {class: mean budget a round}) of one
    rollout: a row shorter than ``max_new`` ended in EOS; a row's class is
    its final length's under the length policy's thresholds, its budget
    the mean over the rounds it was active."""
    from repro_torch.core.length_policy import CLASS_NAMES

    lens = np.array([len(r) for r in roll["responses"]])
    cls = np.array([lp.classify_length(n) for n in lens])
    spent = np.zeros(len(lens))
    seen = np.zeros(len(lens))
    for active, b in roll["rounds"]:
        spent += np.where(active, b, 0)
        seen += active
    per = {}
    for c, name in enumerate(CLASS_NAMES):
        rows = (cls == c) & (seen > 0)
        per[name] = (float(spent[rows].sum() / seen[rows].sum())
                     if rows.any() else None)
    return (float(np.percentile(lens, 50)), float(np.percentile(lens, 90)),
            int(lens.max()), float((lens < max_new).mean()), per)


def p14_report(np, tag, watches, hists, max_new, card):
    """Per step and arm: rollout and train time, forwards, accepted per
    round, J under the default ``LatencyModel``, lengths, EOS share,
    budgets by length class, reward, loss and grad norm; then the rollout
    times summed and their ratios to the first (plain) arm's. Returns the
    EOS share over every rollout of every arm."""
    from repro_torch.core.budget import LatencyModel

    lat = LatencyModel()
    eos = []
    for name, w in watches.items():
        lp = w.tr.engine.length_policy
        for roll, h in zip(w.rolls, hists[name]):
            st = roll["stats"]
            p50, p90, mx, share, per = p14_lengths(np, roll, max_new, lp)
            eos.append(share)
            bud = "/".join("-" if v is None else f"{v:.2f}"
                           for v in per.values())
            log(f"{tag} {name} step {h['step'] + 1} (epoch {h['epoch'] + 1}"
                f"): rollout {h['gen_time_s']:.3f} s, n_fwd {st.n_fwd}, "
                f"accepted/round {st.acceptance_per_round:.2f}, J "
                f"{st.modeled_latency(lat):.1f}, lengths p50/p90/max "
                f"{p50:.0f}/{p90:.0f}/{mx}, EOS {share:.3f}, budget a round "
                f"short/medium/long {bud}, reward_mean "
                f"{h['reward_mean']:.4f}, loss {h['loss']:.6g}, grad_norm "
                f"{h['grad_norm']:.6g}, train step {h['train_time_s']:.3f} s"
                f"  [{card}]")
        log(f"{tag} {name}: length thresholds (short below, long above) "
            f"{tuple(round(t, 1) for t in lp.thresholds())}")
    gen = {n: sum(h["gen_time_s"] for h in hist) for n, hist in hists.items()}
    base = next(iter(gen))
    log(f"{tag} rollout time summed over {len(hists[base])} steps: " +
        ", ".join(f"{n} {t:.3f} s" for n, t in gen.items()) + "; " +
        ", ".join(f"{base}/{n} {gen[base] / t:.3f}" for n, t in gen.items()
                  if n != base) + f"  [{card}]")
    return float(np.mean(eos))


def p14_identity(np, tag, hists, watches, card, base="plain"):
    """Each arm against the ``base`` arm at T 0: every rollout token for
    token and reward for reward, ``loss`` and ``grad_norm`` within rtol
    1e-5 (bit-equality logged), and fewer forwards summed from the second
    rollout on. At T 0 a GRPO group's samples are equal, so every
    advantage and ``grad_norm`` is 0 (checked): the loss comparison
    confirms a zero update in each arm, no more."""
    bit = {}
    for name, hist in hists.items():
        check(all(h["grad_norm"] == 0 for h in hist),
              f"{tag} {name}: a non-zero grad_norm at T 0 "
              f"{[h['grad_norm'] for h in hist]}")
    fwd = {n: sum(h["n_fwd"] for h in hist[1:]) for n, hist in hists.items()}
    for name, w in watches.items():
        if name == base:
            continue
        for i, (a, b) in enumerate(zip(w.rolls, watches[base].rolls)):
            check(a["responses"] == b["responses"],
                  f"{tag} {name} rollout {i + 1}: tokens differ from the "
                  f"{base} arm's")
            check(np.array_equal(a["rewards"], b["rewards"]),
                  f"{tag} {name} rollout {i + 1}: rewards differ")
        bit[name] = True
        for ha, hb in zip(hists[name], hists[base]):
            check(ha["reward_mean"] == hb["reward_mean"],
                  f"{tag} {name} step {ha['step'] + 1}: reward_mean")
            for key in ("loss", "grad_norm"):
                check(bool(np.isclose(ha[key], hb[key], rtol=1e-5, atol=0)),
                      f"{tag} {name} step {ha['step'] + 1}: {key} "
                      f"{ha[key]!r} against {hb[key]!r}")
                bit[name] &= ha[key] == hb[key]
        check(fwd[name] < fwd[base],
              f"{tag} {name}: {fwd[name]} forwards from the second rollout "
              f"on, the {base} arm {fwd[base]}")
    log(f"{tag}: every arm's rollouts token-identical to the {base} arm's "
        f"with equal rewards at T 0; loss and grad_norm within rtol 1e-5 "
        f"(bit-equal: {bit}; grad_norm 0 in every step, a zero update); "
        f"forwards from the second rollout on {fwd}  "
        f"[{card}]")


def p14_launch_gates(tag, cfg, watches, dev, card, device_arm=None):
    """Per rollout of every arm: one prefill (n_rounds = n_fwd - 1) and,
    on the card, one spec-verify launch per attention layer per verify
    round, the plain arm's all at T 1 (its decode steps); the flat
    drafting kernel in every rollout of ``device_arm`` from its second
    epoch on (scope ``problem``: the first epoch has no history), and
    never in the other arms (the plain arm drafts nothing; the examples'
    scope ``problem+request`` keeps per-row host sessions, as the
    reference does); the chunked kernel never (lock-step ``generate``)."""
    n_attn = sum(k in ("attn", "local_attn") for k in cfg.layer_kinds)
    by_t, drafting = {}, {}
    for name, w in watches.items():
        by_t[name] = Counter()
        drafting[name] = [(r["launches"]["suffix_match_propose"],
                           r["launches"]["suffix_match_propose_chunked"])
                          for r in w.rolls]
        for i, r in enumerate(w.rolls):
            st, la, where = r["stats"], r["launches"], f"{tag} {name} " \
                f"rollout {i + 1}"
            check(st.n_rounds == st.n_fwd - 1,
                  f"{where}: {st.n_rounds} rounds, {st.n_fwd} forwards")
            by_t[name] += r["by_t"]
            if dev != "cuda":
                continue
            sv = la["spec_verify_attention"]
            check(sv == n_attn * st.n_rounds == sum(r["by_t"].values()),
                  f"{where}: {sv} spec-verify launches, expected {n_attn} "
                  f"x {st.n_rounds} verify rounds")
            check(name != "plain" or set(r["by_t"]) == {1},
                  f"{where}: the plain arm launched spec-verify at T "
                  f"{sorted(r['by_t'])}")
            check(la["suffix_match_propose_chunked"] == 0,
                  f"{where}: the chunked drafting kernel launched")
            sm = la["suffix_match_propose"]
            if name == device_arm:
                check(r["epoch"] == 0 or sm > 0,
                      f"{where} (epoch {r['epoch'] + 1}) never launched the "
                      "drafting kernel")
            else:
                check(sm == 0, f"{where}: {sm} drafting kernel launches")
    log(f"{tag}: spec-verify launches by the block's T {dict(by_t)} (one "
        f"a verify round in each of {n_attn} attention layers; the "
        f"prefill none); (flat, chunked) drafting launches a rollout "
        f"{drafting}  [{card}]")


def phase_rl_examples(torch, np, card, timer=None, dev="cuda",
                      preset="100m", steps=None, sft=P14_SFT, max_new=None):
    """Phase 14: ``examples/torch_rl_math.py``'s and ``torch_rl_code.py``'s
    own configs on the card, SFT-warmed weights (learned lengths, EOS),
    DAS on and off. 14a (T 0: the plain arm, the example's DAS arm and a
    DAS arm drafting through the device kernel, scope ``problem``) gates
    identity; 14b (T 0.6, from 14a's SFT weights) learns; 14c is
    rl_code's twin of 14a. Returns the launches by JSON entry and, with a
    ``timer``, spec-verify's entries at the two new head layouts."""
    steps = {**P14_STEPS, **(steps or {})}
    rlm, rlc = example("torch_rl_math"), example("torch_rl_code")
    extra = [] if max_new is None else ["--max-new", str(max_new)]
    max_new = rlm.parse_args(extra).max_new
    plain, das = (["--no-das"], None), ([], None)
    t0 = time.perf_counter()
    reset_launches()
    with SvSpy() as sv_a, SmSpy(chunked=False) as sm_a:
        trs, sft_losses, sd = p14_trainers(
            rlm, ["--preset", preset, "--temperature", "0", *extra],
            {"plain": plain, "DAS": das,
             "DAS device-drafted": ([], "problem")}, dev, sft=sft)
        cfg = trs["plain"].cfg
        log(f"14a {cfg.name} ({cfg.num_layers} layers, d_model "
            f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
            f"{cfg.head_dim}, float32) SFT warmup CE by step: "
            f"{', '.join(f'{x:.4f}' for x in sft_losses)}  [{card}]")
        check(sft_losses[-1] < sft_losses[0],
              f"14a: SFT loss did not fall: {sft_losses}")
        watches = {n: P14Watch(np, tr, sv_a) for n, tr in trs.items()}
        hists = p14_run(trs, steps["14a"])
    for tr in trs.values():
        tr.close()
    eos = p14_report(np, "14a", watches, hists, max_new, card)
    p14_launch_gates("14a", cfg, watches, dev, card,
                     device_arm="DAS device-drafted")
    p14_identity(np, "14a", hists, watches, card)
    check(eos > 0, f"14a: no rollout ended in EOS before {max_new} tokens")
    la = read_launches()
    del trs, watches
    errs = {}
    if dev == "cuda":
        sv_a.check(torch, card, "14a")
        sm_a.check(torch, card, "14a DAS device-drafted")
        errs["rl100m"] = sv_a.worst
    # 14b: the example's own temperature, both arms from the SFT weights
    reset_launches()
    with SvSpy() as sv_b:
        trs, _, _ = p14_trainers(rlm, ["--preset", preset, *extra],
                                 {"plain": plain, "DAS": das}, dev, sd=sd)
        watches = {n: P14Watch(np, tr, sv_b) for n, tr in trs.items()}
        hists = p14_run(trs, steps["14b"])
    for tr in trs.values():
        tr.close()
    p14_report(np, "14b", watches, hists, max_new, card)
    p14_launch_gates("14b", cfg, watches, dev, card)
    for name, hist in hists.items():
        check(all(np.isfinite(h["loss"]) for h in hist),
              f"14b {name}: a loss is not finite")
        check(any(h["grad_norm"] > 0 for h in hist),
              f"14b {name}: every grad_norm is 0")
    log("14b reward_mean by step: " + "; ".join(
        f"{n} {[round(h['reward_mean'], 4) for h in hist]}"
        for n, hist in hists.items()) + f"  [{card}]")
    lb = read_launches()
    del trs, watches, sd
    if dev == "cuda":
        sv_b.check(torch, card, "14b")
        errs["rl100m"] = max(errs["rl100m"], sv_b.worst)
    # 14c: rl_code's own config at T 0, DAS on and off
    reset_launches()
    code_sft = rlc.configs(rlc.parse_args([]))[2].sft_warmup_steps
    with SvSpy() as sv_c:
        trs, sft_c, _ = p14_trainers(rlc, [], {"plain": plain, "DAS": das},
                                     dev, sft=code_sft, temperature=0.0)
        watches = {n: P14Watch(np, tr, sv_c) for n, tr in trs.items()}
        hists = p14_run(trs, steps["14c"])
    for tr in trs.values():
        tr.close()
    ccfg = trs["plain"].cfg
    log(f"14c {ccfg.name} SFT warmup CE {sft_c[0]:.4f} -> {sft_c[-1]:.4f} "
        f"({len(sft_c)} steps)  [{card}]")
    p14_report(np, "14c", watches, hists,
               trs["plain"].tcfg.max_new_tokens, card)
    check(sft_c[-1] < sft_c[0], f"14c: SFT loss did not fall: {sft_c}")
    p14_launch_gates("14c", ccfg, watches, dev, card)
    p14_identity(np, "14c", hists, watches, card)
    lc = read_launches()
    del trs, watches
    if dev == "cuda":
        sv_c.check(torch, card, "14c")
        errs["rlcode"] = sv_c.worst
    log(f"phase 14 in {time.perf_counter() - t0:.1f} s  [{card}]")
    launches = Counter({
        "suffix_match_propose": la["suffix_match_propose"],
        "spec_verify_attention_rl100m_f32": (la["spec_verify_attention"]
                                             + lb["spec_verify_attention"]),
        "spec_verify_attention_rlcode_f32": lc["spec_verify_attention"]})
    entries = []
    if timer is not None:
        for key, spy, what in (("rl100m", sv_a, f"14a {cfg.name}"),
                               ("rlcode", sv_c, f"14c {ccfg.name}")):
            entries.append(time_sv_path_case(
                torch, np, timer, card, spy,
                f"spec_verify_attention_{key}_f32", what, errs[key]))
    return launches, entries


def run_concurrently(cmds, env, timeout_s=600):
    """Start every command at once (their output to temporary files, so
    no pipe fills) and wait for all; returns per command its exit code,
    the last three lines of its output and the seconds from the start to
    its exit. A command past ``timeout_s`` is killed, and so is every
    other still running if this raises."""
    import tempfile

    t0 = time.perf_counter()
    runs = []
    try:
        for cmd in cmds:
            out = tempfile.TemporaryFile(mode="w+")
            runs.append((subprocess.Popen(cmd, cwd=str(ROOT), env=env,
                                          stdout=out,
                                          stderr=subprocess.STDOUT,
                                          text=True), out))
        done = {}
        while len(done) < len(runs):
            for i, (p, _) in enumerate(runs):
                if i in done:
                    continue
                try:
                    p.wait(timeout=0.05)
                except subprocess.TimeoutExpired:
                    if time.perf_counter() - t0 > timeout_s:
                        p.kill()
                        p.wait()
                        done[i] = time.perf_counter() - t0
                    continue
                done[i] = time.perf_counter() - t0
        res = []
        for i, (p, out) in enumerate(runs):
            out.seek(0)
            tail = out.read().strip().splitlines()[-3:]
            res.append((p.returncode, tail, done[i]))
        return res
    finally:
        for p, out in runs:
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()


# Phase 14's entry points run as CLIs: (example, flags, a line of its
# output that says it ran through)
EXAMPLE_CLIS = [("torch_quickstart", [], "LOSSLESS"),
                ("torch_serve_spec", ["--rounds", "3"], "round 2")]


def phase_cli(card):
    """Phase 6's CLIs, 10d, 13d and phase 14's two serving examples
    (``EXAMPLE_CLIS``), all started at once (each is small;
    run one after another they took ~95 s). 13d: the dry run's CLIs
    (``launch.dryrun``, ``launch.train --dry-run``, ``launch.serve
    --dry-run --shape verify_8``, ``launch.hillclimb --pair C``) each exit
    0 and print a record that parses. 10d: the serving CLI with two workers
    over the history service (shards as ``python -m
    repro_torch.history.service`` subprocesses, supervised), continuous
    serving, journals and a trace, whose trace must validate and whose
    journals must hold only finished sessions."""
    import tempfile

    sys.path.insert(0, str(SRC))
    from repro_torch import obs
    from repro_torch.fault import RolloutJournal

    env = dict(os.environ, PYTHONPATH=str(SRC))
    cli = [("serve", ["--arch", "qwen3-8b", "--scope", "problem",
                      "--rounds", "2"]),
           ("serve", ["--arch", "qwen2-1.5b", "--continuous"]),
           ("serve", ["--arch", "recurrentgemma-9b", "--rounds", "2"]),
           ("train", ["--arch", "qwen2-1.5b", "--steps", "2"]),
           ("train", ["--arch", "recurrentgemma-9b", "--steps", "2"])]
    with tempfile.TemporaryDirectory() as d:
        args10d = ["--arch", "qwen2-1.5b", "--smoke", "--continuous",
                   "--history-service", "--workers", "2", "--supervise",
                   "--scope", "problem", "--journal-dir", d, "--trace-out",
                   os.path.join(d, "trace.json")]
        cmds = [[sys.executable, "-m", f"repro_torch.launch.{mod}",
                 "--smoke", *args] for mod, args in cli]
        cmds.append([sys.executable, "-m", "repro_torch.launch.serve",
                     *args10d])
        # 13d: the dry run's CLIs (meta tensors: no card, no kernel)
        hc_out = os.path.join(d, "hillclimb.json")
        dry = [("dryrun", ["--arch", "qwen3-8b", "--shape", "verify_8"]),
               ("train", ["--arch", "xlstm-125m", "--dry-run"]),
               ("serve", ["--arch", "qwen3-8b", "--dry-run", "--shape",
                          "verify_8"]),
               ("hillclimb", ["--pair", "C", "--out", hc_out])]
        cmds += [[sys.executable, "-m", f"repro_torch.launch.{mod}", *args]
                 for mod, args in dry]
        # phase 14's CLIs: the examples that serve (the RL ones run in
        # phase 14 itself)
        cmds += [[sys.executable, f"examples/{name}.py", *args]
                 for name, args, _ in EXAMPLE_CLIS]
        t0 = time.perf_counter()
        res = run_concurrently(cmds, env)
        for (name, args, line), (rc, tail, t) in zip(
                EXAMPLE_CLIS, res[len(cli) + 1 + len(dry):]):
            check(rc == 0 and any(line in ln for ln in tail),
                  f"14 {name} {' '.join(args)} exited {rc} without "
                  f"{line!r}: {' | '.join(tail)}")
            log(f"14 {name} {' '.join(args)} ok in {t:.1f} s [{card}]: "
                f"{' | '.join(tail)}")
        for (mod, args), (rc, tail, t) in zip(cli, res):
            check(rc == 0, f"{mod} CLI {' '.join(args)} exited {rc}: "
                  f"{' | '.join(tail)}")
            log(f"{mod} CLI {' '.join(args)} ok in {t:.1f} s [{card}]: "
                f"{' | '.join(tail)}")
        for (mod, args), (rc, tail, t) in zip(dry, res[len(cli) + 1:]):
            check(rc == 0, f"13d {mod} CLI {' '.join(args)} exited {rc}: "
                  f"{' | '.join(tail)}")
            recs = [json.loads(ln) for ln in tail if ln.startswith("{")]
            check(bool(recs) and all(r.get("status", "ok") == "ok"
                                     for r in recs),
                  f"13d {mod} CLI printed no record: {' | '.join(tail)}")
            rec = recs[-1]
            what = (f"cost ratio {rec['cost_ratio_C']:.3f}" if mod ==
                    "hillclimb" else f"{rec['arch']} {rec['shape']} "
                    f"{rec['mesh']}: {counted_line(rec)}")
            log(f"13d {mod} CLI {' '.join(args[:4])} ok in {t:.1f} s: "
                f"{what}  [{card}]")
        with open(hc_out) as f:
            check(json.load(f)[0]["pair"] == "C", "13d: hillclimb's report")
        rc, tail, t = res[len(cli)]
        check(rc == 0, f"10d serve CLI exited {rc}: {' | '.join(tail)}")
        with open(os.path.join(d, "trace.json")) as f:
            doc = json.load(f)
        problems = obs.validate_chrome_trace(doc)
        check(not problems and doc["traceEvents"],
              f"10d: the CLI's trace is invalid: {problems[:3]}")
        sess = {}
        for w in range(2):
            sess.update(RolloutJournal.recover(os.path.join(d, f"w{w}.wal")))
        check(sess and all(s.finished for s in sess.values()),
              f"10d: the CLI's journals hold {len(sess)} sessions, "
              f"{sum(not s.finished for s in sess.values())} unfinished")
        log(f"10d serve CLI {' '.join(args10d[:-4])} ok in {t:.1f} s "
            f"[{card}]: trace of {len(doc['traceEvents'])} events valid, "
            f"journals {journal_summary(sess)}: {' | '.join(tail)}")
    log(f"the {len(cmds)} CLIs, started at once, in "
        f"{time.perf_counter() - t0:.1f} s  [{card}]")


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
    p13_pool, p13_counts = start_p13_counts()

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    sources = ["spec_verify", "suffix_match", "rglru", "rglru_bwd", "mlstm",
               "slstm", "flash_attn"]
    _build.build_all(sources)
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc sm_90a, parallel)  "
        f"[{card}]")
    for name in sources:
        for ln in _build.ptxas_lines(name):
            log(f"  [{name}] {ln}")

    timer = Timer(torch)
    sv_entries, sv_f32_err, sv_family_err = phase_spec_verify(torch, np,
                                                              timer, card)
    kernels = {k["name"]: k for k in (
        *sv_entries,
        phase_suffix_match(torch, np, timer, card),
        phase_suffix_match_chunked(torch, np, timer, card),
        *phase_rglru(torch, np, timer, card),
        *phase_xlstm_kernels(torch, np, timer, card))}
    # every path's launches of each kernel, each path counted from 0 (the
    # scan's also by (B, T))
    launches = Counter()
    rglru_shapes = Counter()

    def add(run, skip=()):
        launches.update({k: v for k, v in run.items()
                         if k not in skip and k != "rglru_scan_by_shape"})
        rglru_shapes.update(run["rglru_scan_by_shape"])

    cfg, params = full_width_model(torch, "qwen3-8b")
    def stamp(what):
        log(f"{what} done at {time.perf_counter() - t_start:.1f} s")

    stamp("phases 1-3")
    lock, flat_spy, lock_runs = phase_main_path(torch, np, card, cfg, params)
    cont, chunked_spy, cont_runs = phase_continuous(torch, np, card, cfg,
                                                    params)
    # phase 13a: the decode_32k and verify_8 workloads at the full ring, on
    # the same weights, every earlier cache freed first
    stamp("phases 4-5")
    gc.collect()
    torch.cuda.empty_cache()
    l13a = phase_verify_economics(torch, np, card, cfg, params, timer,
                                  counts=p13_counts)
    gc.collect()
    torch.cuda.empty_cache()
    stamp("phase 13a")
    # phase 10a/10b: phase 5's traffic with telemetry and the journal, and
    # a drain with a journal resume, on the same weights
    l10a, _ = phase_telemetry(torch, np, card, cfg, params, cont_runs,
                              cont["chunked"])
    stamp("phase 10a")
    torch.cuda.empty_cache()
    micro = phase_micro(torch, np, card, cfg, params, lock_runs)
    # 10b on the same weights: in bf16 against phase 5's epoch 1 with the
    # plain-greedy witness, then upcast to float32 in place, exactly
    # against an uninterrupted float32 run (see there)
    l10b16, _ = phase_drain_resume(torch, np, card, cfg, params,
                                   reference=cont_runs[0])
    torch.cuda.empty_cache()
    cfg = cut_depth(torch, params, cfg, F32_RESUME_LAYERS)
    params.float()
    params.cfg = cfg = cfg.replace(dtype="float32")
    l10b, sv10b = phase_drain_resume(torch, np, card, cfg, params)
    stamp("phase 10b")
    for run in (lock, cont["chunked"], cont["flat"], micro, l10a, l10b16,
                l13a):
        add(run)
    # the float32 instantiation of spec-verify, at 10b's shape
    add(l10b, skip=("spec_verify_attention",))
    launches["spec_verify_attention_f32"] += l10b["spec_verify_attention"]
    kernels["spec_verify_attention_f32"] = time_sv_path_case(
        torch, np, timer, card, sv10b, "spec_verify_attention_f32",
        f"10b {cfg.name}", sv_f32_err)
    del sv10b
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
    cfg, params = full_width_model(torch, "recurrentgemma-9b",
                                   HYBRID_SERVE_LAYERS)
    hybrid, _, hybrid_runs = phase_main_path(torch, np, card, cfg, params)
    hmicro = phase_micro(torch, np, card, cfg, params, hybrid_runs)
    cont, _, _ = phase_continuous(torch, np, card, cfg, params,
                                  layouts=("chunked",))
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
    stamp("phase 7")
    rl, entries8 = phase_rl(torch, np, timer, card)
    del timer
    launches.update(rl)
    kernels.update({k["name"]: k for k in entries8})
    fl_names = ("flash_attn_fwd", "flash_attn_bwd")
    flash_by_path = {"8b-8e": tuple(rl[n] for n in fl_names)}
    # phase 10c: two workers over the history service with faults, in
    # float32 (exact against one worker, and the checkpoint resume) and in
    # bf16 (the plain-greedy witness; no checkpoint, for the script's time:
    # 8e resumes a bf16 checkpoint and the float32 run this sidecar); step
    # 3 profiled in both, the float32 run's after its checkpoint save
    from repro_torch.configs import get_config

    qwen2 = get_config("qwen2-1.5b")
    qwen2 = qwen2.replace(num_layers=MULTIWORKER_LAYERS)
    l10c, sv10c = phase_multiworker(torch, np, card,
                                    cfg=qwen2.replace(dtype="float32"))
    timer = Timer(torch)
    kernels["spec_verify_attention_qwen2_f32"] = time_sv_path_case(
        torch, np, timer, card, sv10c, "spec_verify_attention_qwen2_f32",
        f"10c {qwen2.name}", sv_f32_err)
    del sv10c, timer
    # the trainers, engines and telemetries reference one another: their
    # card memory returns only once the collector has run
    gc.collect()
    torch.cuda.empty_cache()
    l10c16, _ = phase_multiworker(torch, np, card, cfg=qwen2, resume=False)
    gc.collect()
    torch.cuda.empty_cache()
    stamp("phase 10c")
    launches["spec_verify_attention_qwen2_f32"] += \
        l10c["spec_verify_attention"]
    launches["spec_verify_attention_qwen2"] += l10c16["spec_verify_attention"]
    launches["suffix_match_propose"] += (l10c["suffix_match_propose"]
                                         + l10c16["suffix_match_propose"])
    # phase 9: RecurrentGemma-9B training (the scan's backward kernel)
    timer = Timer(torch)
    entries, l9, shapes9 = phase_hybrid_train(torch, np, timer, card)
    stamp("phase 9")
    del timer
    kernels.update({k["name"]: k for k in entries})
    launches.update(l9)
    rglru_shapes.update(shapes9)
    flash_by_path["9b-9c"] = tuple(l9[n] for n in fl_names)
    # phase 11: the remaining decoder families, one resident at a time
    gc.collect()
    torch.cuda.empty_cache()
    timer = Timer(torch)
    entries11, l11 = phase_families(torch, np, card, timer, sv_family_err)
    stamp("phase 11")
    del timer
    kernels.update({k["name"]: k for k in entries11})
    launches.update(l11)
    # phase 12: xLSTM-125M (12a in bf16 at its published config, 12b in
    # float32 on its first layers) and SeamlessM4T-medium (12c)
    gc.collect()
    torch.cuda.empty_cache()
    t12 = time.perf_counter()
    cfg, params = full_width_model(torch, "xlstm-125m")
    launches.update(phase_xlstm(torch, np, card, cfg, params))
    cfg = cut_depth(torch, params, cfg, XLSTM_F32_LAYERS)
    params.float()
    params.cfg = cfg = cfg.replace(dtype="float32")
    launches.update(phase_xlstm_f32(torch, np, card, cfg, params))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cfg, params = full_width_model(torch, "seamless-m4t-medium")
    runs12 = phase_seamless(torch, np, card, cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    timer = Timer(torch)
    for dtype, name, err in (
            ("bf16", "spec_verify_attention_seamless",
             sv_family_err["spec_verify_attention_seamless"]),
            ("float32", "spec_verify_attention_seamless_f32", sv_f32_err)):
        spy, n = runs12[dtype]
        e = time_sv_path_case(torch, np, timer, card, spy, name,
                              f"12c {cfg.name} ({dtype})", err)
        e["launches"] = n
        kernels[name] = e
    del timer, runs12
    log(f"phase 12: {time.perf_counter() - t12:.1f} s  [{card}]")
    stamp("phase 12")
    # phase 13b/13c: a GRPO step of xLSTM-125M and of SeamlessM4T-medium
    # at their published configs, the dry run's count beside each
    fl_before = tuple(launches[n] for n in fl_names)
    for tag, (arch, shape) in p13_jobs().items():
        if tag in ("13b", "13c"):
            # the step's launches (gated there: 13b's xLSTM ones, 13c's
            # flash ones) are added to the line's
            phase_grpo_card(torch, np, card, arch, shape.global_batch,
                            shape.seq_len, tag, counted=p13_counts[tag],
                            warm=tag == "13b", launches=launches)
    p13_pool.shutdown()
    stamp("phase 13b-c")
    flash_by_path["13c"] = tuple(launches[n] - b
                                 for n, b in zip(fl_names, fl_before))
    # phase 14: the paper's RL run through the examples' own configs
    # (SFT-warmed 100m policy, DAS on and off; rl_code's twin)
    gc.collect()
    torch.cuda.empty_cache()
    timer = Timer(torch)
    l14, entries14 = phase_rl_examples(torch, np, card, timer)
    del timer
    kernels.update({k["name"]: k for k in entries14})
    launches.update(l14)
    stamp("phase 14")
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
    stamp("small references")
    phase_cli(card)
    log(f"launches on every path: {dict(launches)}  [{card}]")
    log(f"flash (forward, backward) launches by path: {flash_by_path}; on "
        f"every path {tuple(launches[n] for n in fl_names)}  [{card}]")
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
