#!/usr/bin/env python3
"""``chip_smoke.py`` phase 14's traffic on the card, measured apart from
its gates: how long an SFT warmup must run for the rl_math 100m policy
to end rollouts in EOS, and where a rollout round's time goes.

    python3 scripts/rl_examples_profile.py

Needs one CUDA card. Builds the kernels, then:

1. for 10, 20 and 40 SFT steps (``examples/torch_rl_math.py``'s configs,
   preset 100m, seed 0; phase 14's ``p14_trainers``): the CE after the
   warmup and one plain rollout at T 0 of the first 8 problems (16 rows,
   64 new tokens): lengths, EOS share, reward (a line ``SFT <n>: ...``);
2. after 20 SFT steps, a plain rollout and the example's DAS arm's
   epoch-2 rollout (after an epoch-1 rollout of the same problems),
   each once without the profiler (wall time) and once under
   ``torch.profiler`` with device activity only: rounds, wall a round,
   device busy time (the union of kernel intervals), idle share, kernels
   a round and device time by class (``launch/profile_round.py``'s
   classes), as one JSON line each (``PROFILE <arm>: {...}``).
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402


def main():
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build
    from repro_torch.launch.profile_round import _kernel_stats

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all(["spec_verify", "suffix_match"])
    card = cs.card_line()
    rlm = cs.example("torch_rl_math")
    argv = ["--preset", "100m", "--temperature", "0"]
    for sft in (10, 20, 40):
        trs, losses, _ = cs.p14_trainers(rlm, argv, {"plain": (["--no-das"],
                                                               None)},
                                         "cuda", sft=sft)
        tr = trs["plain"]
        batch = tr.worker.rollout(tr.loader.problems[:8])
        lens = np.array([len(r) for r in batch.responses])
        print(f"SFT {sft}: CE {losses[0]:.4f} -> {losses[-1]:.4f}; a plain "
              f"T 0 rollout of 16 rows: lengths {sorted(lens.tolist())}, EOS "
              f"share {float((lens < 64).mean()):.3f}, reward_mean "
              f"{float(batch.rewards.mean()):.4f}  [{card}]", flush=True)
        tr.close()
    trs, _, _ = cs.p14_trainers(rlm, argv, {"plain": (["--no-das"], None),
                                            "DAS": ([], None)}, "cuda",
                                sft=cs.P14_SFT)
    problems = trs["plain"].loader.problems[:8]
    trs["DAS"].worker.rollout(problems)  # epoch 1: the history
    trs["DAS"].engine.begin_iteration(1)
    for name, tr in trs.items():
        tr.worker.rollout(problems)  # warm-up (DAS: its epoch-2 drafts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = tr.worker.rollout(problems)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pbatch = tr.worker.rollout(problems)
            torch.cuda.synchronize()
            pwall_us = (time.perf_counter() - t0) * 1e6
        by_class, busy_us, n_kernels, top = _kernel_stats(prof, torch)
        rounds = max(batch.stats.n_rounds, 1)
        print(f"PROFILE {name}: " + json.dumps(dict(
            rounds=batch.stats.n_rounds, forwards=batch.stats.n_fwd,
            wall_ms_unprofiled=wall_ms, ms_per_round=wall_ms / rounds,
            host_bookkeeping_ms=batch.stats.host_time_s * 1e3,
            wall_ms_profiled=pwall_us / 1e3, device_busy_ms=busy_us / 1e3,
            idle_share=(1.0 - busy_us / pwall_us) if n_kernels else None,
            kernels_per_round=n_kernels / max(pbatch.stats.n_rounds, 1),
            device_ms_by_class={k: v / 1e3 for k, v in by_class.items()},
            top_kernels=top[:5], card=card)), flush=True)
        tr.close()


if __name__ == "__main__":
    main()
