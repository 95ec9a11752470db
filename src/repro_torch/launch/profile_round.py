"""Profile the port's lock-step DAS rounds on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_round \
        [--out build/profile_round.json]

Same configuration as ``chip_smoke.py``'s main path — Qwen3-8B at full
width (random weights from seed 0, bf16), 8 requests over 4 problems,
prompts of 128-256 seeded tokens, fused rounds, scope ``problem``, K
bucket 16 — with the long tail cut to ``max_new_tokens`` 16/24/32/48 so
that a profiled epoch stays short. One unprofiled epoch warms the
libraries; then a fresh drafter runs epoch 1 (cold: nothing to draft)
and epoch 2 (drafting from epoch 1), each once without the profiler
(wall time) and once under ``torch.profiler`` with device activity only.
For each it reports the device time by kernel class (GEMMs, spec-verify
attention, suffix-match propose, everything else), the ten kernels that
took the most device time, and the device busy time (union of kernel intervals) against the profiled wall time, which
gives the device's idle share; the same numbers go to ``--out`` as
JSON.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path


def _classify(name: str) -> str:
    n = name.lower()
    if "spec_verify" in n:
        return "spec_verify"
    if "suffix_match" in n:
        return "suffix_match"
    if any(s in n for s in ("gemm", "xmma", "cutlass", "cublas", "matmul",
                            "gemv", "splitk", "nvjet")):
        return "gemm"
    return "other"


def _kernel_stats(prof, torch):
    """(device µs by class, busy µs, kernel count, top kernels) from the
    trace's device events; busy is the union of their intervals."""
    by_class = {"gemm": 0.0, "spec_verify": 0.0, "suffix_match": 0.0,
                "other": 0.0}
    by_name = {}
    spans = []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = ev.time_range.start, ev.time_range.end
        by_class[_classify(ev.name)] += end - start
        tot, cnt = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (tot + end - start, cnt + 1)
        spans.append((start, end))
    spans.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    top = [dict(name=n[:90], ms=t / 1e3, launches=c) for n, (t, c) in top]
    return by_class, busy, len(spans), top


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/profile_round.json")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.core.drafter import DrafterConfig, SuffixDrafter
    from repro_torch.core.spec_engine import EngineConfig, SpecEngine
    from repro_torch.models import model as M

    dev = resolve_device("cuda")
    cfg = get_config("qwen3-8b")
    params = M.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(1)
    problems = [[int(t) for t in rng.integers(2, cfg.vocab_size,
                                              size=int(rng.integers(128, 257)))]
                for _ in range(4)]
    prompts = [problems[i // 2] for i in range(8)]
    pids = [f"p{i // 2}" for i in range(8)]
    max_new = [(16, 24, 32, 48)[i // 2] for i in range(8)]

    def engine():
        return SpecEngine(
            params, cfg,
            EngineConfig(max_draft=16, block_buckets=(16,),
                         max_new_tokens=256, eos_token=1),
            drafter=SuffixDrafter(DrafterConfig(scope="problem")),
            device=dev,
        )

    engine().generate(prompts, pids, max_new_tokens=max_new)  # warm-up
    plain, profiled = engine(), engine()  # same drafting history each
    report = {"device": torch.cuda.get_device_name(0), "epochs": []}
    for ep in range(2):
        plain.begin_iteration(ep)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain.generate(prompts, pids, max_new_tokens=max_new)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        profiled.begin_iteration(ep)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            outs, st = profiled.generate(prompts, pids,
                                         max_new_tokens=max_new)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        by_class, busy_us, n_kernels, top = _kernel_stats(prof, torch)
        row = dict(
            epoch=ep + 1, rounds=st.n_rounds, tokens=st.n_toks_emitted,
            accepted=st.n_accepted, wall_ms_unprofiled=plain_ms,
            wall_ms=wall_us / 1e3,
            device_busy_ms=busy_us / 1e3,
            idle_share=(1.0 - busy_us / wall_us) if n_kernels else None,
            kernels=n_kernels,
            device_ms_by_class={k: v / 1e3 for k, v in by_class.items()},
            host_bookkeeping_ms=st.host_time_s * 1e3,
            ms_per_round_unprofiled=plain_ms / max(st.n_rounds, 1),
            device_ms_per_round=busy_us / 1e3 / max(st.n_rounds, 1),
            top_kernels=top,
        )
        report["epochs"].append(row)
        print(json.dumps(row), flush=True)
        if not n_kernels:
            print("profiler recorded no device events: device times not "
                  "measured", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(f"wrote {out}", flush=True)


if __name__ == "__main__":
    main()
