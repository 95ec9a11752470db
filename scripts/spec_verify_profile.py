#!/usr/bin/env python3
"""Device time of spec-verify's float32 kernels, split by kernel.

    python3 scripts/spec_verify_profile.py

Needs one CUDA card. At 10b's shape (Qwen3-8B: B 8, T 17, 32/8 heads, hd
128, S+1 577, the path's fill) and 10c's (Qwen2-1.5B: B 4, T 17, 12/2
heads, S+1 129), 20 launches of ``spec_verify_attention_cuda`` run
under ``torch.profiler``, each after an L2 flush and a device-side
wait, cycling four input sets (``chip_smoke.sv_inputs``). Prints, per
shape, the main kernel's and the combine kernel's mean device time and
how long before the main kernel's end the combine (a programmatic
dependent) starts, with the card line.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels.spec_verify import ops as sv_ops  # noqa: E402

SHAPES = [("10b", 8, 32, 8, 577, cs.SV_PATH_FILL),
          ("10c", 4, 12, 2, 129, cs.SV_QWEN2_F32_FILL)]


def main() -> None:
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: needs a CUDA card")
    card = cs.card_line()
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    for label, B, Hq, Hkv, S1, fill in SHAPES:
        copies = [cs.sv_inputs(torch, np, B, 17, Hq, Hkv, 128, S1,
                               "float32", 90 + j, *fill) for j in range(4)]
        for c in copies:  # builds and warms
            sv_ops.spec_verify_attention_cuda(*c)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(20):
                flush.zero_()
                torch.cuda._sleep(200_000)
                sv_ops.spec_verify_attention_cuda(*copies[i % 4])
            torch.cuda.synchronize()
        spans = sorted((e.name, e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        main_k = sorted(s for s in spans if "f32_kernel" in s[0])
        comb = sorted(s for s in spans if "f32_combine" in s[0])
        cs.check(len(main_k) == 20 and len(comb) == 20,
                 f"{label}: {len(main_k)} main and {len(comb)} combine "
                 "kernels traced, 20 each expected")
        dur = lambda ks: np.mean([e - s for _, s, e in ks])  # noqa: E731
        lead = np.mean([m[2] - c[1] for m, c in
                        zip(sorted(main_k, key=lambda x: x[1]),
                            sorted(comb, key=lambda x: x[1]))])
        cs.log(f"{label} (B={B} T=17 Hq={Hq} Hkv={Hkv} hd=128 S+1={S1}): "
               f"main kernel {dur(main_k):.2f} us, combine {dur(comb):.2f} "
               f"us, the combine starting {lead:.2f} us before the main "
               f"kernel ends (means of 20 launches)  [{card}]")


if __name__ == "__main__":
    main()
