#!/usr/bin/env python3
"""Phase 4's lock-step traffic on the card alone and beside the process
that ``chip_smoke.py`` starts for phase 13's dry-run counts
(``start_p13_counts``): does that process slow the host-bound phases?

    python3 scripts/p13_pool_ab.py

Needs one CUDA card. Builds the two kernels phase 4 launches, makes
Qwen3-8B at full width from seed 0, and runs ``phase_main_path`` (both
epochs, every gate) six times: alone, twice beside the idle process
(after its counts), alone, while it counts, alone. Prints a line a run
(``AB <case>: phase 4 <s>, epochs [<s>, <s>]``)."""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402


def main():
    import numpy as np
    import torch
    from repro_torch.kernels import _build

    _build.build_all(["spec_verify", "suffix_match"])
    card = cs.card_line()
    cfg, params = cs.full_width_model(torch, "qwen3-8b")

    def run(tag):
        t0 = time.perf_counter()
        _, _, runs = cs.phase_main_path(torch, np, card, cfg, params)
        print(f"AB {tag}: phase 4 {time.perf_counter() - t0:.1f} s, epochs "
              f"{[round(r[2], 2) for r in runs]}  [{card}]", flush=True)

    run("alone 1")
    ex, futs = cs.start_p13_counts()
    for f in futs.values():
        f.result()
    run("pool idle 1")
    run("pool idle 2")
    ex.shutdown()
    run("alone 2")
    ex, futs = cs.start_p13_counts()
    run("pool counting")
    for f in futs.values():
        f.result()
    ex.shutdown()
    run("alone 3")


if __name__ == "__main__":
    main()
