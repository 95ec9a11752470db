"""RL training entry point of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --smoke --device cpu --steps 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch recurrentgemma-9b --smoke

Every registered architecture trains: the dense decoders and the hybrid
RecurrentGemma (its RG-LRU scan differentiates through the scan's
backward kernel).

``--smoke`` trains the reduced variant (``smoke_variant``, the task
tokenizer's vocabulary) on the synthetic pattern task; without it the
full published config trains, random weights from the seed. It runs on
CUDA unless ``--device cpu`` is given, and prints one JSON line a step.
``--dry-run`` (lower the full config's train step on a mesh) needs
``launch/dryrun``, which is not ported yet: it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="train the reduced variant")
    ap.add_argument("--dry-run", action="store_true",
                    help="not ported yet (needs launch/dryrun)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--no-das", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch versions of "
                         "the kernels)")
    args = ap.parse_args()

    if args.dry_run:
        print("--dry-run needs repro_torch.launch.dryrun, which is not "
              "ported yet", file=sys.stderr)
        raise SystemExit(2)

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.core.drafter import DrafterConfig
    from repro_torch.core.spec_engine import EngineConfig
    from repro_torch.data.tasks import PatternTask
    from repro_torch.data.tokenizer import TOKENIZER
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.rl.trainer import Trainer, TrainerConfig

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg).replace(
            vocab_size=TOKENIZER.vocab_size, vocab_pad_multiple=8
        )
    task = PatternTask(n_problems=8, mean_len=12.0, sigma=0.6, max_len=32)
    tcfg = TrainerConfig(
        steps=args.steps, prompts_per_step=4, group_size=2,
        max_new_tokens=32, temperature=0.6, sft_warmup_steps=10,
        optim=AdamWConfig(lr=5e-4, warmup_steps=2),
        engine=EngineConfig(spec_enabled=not args.no_das, max_draft=8,
                            block_buckets=(0, 4, 8), eos_token=1),
        drafter=DrafterConfig(scope="problem+request", min_match=2),
    )
    tr = Trainer(cfg, task, tcfg, device=args.device)
    for h in tr.run():
        print(json.dumps({k: round(v, 4) if isinstance(v, float) else v
                          for k, v in h.items()}), flush=True)
    tr.close()


if __name__ == "__main__":
    main()
