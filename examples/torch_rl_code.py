"""Code-RL example on the PyTorch/CUDA port (paper §5.2 analogue):
bracket-closing task with unit-test-style exact-match rewards, GRPO +
DAS rollouts.

    PYTHONPATH=src python examples/torch_rl_code.py --steps 30

Runs on the CUDA card unless ``--device cpu`` is given.
``examples/rl_code.py`` is the same example on the JAX package.
"""

import argparse
import json

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.drafter import DrafterConfig
from repro_torch.core.spec_engine import EngineConfig
from repro_torch.data.tasks import BracketTask
from repro_torch.data.tokenizer import TOKENIZER
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.rl.trainer import Trainer, TrainerConfig


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--no-das", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card) or cpu")
    return ap.parse_args(argv)


def configs(args):
    """(model config, task, trainer config) of the example's flags."""
    cfg = ModelConfig(
        name="rl-code", family="dense", num_layers=3, d_model=128,
        num_heads=4, num_kv_heads=2, d_ff=256,
        vocab_size=TOKENIZER.vocab_size, vocab_pad_multiple=8,
        dtype="float32",
    )
    task = BracketTask(n_problems=16, depth=(2, 8), seed=0)
    tcfg = TrainerConfig(
        steps=args.steps, prompts_per_step=8, group_size=2,
        max_new_tokens=16, temperature=0.6, sft_warmup_steps=15,
        optim=AdamWConfig(lr=5e-4, warmup_steps=3),
        engine=EngineConfig(
            spec_enabled=not args.no_das, max_draft=4,
            block_buckets=(0, 4), eos_token=1,
        ),
        drafter=DrafterConfig(scope="problem+request", min_match=2),
    )
    return cfg, task, tcfg


def rl_code(args, params=None, device=None):
    """The example's body: returns (lines printed, the trainer's step
    records, the trainer). ``params`` (a ``Transformer`` on the device)
    replaces the trainer's seed-0 weights; ``device`` defaults to
    ``args.device``."""
    dev = resolve_device(args.device if device is None else device)
    cfg, task, tcfg = configs(args)
    tr = Trainer(cfg, task, tcfg, params=params, device=dev)
    try:
        hist = tr.run()
    finally:
        tr.close()
    lines = [json.dumps({k: round(v, 4) if isinstance(v, float) else v
                         for k, v in h.items()
                         if k in ("step", "reward_mean", "gen_time_s",
                                  "accept_per_round")})
             for h in hist[:: max(1, len(hist) // 10)]]
    lines.append(f"# final reward: {hist[-1]['reward_mean']:.3f}")
    return lines, hist, tr


def main() -> None:
    args = parse_args()
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"torch_rl_code needs a CUDA card: {e}")
    lines, _, _ = rl_code(args, device=dev)
    print("\n".join(lines))


if __name__ == "__main__":
    main()
