"""End-to-end driver on the PyTorch/CUDA port: GRPO RL training with
DAS-accelerated rollouts (the paper's Fig. 10 setup).

    PYTHONPATH=src python examples/torch_rl_math.py --steps 40 [--no-das]
    PYTHONPATH=src python examples/torch_rl_math.py --preset 100m --steps 300

The default preset is CPU-sized; ``--preset 100m`` builds a ~100M-param
policy (the deliverable configuration, sized for the card). An SFT
warmup stands in for the pretrained checkpoint the paper post-trains.
Runs on the CUDA card unless ``--device cpu`` is given.
``examples/rl_math.py`` is the same example on the JAX package.
"""

import argparse
import json

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.drafter import DrafterConfig
from repro_torch.core.spec_engine import EngineConfig
from repro_torch.data.tasks import PatternTask
from repro_torch.data.tokenizer import TOKENIZER
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.rl.trainer import Trainer, TrainerConfig

PRESETS = {
    "tiny": dict(num_layers=3, d_model=128, num_heads=4, num_kv_heads=2,
                 d_ff=256),
    "10m": dict(num_layers=6, d_model=320, num_heads=8, num_kv_heads=4,
                d_ff=1024),
    "100m": dict(num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
                 d_ff=2048),
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    ap.add_argument("--no-das", action="store_true")
    ap.add_argument("--temperature", type=float, default=0.6)
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--sft-warmup", type=int, default=10)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card) or cpu")
    return ap.parse_args(argv)


def configs(args):
    """(model config, task, trainer config) of the example's flags."""
    cfg = ModelConfig(
        name=f"rl-math-{args.preset}", family="dense",
        vocab_size=TOKENIZER.vocab_size, vocab_pad_multiple=8,
        dtype="float32", **PRESETS[args.preset],
    )
    task = PatternTask(n_problems=16, mean_len=18.0, sigma=0.8, max_len=64,
                       seed=0)
    tcfg = TrainerConfig(
        steps=args.steps, prompts_per_step=8, group_size=2,
        max_new_tokens=args.max_new, temperature=args.temperature,
        sft_warmup_steps=args.sft_warmup,
        optim=AdamWConfig(lr=3e-4, warmup_steps=5),
        engine=EngineConfig(
            spec_enabled=not args.no_das, max_draft=8,
            block_buckets=(0, 4, 8), eos_token=1,
        ),
        drafter=DrafterConfig(scope="problem+request", min_match=2,
                              adapt_window_to_updates=True),
        ckpt_path=args.ckpt, ckpt_every=20 if args.ckpt else 0,
    )
    return cfg, task, tcfg


def summary(hist) -> str:
    gen = sum(h["gen_time_s"] for h in hist)
    fwd = sum(h["n_fwd"] for h in hist)
    return (f"# total rollout time: {gen:.1f}s  forward passes: {fwd}  "
            f"final reward: {hist[-1]['reward_mean']:.3f}")


def rl_math(args, params=None, device=None):
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
                         for k, v in h.items()}) for h in hist]
    lines.append(summary(hist))
    return lines, hist, tr


def main() -> None:
    args = parse_args()
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"torch_rl_math needs a CUDA card: {e}")
    lines, _, _ = rl_math(args, device=dev)
    print("\n".join(lines))


if __name__ == "__main__":
    main()
