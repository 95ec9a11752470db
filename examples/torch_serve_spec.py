"""Serving-style example on the PyTorch/CUDA port: batched requests
against a fixed policy with suffix-tree speculation warmed from previous
completions (the SuffixDecoding-style use of the same engine).

    PYTHONPATH=src python examples/torch_serve_spec.py --rounds 3 --batch 8

Runs on the CUDA card unless ``--device cpu`` is given.
``examples/serve_spec.py`` is the same example on the JAX package.
"""

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.drafter import DrafterConfig, SuffixDrafter
from repro_torch.core.spec_engine import EngineConfig, SpecEngine
from repro_torch.data.tokenizer import TOKENIZER
from repro_torch.models import model as M

BASE_QUERIES = [
    "abcabc", "xyxyxy", "123123", "hellohello", "foofoo", "barbar",
    "qweqwe", "zxzxzx",
]


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=48)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card) or cpu")
    return ap.parse_args(argv)


def model_config() -> ModelConfig:
    return ModelConfig(
        name="serve", family="dense", num_layers=3, d_model=128,
        num_heads=4, num_kv_heads=2, d_ff=256,
        vocab_size=TOKENIZER.vocab_size, vocab_pad_multiple=8,
        dtype="float32",
    )


def engine_configs(max_new: int):
    """(engine, drafter) configs."""
    return (
        EngineConfig(spec_enabled=True, max_new_tokens=max_new,
                     eos_token=1, max_draft=8, block_buckets=(0, 4, 8)),
        DrafterConfig(scope="problem+request", min_match=2),
    )


def serve_spec(args, params=None, device=None):
    """The example's body: returns (lines printed, per-round stats).
    ``params`` (a ``Transformer`` on the device) replaces the seed-0
    weights; ``device`` defaults to ``args.device``."""
    dev = resolve_device(args.device if device is None else device)
    cfg = model_config()
    if params is None:
        params = M.init_params(cfg, seed=0, device=dev)
    ecfg, dcfg = engine_configs(args.max_new)
    eng = SpecEngine(params, cfg, ecfg, drafter=SuffixDrafter(dcfg),
                     device=dev)
    lines, stats = [], []
    for rnd in range(args.rounds):
        prompts, pids = [], []
        for b in range(args.batch):
            q = BASE_QUERIES[b % len(BASE_QUERIES)]
            prompts.append(TOKENIZER.encode(q, bos=True))
            pids.append(q)  # repeated requests share a problem tree
        t0 = time.perf_counter()
        _, st = eng.generate(
            prompts, pids,
            generator=torch.Generator(device=dev).manual_seed(rnd))
        dt = time.perf_counter() - t0
        lines.append(
            f"round {rnd}: {dt*1e3:7.1f} ms  fwd={st.n_fwd:4d} "
            f"accept/round={st.acceptance_per_round:6.2f} "
            f"emitted/fwd={st.mean_accepted_per_fwd:5.2f}"
        )
        stats.append(st)
        eng.begin_iteration(rnd + 1)
    lines.append("# acceptance climbs round over round as completions "
                 "repeat")
    return lines, stats


def main() -> None:
    args = parse_args()
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"torch_serve_spec needs a CUDA card: {e}")
    lines, _ = serve_spec(args, device=dev)
    print("\n".join(lines))


if __name__ == "__main__":
    main()
