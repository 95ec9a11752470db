"""Quickstart on the PyTorch/CUDA port: speculative decoding with a
per-problem suffix-tree drafter.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Builds a tiny policy, runs one plain rollout to seed the drafter's
history, then generates again with DAS — outputs are token-identical
(lossless) while forward passes drop. Runs on the CUDA card unless
``--device cpu`` is given (the kernels' plain PyTorch versions).
``examples/quickstart.py`` is the same example on the JAX package.
"""

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.drafter import DrafterConfig, SuffixDrafter
from repro_torch.core.spec_engine import EngineConfig, SpecEngine
from repro_torch.data.tokenizer import TOKENIZER
from repro_torch.models import model as M


def model_config() -> ModelConfig:
    return ModelConfig(
        name="quickstart", family="dense", num_layers=2, d_model=96,
        num_heads=4, num_kv_heads=2, d_ff=192,
        vocab_size=TOKENIZER.vocab_size, vocab_pad_multiple=8,
        dtype="float32",
    )


def engine_configs():
    """(baseline engine, DAS engine, DAS drafter) configs."""
    return (
        EngineConfig(spec_enabled=False, max_new_tokens=32, eos_token=1),
        EngineConfig(spec_enabled=True, max_new_tokens=32, eos_token=1),
        DrafterConfig(scope="problem+request", min_match=2),
    )


def quickstart(params=None, device="cuda"):
    """The example's body: returns (lines printed, baseline (outputs,
    stats), DAS (outputs, stats)). ``params`` (a ``Transformer`` on
    ``device``) replaces the seed-0 weights."""
    dev = resolve_device(device)
    cfg = model_config()
    if params is None:
        params = M.init_params(cfg, seed=0, device=dev)
    prompts = [TOKENIZER.encode("ababab", bos=True),
               TOKENIZER.encode("12341234", bos=True)]
    pids = ["p0", "p1"]
    base_cfg, das_cfg, dcfg = engine_configs()
    lines = []

    baseline = SpecEngine(params, cfg, base_cfg, device=dev)
    out0, st0 = baseline.generate(
        prompts, pids, generator=torch.Generator(device=dev).manual_seed(1))
    lines.append(f"baseline: {[TOKENIZER.decode(o) for o in out0]}")
    lines.append(f"  forward passes: {st0.n_fwd}")

    das = SpecEngine(params, cfg, das_cfg, drafter=SuffixDrafter(dcfg),
                     device=dev)
    # seed history (in RL training this happens automatically every epoch)
    for pid, p, o in zip(pids, prompts, out0):
        das.drafter.observe_rollout(pid, list(p) + list(o), epoch=0)
        for _ in range(5):
            das.length_policy.observe(pid, len(o))
    out1, st1 = das.generate(
        prompts, pids, generator=torch.Generator(device=dev).manual_seed(2))
    lines.append(f"DAS:      {[TOKENIZER.decode(o) for o in out1]}")
    lines.append(f"  forward passes: {st1.n_fwd}  (accept/round: "
                 f"{st1.acceptance_per_round:.2f})")
    assert out0 == out1, "lossless: outputs must be identical"
    lines.append(f"LOSSLESS ✓  speedup in forward passes: "
                 f"{st0.n_fwd / max(st1.n_fwd, 1):.2f}x")
    return lines, (out0, st0), (out1, st1)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card) or cpu")
    args = ap.parse_args()
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"torch_quickstart needs a CUDA card: {e}")
    lines, _, _ = quickstart(device=dev)
    print("\n".join(lines))


if __name__ == "__main__":
    main()
