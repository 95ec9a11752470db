"""Serving entry point of the port (speculative generation, lock-step or
continuous).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b --smoke
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --smoke --continuous [--slots 4] [--requests 16]

``--smoke`` runs batched speculative generation of the reduced config
(``smoke_variant``) with random weights from ``--seed``, ``--rounds``
times over a stream of repeated problems, so later rounds draft from
earlier rounds' rollouts. With ``--continuous`` the request stream flows
through the slot-recycling pool (``--slots`` device rows,
longest-predicted-first admission) and each request is reported as it
finishes. It runs on CUDA unless ``--device cpu`` is given. Flags of
paths that are not ported yet are accepted and refused with a clear
error.
"""

from __future__ import annotations

import argparse
import logging

log = logging.getLogger("repro_torch.launch.serve")

# Flags of the reference launcher whose paths are not ported yet.
_NOT_PORTED = (
    ("history_service", "--history-service"),
    ("journal_dir", "--journal-dir"), ("history_dir", "--history-dir"),
    ("save_history", "--save-history"), ("trace_out", "--trace-out"),
    ("dry_run", "--dry-run"), ("supervise", "--supervise"),
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch versions of "
                         "the kernels)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and prompts")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--fuse", default="auto", choices=["auto", "on", "off"],
                    help="fused device-resident rounds; 'off' keeps the "
                         "unfused loop")
    ap.add_argument("--scope", default="problem+request",
                    choices=["problem", "problem+request", "global"],
                    help="drafter scope (fused rounds need a tree-only "
                         "scope: problem or global)")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching through a slot pool")
    ap.add_argument("--slots", type=int, default=4,
                    help="device slots in the continuous pool")
    ap.add_argument("--requests", type=int, default=0,
                    help="requests per round in continuous mode "
                         "(default: 2 x --batch)")
    # accepted for command-line parity with repro.launch.serve; refused
    ap.add_argument("--history-service", action="store_true")
    ap.add_argument("--journal-dir", default="")
    ap.add_argument("--history-dir", default="")
    ap.add_argument("--save-history", action="store_true")
    ap.add_argument("--trace-out", default="")
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--supervise", action="store_true")
    ap.add_argument("--metrics-port", type=int, default=-1)
    args = ap.parse_args()
    for attr, flag in _NOT_PORTED:
        if getattr(args, attr):
            ap.error(f"{flag} is not ported to repro_torch yet")
    if args.metrics_port >= 0:
        ap.error("--metrics-port is not ported to repro_torch yet")
    if not args.smoke:
        ap.error("only --smoke serving is ported so far")

    if not logging.getLogger().handlers:
        logging.basicConfig(
            level=logging.INFO,
            format="%(asctime)s %(name)s %(levelname)s %(message)s",
        )

    import time

    import numpy as np

    from repro_torch import resolve_device
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.core.drafter import DrafterConfig, SuffixDrafter
    from repro_torch.core.spec_engine import EngineConfig, SpecEngine
    from repro_torch.models import model as M

    dev = resolve_device(args.device)
    cfg = smoke_variant(get_config(args.arch))
    params = M.init_params(cfg, seed=args.seed, device=dev)
    eng = SpecEngine(
        params, cfg,
        EngineConfig(spec_enabled=True, max_new_tokens=32, eos_token=1,
                     max_draft=8, block_buckets=(0, 4, 8),
                     fuse_rounds=args.fuse),
        drafter=SuffixDrafter(DrafterConfig(scope=args.scope, min_match=2)),
        device=dev,
    )
    rng = np.random.default_rng(args.seed)
    if args.continuous:
        # Long-tailed request streams through the slot pool; each finished
        # request is logged as it leaves.
        from repro_torch.core.scheduler import Request
        from repro_torch.core.spec_engine import RolloutStats

        n_req = args.requests or 2 * args.batch
        for rnd in range(args.rounds):
            reqs = []
            for i in range(n_req):
                seed = i % 4
                reqs.append(Request(
                    rid=i, problem_id=f"q{seed}",
                    prompt=[2] + list(rng.integers(4, 20, size=4 + seed)),
                    max_new_tokens=8 * (1 + seed),
                ))
            st = RolloutStats()
            t0 = time.perf_counter()
            for fin in eng.serve(reqs, slots=args.slots, stats=st):
                log.info("  req %3d (%s) done: %3d toks, rounds %d->%d",
                         fin.rid, fin.problem_id, len(fin.output),
                         fin.admit_round, fin.finish_round)
            dt = time.perf_counter() - t0
            print(
                f"round {rnd}: {dt * 1e3:8.1f} ms {n_req} reqs / "
                f"{args.slots} slots makespan={st.n_rounds} rounds "
                f"fwd={st.n_fwd:4d} "
                f"tok/s={st.n_toks_emitted / max(dt, 1e-9):7.1f} "
                f"accept/round={st.acceptance_per_round:6.2f} device={dev}",
                flush=True,
            )
            eng.begin_iteration(rnd + 1)
        return
    for rnd in range(args.rounds):
        prompts, pids = [], []
        for b in range(args.batch):
            seed = b % 4
            prompts.append([2] + list(rng.integers(4, 20, size=4 + seed)))
            pids.append(f"q{seed}")
        t0 = time.perf_counter()
        outs, st = eng.generate(prompts, pids)
        dt = time.perf_counter() - t0
        print(
            f"round {rnd}: {dt * 1e3:8.1f} ms fwd={st.n_fwd:4d} "
            f"tokens={st.n_toks_emitted} accept/round="
            f"{st.acceptance_per_round:6.2f} device={dev}",
            flush=True,
        )
        eng.begin_iteration(rnd + 1)



if __name__ == "__main__":
    main()
