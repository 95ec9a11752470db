"""Rollout phase of the port (counterpart of ``repro.rl.rollout``):
batched generation with G samples per problem.

Wraps the speculative engine for RL: replicates each problem G times
(all G samples share the same per-problem suffix tree — exactly the
reuse the paper exploits), computes verifiable rewards, and packs the
result into a GRPO training batch. The baseline (no speculation) is the
same code path with ``spec_enabled=False``.

With ``continuous=True`` the worker streams the N = problems × G
requests through the engine's fixed slot pool instead of one padded
lock-step batch; outputs are token-identical at temperature 0.

The reference's JAX ``key`` is an explicit ``torch.Generator`` on the
engine's device here (``generator=``). Not ported yet: the watchdog and
the journal (they raise when given), resume from a salvaged journal,
and ``MultiWorkerRollout`` (the history service).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.spec_engine import RolloutStats, SpecEngine
from repro_torch.data.tasks import Problem, Task
from repro_torch.data.tokenizer import PAD
from repro_torch.rl.grpo import group_advantages


@dataclass
class RolloutBatch:
    tokens: np.ndarray  # (N, S) prompt+response, right-padded
    resp_mask: np.ndarray  # (N, S) bool, True on response tokens
    advantages: np.ndarray  # (N,)
    rewards: np.ndarray  # (N,)
    responses: List[List[int]]
    problems: List[Problem]
    stats: RolloutStats
    gen_time_s: float


def pack_train_arrays(
    prompts: Sequence[Sequence[int]], outs: Sequence[Sequence[int]]
) -> Tuple[np.ndarray, np.ndarray]:
    """Right-padded (tokens, resp_mask) train arrays, width rounded up to
    a multiple of 32."""
    N = len(prompts)
    S = max(len(p) + len(o) for p, o in zip(prompts, outs)) + 1
    S = ((S + 31) // 32) * 32
    tokens = np.full((N, S), PAD, np.int32)
    resp_mask = np.zeros((N, S), bool)
    for i, (p, o) in enumerate(zip(prompts, outs)):
        seq = list(p) + list(o)
        tokens[i, : len(seq)] = seq
        resp_mask[i, len(p) : len(seq)] = True
    return tokens, resp_mask


class RolloutWorker:
    def __init__(
        self,
        engine: SpecEngine,
        task: Task,
        group_size: int = 8,
        *,
        continuous: bool = False,
        slots: Optional[int] = None,
        watchdog=None,
        journal=None,
    ):
        for name, val in (("watchdog", watchdog), ("journal", journal)):
            if val is not None:
                raise NotImplementedError(
                    f"RolloutWorker(..., {name}=...) is not ported to "
                    "repro_torch yet"
                )
        self.engine = engine
        self.task = task
        self.G = group_size
        self.continuous = continuous
        self.slots = slots  # pool size; None = one slot per request

    def rollout(
        self,
        problems: Sequence[Problem],
        *,
        generator: Optional[torch.Generator] = None,
        max_new_tokens: Optional[int] = None,
        collect_effective_batch: bool = False,
        resume=None,
    ) -> RolloutBatch:
        """Roll out ``problems`` × G samples; at T > 0 the draws come from
        ``generator``. ``resume`` (salvaged journal sessions) is not
        ported yet and raises."""
        if resume is not None:
            raise NotImplementedError(
                "RolloutWorker.rollout(..., resume=...) is not ported to "
                "repro_torch yet"
            )
        t0 = time.perf_counter()
        prompts, pids, probs = [], [], []
        for p in problems:
            for _ in range(self.G):
                prompts.append(list(p.prompt))
                pids.append(p.pid)
                probs.append(p)
        if self.continuous:
            outs, stats = self.engine.generate_continuous(
                prompts, pids, slots=self.slots,
                max_new_tokens=max_new_tokens, generator=generator,
                collect_effective_batch=collect_effective_batch,
            )
        else:
            outs, stats = self.engine.generate(
                prompts, pids, max_new_tokens=max_new_tokens,
                generator=generator,
                collect_effective_batch=collect_effective_batch,
            )
        gen_time = time.perf_counter() - t0
        rewards = np.array(
            [self.task.reward(pr, o) for pr, o in zip(probs, outs)],
            np.float32,
        )
        adv = group_advantages(rewards, self.G)
        tokens, resp_mask = pack_train_arrays(prompts, outs)
        return RolloutBatch(
            tokens=tokens,
            resp_mask=resp_mask,
            advantages=adv.astype(np.float32),
            rewards=rewards,
            responses=outs,
            problems=probs,
            stats=stats,
            gen_time_s=gen_time,
        )


class MultiWorkerRollout:
    """N rollout workers over the pooled history service: not ported
    yet (it needs ``history/{service,client}``)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "MultiWorkerRollout (the multi-worker rollout over the history "
            "service) is not ported to repro_torch yet"
        )
