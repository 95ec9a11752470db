"""Epoch-based prompt loader.

RL post-training revisits the same dataset every epoch (the paper's
Insight-2); this loader makes that structure explicit: `epoch_batches`
yields shuffled batches of problems, and the epoch index feeds the
drafter's sliding window.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from .tasks import Problem, Task


class PromptLoader:
    def __init__(self, task: Task, batch_size: int, seed: int = 0) -> None:
        self.task = task
        self.problems = task.problems()
        self.batch_size = batch_size
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self._draws = 0  # epoch_batches calls (one rng draw each)

    def epoch_batches(self, epoch: int) -> Iterator[List[Problem]]:
        idx = np.arange(len(self.problems))
        rng = np.random.default_rng(self._rng.integers(1 << 31) + epoch)
        self._draws += 1
        rng.shuffle(idx)
        for s in range(0, len(idx), self.batch_size):
            chunk = idx[s : s + self.batch_size]
            yield [self.problems[i] for i in chunk]

    def seek(self, draws: int) -> None:
        """Rewind to a fresh RNG and replay ``draws`` epoch draws — puts
        the loader in the exact state a checkpointed run left it in, so
        a resumed trainer shuffles identically (warm-start parity)."""
        self._rng = np.random.default_rng(self.seed)
        self._draws = 0
        for _ in range(int(draws)):
            self._rng.integers(1 << 31)
            self._draws += 1

    def __len__(self) -> int:
        return (len(self.problems) + self.batch_size - 1) // self.batch_size
