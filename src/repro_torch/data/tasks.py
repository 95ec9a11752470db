"""Synthetic verifiable RL tasks.

Three task families mirror the paper's two evaluation domains plus a
long-tail stressor, all with *programmatic* (verifiable) rewards:

* ``PatternTask``  — continue a repeating token pattern to a per-problem
  target length. Target lengths are sampled from a log-normal, giving
  exactly the long-tailed rollout-length distribution the paper
  identifies as the makespan bottleneck (Fig. 1). Learnable by tiny
  models, and rollouts for the same problem are highly similar across
  epochs (Fig. 2's reuse property) — this is the headline e2e task.
* ``ArithmeticTask`` — single/multi-digit modular sums ("math RL"):
  prompt "a+b=", answer digits then EOS, binary reward.
* ``BracketTask``   — emit the closing sequence for a stack of open
  brackets in reverse order ("code RL": unit-test-like exact check).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .tokenizer import BOS, EOS, SEP, TOKENIZER


@dataclass
class Problem:
    pid: int
    prompt: List[int]  # token ids
    meta: dict


class Task:
    name = "task"

    def problems(self) -> List[Problem]:
        raise NotImplementedError

    def reward(self, problem: Problem, response: Sequence[int]) -> float:
        """Verifiable reward for a generated token sequence (EOS-free)."""
        raise NotImplementedError


class PatternTask(Task):
    """Continue the repeating pattern for `target_len` tokens, then stop."""

    name = "pattern"

    def __init__(
        self,
        n_problems: int = 32,
        pattern_len: Tuple[int, int] = (2, 5),
        mean_len: float = 24.0,
        sigma: float = 0.6,
        max_len: int = 160,
        vocab_lo: int = 4,
        vocab_hi: int = 40,
        seed: int = 0,
    ) -> None:
        rng = np.random.default_rng(seed)
        self._problems: List[Problem] = []
        for pid in range(n_problems):
            m = int(rng.integers(pattern_len[0], pattern_len[1] + 1))
            pat = rng.integers(vocab_lo, vocab_hi, size=m).tolist()
            # log-normal target length → long-tail across problems (Fig. 1)
            tl = int(np.clip(rng.lognormal(np.log(mean_len), sigma), 4, max_len))
            prompt = [BOS] + pat + pat + [SEP]
            self._problems.append(
                Problem(pid, prompt, {"pattern": pat, "target_len": tl})
            )

    def problems(self) -> List[Problem]:
        return list(self._problems)

    def expected_response(self, problem: Problem) -> List[int]:
        pat = problem.meta["pattern"]
        tl = problem.meta["target_len"]
        reps = (tl + len(pat) - 1) // len(pat)
        return (pat * reps)[:tl]

    def reward(self, problem: Problem, response: Sequence[int]) -> float:
        want = self.expected_response(problem)
        got = [int(t) for t in response]
        # dense shaping: positionwise match fraction (group-relative
        # advantages need within-group variance), +0.5 exact-stop bonus
        n_ok = sum(1 for w, g in zip(want, got) if w == g)
        shaped = n_ok / max(len(want), 1)
        exact = 0.5 if got == want else 0.0
        length_pen = 0.1 * max(0, len(got) - len(want)) / max(len(want), 1)
        return float(np.clip(shaped + exact - length_pen, 0.0, 1.5))


class ArithmeticTask(Task):
    """a+b= → digits of (a+b) then EOS. Binary exact-match reward."""

    name = "arithmetic"

    def __init__(self, n_problems: int = 32, digits: int = 1, seed: int = 0):
        rng = np.random.default_rng(seed + 1)
        self._problems = []
        hi = 10 ** digits
        for pid in range(n_problems):
            a, b = int(rng.integers(0, hi)), int(rng.integers(0, hi))
            prompt = TOKENIZER.encode(f"{a}+{b}=", bos=True)
            ans = TOKENIZER.encode(str(a + b))
            self._problems.append(Problem(pid, prompt, {"answer": ans}))

    def problems(self) -> List[Problem]:
        return list(self._problems)

    def expected_response(self, problem: Problem) -> List[int]:
        return list(problem.meta["answer"])

    def reward(self, problem: Problem, response: Sequence[int]) -> float:
        want = problem.meta["answer"]
        got = [int(t) for t in response]
        if got == want:
            return 1.0
        n_ok = sum(1 for w, g in zip(want, got) if w == g)
        return 0.25 * n_ok / max(len(want), 1)


_OPEN = {k: v for k, v in zip("([{<", ")]}>")}


class BracketTask(Task):
    """Close a stack of open brackets in reverse order (code-like)."""

    name = "bracket"

    def __init__(self, n_problems: int = 32, depth: Tuple[int, int] = (2, 10),
                 seed: int = 0):
        rng = np.random.default_rng(seed + 2)
        self._problems = []
        opens = list(_OPEN.keys())
        for pid in range(n_problems):
            d = int(rng.integers(depth[0], depth[1] + 1))
            seq = [opens[int(rng.integers(0, len(opens)))] for _ in range(d)]
            close = [_OPEN[c] for c in reversed(seq)]
            prompt = TOKENIZER.encode("".join(seq), bos=True) + [SEP]
            self._problems.append(
                Problem(pid, prompt, {"answer": TOKENIZER.encode("".join(close))})
            )

    def problems(self) -> List[Problem]:
        return list(self._problems)

    def expected_response(self, problem: Problem) -> List[int]:
        return list(problem.meta["answer"])

    def reward(self, problem: Problem, response: Sequence[int]) -> float:
        want = problem.meta["answer"]
        got = [int(t) for t in response]
        if got == want:
            return 1.0
        n_ok = 0
        for w, g in zip(want, got):
            if w != g:
                break
            n_ok += 1
        return 0.5 * n_ok / max(len(want), 1)


TASKS = {t.name: t for t in (PatternTask, ArithmeticTask, BracketTask)}


def make_task(name: str, **kw) -> Task:
    if name == "pattern":
        return PatternTask(**kw)
    if name == "arithmetic":
        return ArithmeticTask(**kw)
    if name == "bracket":
        return BracketTask(**kw)
    raise ValueError(f"unknown task {name}")
