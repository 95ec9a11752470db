"""Runtime length prediction via length classes (paper §4.2.3).

Generation lengths are highly stochastic (Fig. 9), so instead of point
prediction DAS partitions requests into three classes — Long / Medium /
Short — each mapped to a speculative budget:

1. class thresholds come from historical length quantiles,
2. a request's *initial* class is the historical class distribution for
   its problem (init-from-history),
3. during generation the class is updated from the observed partial
   length l: Class = argmax_c P(c | l, Init), estimated empirically from
   history (among historical rollouts of this problem with final length
   >= l, how often did each class occur, blended with the init prior).
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SHORT, MEDIUM, LONG = 0, 1, 2
CLASS_NAMES = ("short", "medium", "long")


@dataclass
class LengthPolicyConfig:
    # Quantiles that split Short | Medium | Long.
    q_short: float = 0.5
    q_long: float = 0.8
    # Per-class per-round draft budgets (tokens). Short disables SD.
    budget_short: int = 0
    budget_medium: int = 6
    budget_long: int = 16
    # Blend weight for the init prior vs the runtime conditional.
    prior_weight: float = 0.3
    # Fallback until enough history exists.
    default_budget: int = 6
    min_history: int = 4


class LengthPolicy:
    """History-backed Long/Medium/Short classifier + budget mapper."""

    def __init__(self, cfg: Optional[LengthPolicyConfig] = None) -> None:
        self.cfg = cfg or LengthPolicyConfig()
        self._hist: Dict[object, List[float]] = collections.defaultdict(list)
        self._all: List[float] = []
        self._thresholds: Optional[Tuple[float, float]] = None

    # -- history ----------------------------------------------------------
    def observe(self, problem_id, final_length: float) -> None:
        self._hist[problem_id].append(float(final_length))
        self._all.append(float(final_length))
        self._thresholds = None  # lazily recomputed

    def observe_many(self, problem_id, lengths) -> None:
        """Batched ``observe`` (pooled cross-worker telemetry merges)."""
        for L in lengths:
            self._hist[problem_id].append(float(L))
            self._all.append(float(L))
        if lengths:
            self._thresholds = None

    def history_size(self, problem_id=None) -> int:
        return len(self._all) if problem_id is None else len(self._hist[problem_id])

    def thresholds(self) -> Tuple[float, float]:
        """(t_short, t_long): global length quantiles."""
        if self._thresholds is None:
            if len(self._all) < self.cfg.min_history:
                self._thresholds = (float("inf"), float("inf"))
            else:
                arr = np.asarray(self._all, dtype=np.float64)
                self._thresholds = (
                    float(np.quantile(arr, self.cfg.q_short)),
                    float(np.quantile(arr, self.cfg.q_long)),
                )
        return self._thresholds

    def classify_length(self, length: float) -> int:
        # Strict lower boundary so tied quantiles (many equal-length
        # rollouts) degrade to MEDIUM rather than disabling speculation.
        t_s, t_l = self.thresholds()
        if t_s == float("inf"):
            # No thresholds yet (history < min_history): every length
            # would compare below +inf and classify SHORT — budget 0,
            # silently disabling speculation for direct callers. Stay
            # MEDIUM until real quantiles exist.
            return MEDIUM
        if length < t_s:
            return SHORT
        if length <= t_l:
            return MEDIUM
        return LONG

    # -- init from history ------------------------------------------------
    def init_class(self, problem_id) -> int:
        """Most likely class from this problem's historical lengths
        (falls back to MEDIUM without history)."""
        h = self._hist.get(problem_id, ())
        if len(h) < 1 or len(self._all) < self.cfg.min_history:
            return MEDIUM
        counts = np.zeros(3)
        for L in h:
            counts[self.classify_length(L)] += 1
        return int(np.argmax(counts))

    def init_prior(self, problem_id) -> np.ndarray:
        h = self._hist.get(problem_id, ())
        prior = np.ones(3) / 3.0
        if len(h) >= 1 and len(self._all) >= self.cfg.min_history:
            counts = np.full(3, 0.5)
            for L in h:
                counts[self.classify_length(L)] += 1
            prior = counts / counts.sum()
        return prior

    # -- runtime update -----------------------------------------------------
    def _survivor_likelihood(self, pool, partial_length: float) -> np.ndarray:
        """Class distribution among rollouts of `pool` with final length
        >= l; [0, 0, 1] when l exceeds everything seen (definitely Long)."""
        surv = [L for L in pool if L >= partial_length]
        if not surv:
            return np.array([0.0, 0.0, 1.0])
        counts = np.full(3, 1e-3)
        for L in surv:
            counts[self.classify_length(L)] += 1
        return counts / counts.sum()

    def posterior(self, problem_id, partial_length: float) -> np.ndarray:
        """P(c | l, Init): empirical class distribution among historical
        rollouts with final length >= l, blended with the init prior.

        With thin per-problem history (1-3 samples) the per-problem
        survivor pool alone yields a degenerate likelihood, so it is
        blended with the global survivor pool, weighted by how much
        per-problem evidence exists, until per-problem history reaches
        ``min_history``.
        """
        prior = self.init_prior(problem_id)
        if len(self._all) < self.cfg.min_history:
            return prior
        h = self._hist.get(problem_id, ())
        if len(h) >= self.cfg.min_history:
            like = self._survivor_likelihood(h, partial_length)
        else:
            like = self._survivor_likelihood(self._all, partial_length)
            if h:
                lam = len(h) / float(self.cfg.min_history)
                like = (
                    lam * self._survivor_likelihood(h, partial_length)
                    + (1.0 - lam) * like
                )
        w = self.cfg.prior_weight
        post = w * prior + (1.0 - w) * like
        # A partial length already above a threshold rules classes out.
        t_s, t_l = self.thresholds()
        if partial_length >= t_s:
            post[SHORT] = 0.0
        if partial_length > t_l:
            post[MEDIUM] = 0.0
        s = post.sum()
        return post / s if s > 0 else np.array([0.0, 0.0, 1.0])

    def classify(self, problem_id, partial_length: float) -> int:
        return int(np.argmax(self.posterior(problem_id, partial_length)))

    # -- budgets -----------------------------------------------------------
    def budget_for_class(self, cls: int) -> int:
        return (
            self.cfg.budget_short,
            self.cfg.budget_medium,
            self.cfg.budget_long,
        )[int(cls)]

    def budget(self, problem_id, partial_length: float) -> int:
        if len(self._all) < self.cfg.min_history:
            return self.cfg.default_budget
        return self.budget_for_class(self.classify(problem_id, partial_length))

    def expected_length(self, problem_id) -> float:
        """Point prediction for the budget solver (mean of history; global
        mean fallback)."""
        h = self._hist.get(problem_id)
        if h:
            return float(np.mean(h))
        if self._all:
            return float(np.mean(self._all))
        return 256.0

    # -- persistence -------------------------------------------------------
    def state_dict(self) -> dict:
        """JSON-able snapshot (problem ids must be str/int). Per-problem
        lists keep chronological order; ``_all`` is consumed only through
        order-insensitive reductions (quantiles/means), so the global
        interleaving is not preserved."""
        return {
            "all": [float(x) for x in self._all],
            "hist": [[k, [float(x) for x in v]] for k, v in self._hist.items()],
        }

    def load_state_dict(self, state: dict) -> None:
        self._all = [float(x) for x in state["all"]]
        self._hist = collections.defaultdict(list)
        for k, v in state["hist"]:
            self._hist[k] = [float(x) for x in v]
        self._thresholds = None
