"""Length-aware speculation budgets (paper §4.2).

Implements the paper's analytic pipeline exactly:

* Eq. (1):  t_fwd = c_base + c_tok · n_toks        (linear latency model)
* Eq. (2):  t_total = c_base·N_fwd + c_tok·N_toks + C
* Eq. (3):  A_i(p_i) = k_i l_i (1 - exp(-α_i p_i / l_i))   (saturating
            acceptance — Appendix C derivation)
* Eq. (7):  closed-form optimal budget p_i*(N_fwd)
* Eq. (8):  single-variable objective J(N_fwd)
* Eq. (9):  stationarity condition, solved by bisection (the constraint
            sum is strictly decreasing in N_fwd, so Eq. 9's LHS is
            monotonically increasing — a root bracket always exists).

Everything here is host-side numpy: budgets are recomputed between
device steps, exactly where the paper places this logic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclass
class LatencyModel:
    """t_fwd = c_base + c_tok * n_toks; t_total adds the constant C."""

    c_base: float = 1.0
    c_tok: float = 0.01
    overhead: float = 0.0  # C in Eq. (2)

    def t_fwd(self, n_toks) -> np.ndarray:
        return self.c_base + self.c_tok * np.asarray(n_toks, dtype=np.float64)

    def t_total(self, n_fwd: float, n_toks: float) -> float:
        return float(self.c_base * n_fwd + self.c_tok * n_toks + self.overhead)

    @staticmethod
    def fit(n_toks: Sequence[float], times: Sequence[float]) -> "LatencyModel":
        """Least-squares fit of (c_base, c_tok) from profiled forward
        passes — reproduces Fig. 8's linear fit."""
        x = np.asarray(n_toks, dtype=np.float64)
        y = np.asarray(times, dtype=np.float64)
        A = np.stack([np.ones_like(x), x], axis=1)
        (b, m), *_ = np.linalg.lstsq(A, y, rcond=None)
        return LatencyModel(c_base=float(b), c_tok=float(max(m, 1e-12)))

    def mean_relative_error(
        self, n_toks: Sequence[float], times: Sequence[float]
    ) -> float:
        y = np.asarray(times, dtype=np.float64)
        pred = self.t_fwd(n_toks)
        return float(np.mean(np.abs(pred - y) / np.maximum(np.abs(y), 1e-12)))


@dataclass
class AcceptanceModel:
    """Per-request saturating acceptance A(p) = k·l·(1 - exp(-α p / l))."""

    alpha: float = 1.0  # draft efficiency α_i > 0
    k: float = 0.8  # drafter capacity k_i ∈ (0, 1]

    def accepted(self, p, l) -> np.ndarray:
        p = np.asarray(p, dtype=np.float64)
        l = np.maximum(np.asarray(l, dtype=np.float64), 1e-9)
        return self.k * l * (1.0 - np.exp(-self.alpha * p / l))

    @staticmethod
    def fit(
        proposed: Sequence[float], accepted: Sequence[float], length: float
    ) -> "AcceptanceModel":
        """Moment-style fit of (α, k) from observed (proposed, accepted)
        counts for one request/problem. Robust to tiny samples."""
        p = np.asarray(proposed, dtype=np.float64)
        a = np.asarray(accepted, dtype=np.float64)
        if len(p) == 0 or float(p.sum()) <= 0:
            return AcceptanceModel()
        l = max(float(length), 1.0)
        # k̂: plateau of acceptance ratio; α̂: initial slope a ≈ α p for p≪l.
        ratio = np.clip(a.sum() / max(p.sum(), 1e-9), 1e-3, 1.0)
        k = float(np.clip(ratio * 1.25, 0.05, 1.0))
        small = p < 0.25 * l
        if small.any() and float(p[small].sum()) > 0:
            alpha = float(np.clip(a[small].sum() / p[small].sum(), 1e-3, 4.0))
        else:
            alpha = float(np.clip(ratio, 1e-3, 4.0))
        return AcceptanceModel(alpha=alpha, k=k)


def residual_tokens(
    n_fwd: np.ndarray, l: np.ndarray, alpha: np.ndarray, k: np.ndarray,
    p: np.ndarray,
) -> np.ndarray:
    """l_i (1 - k_i + k_i exp(-α_i p_i / l_i)) — tokens still to decode."""
    l = np.maximum(l, 1e-9)
    return l * (1.0 - k + k * np.exp(-alpha * p / l))


def optimal_budgets(
    n_fwd: float, l: np.ndarray, alpha: np.ndarray, k: np.ndarray
) -> np.ndarray:
    """Eq. (7), corrected: p_i*(N_fwd); zero for l_i <= N_fwd.

    NOTE (paper erratum): the paper prints p* = -(l/α)·ln(1 - k(1 - N/l)),
    but solving its own tight constraint l(1-k+k·e^{-αp/l}) = N gives
        p* = -(l/α) · ln( (N/l - 1 + k) / k ),
    which coincides with the printed form only at k = 1. We implement the
    corrected form (the printed one fails the J-minimality property test
    for k < 1); see EXPERIMENTS.md §Budget-erratum.
    """
    l = np.asarray(l, dtype=np.float64)
    alpha = np.asarray(alpha, dtype=np.float64)
    k = np.asarray(k, dtype=np.float64)
    active = l > n_fwd
    # (N/l - 1 + k)/k > 0 requires N > l(1-k) (feasibility); clamp anyway.
    inner = (n_fwd / np.maximum(l, 1e-9) - 1.0 + k) / np.maximum(k, 1e-9)
    inner = np.clip(inner, 1e-12, 1.0)
    p = -(l / np.maximum(alpha, 1e-9)) * np.log(inner)
    return np.where(active, np.maximum(p, 0.0), 0.0)


def objective(
    n_fwd: float,
    l: np.ndarray,
    alpha: np.ndarray,
    k: np.ndarray,
    lat: LatencyModel,
) -> float:
    """Eq. (8): J(N_fwd) with p_i = p_i*(N_fwd)."""
    p = optimal_budgets(n_fwd, l, alpha, k)
    return lat.t_total(n_fwd, float(p.sum()))


def _stationarity(
    n_fwd: float, l: np.ndarray, alpha: np.ndarray, k: np.ndarray,
    lat: LatencyModel,
) -> float:
    """dJ/dN with the corrected p* (see optimal_budgets erratum note):

        J'(N) = c_base - c_tok · Σ_{l_i>N}  l_i / (α_i · (N - l_i(1-k_i)))

    Each sum term is strictly decreasing in N, so J' is strictly
    increasing — bisection on a sign change brackets the optimum. As
    N ↓ max_i l_i(1-k_i), J' → -∞; as N ↑ max_i l_i the active set
    empties and J' → c_base > 0.
    """
    l = np.asarray(l, dtype=np.float64)
    active = l > n_fwd
    if not active.any():
        return lat.c_base
    la, aa, ka = l[active], alpha[active], k[active]
    denom = aa * (n_fwd - la * (1.0 - ka))
    return lat.c_base - lat.c_tok * float(np.sum(la / np.maximum(denom, 1e-12)))


def solve_budgets(
    lengths: Sequence[float],
    lat: LatencyModel,
    alpha: Optional[Sequence[float]] = None,
    k: Optional[Sequence[float]] = None,
    max_budget: Optional[float] = None,
    tol: float = 1e-6,
) -> Tuple[np.ndarray, float]:
    """Solve Eq. (6) for the whole batch.

    Returns (p*, N_fwd*): per-request total speculative budgets and the
    optimal number of forward passes. `lengths` are (predicted) remaining
    generation lengths l_i.
    """
    l = np.asarray(lengths, dtype=np.float64)
    n = len(l)
    a = np.full(n, 1.0) if alpha is None else np.asarray(alpha, np.float64)
    kk = np.full(n, 0.8) if k is None else np.asarray(k, np.float64)
    a = np.clip(a, 1e-3, None)
    kk = np.clip(kk, 1e-3, 1.0)
    if n == 0:
        return np.zeros(0), 0.0
    # Bracket: N_fwd ∈ [max_i l_i(1-k_i), max_i l_i]. Below the lower end
    # some request can never fit; at the top no speculation is needed.
    lo = float(np.max(l * (1.0 - kk))) + 1e-9
    hi = float(np.max(l))
    if _stationarity(lo, l, a, kk, lat) >= 0.0:
        # c_base too small (token cost dominates): no speculation pays off
        # beyond what the boundary requires; pick the boundary itself.
        n_star = lo if objective(lo, l, a, kk, lat) < objective(hi, l, a, kk, lat) else hi
    elif _stationarity(hi, l, a, kk, lat) <= 0.0:
        n_star = hi  # base cost dominates everywhere: still capped at max l
    else:
        for _ in range(200):
            mid = 0.5 * (lo + hi)
            if _stationarity(mid, l, a, kk, lat) < 0.0:
                lo = mid
            else:
                hi = mid
            if hi - lo <= tol * max(1.0, hi):
                break
        n_star = 0.5 * (lo + hi)
    p = optimal_budgets(n_star, l, a, kk)
    if max_budget is not None:
        p = np.minimum(p, float(max_budget))
    return p, float(n_star)


def per_round_budgets(
    total_budgets: np.ndarray,
    lengths: Sequence[float],
    round_cap: int,
) -> np.ndarray:
    """Convert total speculative budgets p_i into a per-verify-round draft
    length: p_i is spent over ≈ N_fwd rounds; we spread it uniformly and
    clamp to the engine's round cap. Short requests (p_i = 0) get 0 —
    'short generations should skip speculation' (Obs. 2)."""
    p = np.asarray(total_budgets, dtype=np.float64)
    l = np.maximum(np.asarray(lengths, dtype=np.float64), 1.0)
    # Expected rounds if we decode l tokens at >=1 accepted/round is <= l;
    # uniform spread p/l extra drafts per emitted token, scaled to a round.
    per_round = np.ceil(p / np.maximum(l, 1.0) * np.maximum(round_cap, 1))
    per_round = np.where(p <= 0, 0, np.maximum(per_round, 1))
    return np.minimum(per_round, round_cap).astype(np.int64)
