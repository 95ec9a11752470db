"""Per-shard health state machine + capped exponential backoff.

The ``HistoryClient`` tracks one ``ShardHealth`` per shard:

::

    HEALTHY --failure--> SUSPECT --more failures--> DOWN
       ^                    |                        |
       |<----success--------+          (backoff-gated probes)
       |                                             |
       +---- resynced ---- RESYNCING <---success-----+

* **HEALTHY** — RPCs flow normally.
* **SUSPECT** — a transport failure or ``rpc_timeout`` happened; the
  shard may just be slow. RPCs still flow (each one doubles as a
  probe); one success returns to HEALTHY, ``suspect_after``
  consecutive failures confirm DOWN.
* **DOWN** — the shard is unreachable. RPC attempts are gated by a
  capped exponential backoff with deterministic seeded jitter
  (``should_attempt``); between deadlines every call fails fast with
  ``ShardBackoffError`` instead of paying a connect timeout per call.
  Drafting falls back to bounded-stale replicas / local fallback trees
  (see ``SuffixDrafter``) — degraded acceptance, never a stall.
* **RESYNCING** — a probe succeeded after DOWN; the replica may be
  stale (or the shard restarted with a new generation). The client's
  next ``sync`` pulls the shard — hedged with a second immediate pull —
  and then marks the shard HEALTHY via ``resynced``.

Thread-safe: the sender thread records publish outcomes while the main
thread records sync outcomes and reads states for drafting decisions.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional

from .clock import Clock, SystemClock

HEALTHY = "healthy"
SUSPECT = "suspect"
DOWN = "down"
RESYNCING = "resyncing"


class ShardBackoffError(ConnectionError):
    """Raised (fast, no socket work) when a shard is DOWN and its
    backoff deadline has not passed. Subclasses ``ConnectionError`` so
    every existing ``except OSError`` transport-failure path handles
    it."""


@dataclass(frozen=True)
class BackoffPolicy:
    """Capped exponential backoff: delay(n) = min(max_s, base_s *
    factor**(n-1)), jittered by ±``jitter`` (fractional, seeded —
    deterministic per (seed, shard) so chaos tests replay exactly)."""

    base_s: float = 0.05
    max_s: float = 5.0
    factor: float = 2.0
    jitter: float = 0.25

    def delay(self, attempt: int, rng: random.Random) -> float:
        n = max(1, int(attempt))
        d = min(float(self.max_s), float(self.base_s) * float(self.factor) ** (n - 1))
        if self.jitter > 0:
            d *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(0.0, d)


class ShardHealth:
    """Health + backoff state for one shard, as seen by one client."""

    def __init__(
        self,
        shard_id: int,
        *,
        clock: Optional[Clock] = None,
        policy: Optional[BackoffPolicy] = None,
        suspect_after: int = 2,
        seed: int = 0,
    ) -> None:
        self.shard_id = int(shard_id)
        self.clock = clock or SystemClock()
        self.policy = policy or BackoffPolicy()
        self.suspect_after = max(1, int(suspect_after))
        # Deterministic jitter stream per (seed, shard): two clients
        # with different seeds never probe in lockstep (thundering
        # herd), while a replayed chaos test jitters identically.
        self._rng = random.Random((int(seed) << 16) ^ self.shard_id)
        self._lock = threading.Lock()
        # Optional observer called as on_transition(shard_id, old, new)
        # AFTER the lock is released whenever the state changes — the
        # telemetry layer hangs its shard-state event stream here.
        self.on_transition: Optional[Any] = None
        self.state = HEALTHY
        self.consecutive_failures = 0
        self.total_failures = 0
        self.down_transitions = 0
        self.recoveries = 0
        self._next_try = 0.0
        self._down_since: Optional[float] = None

    # -- gating ------------------------------------------------------------
    def should_attempt(self) -> bool:
        """False only while DOWN and inside the current backoff window."""
        with self._lock:
            if self.state != DOWN:
                return True
            return self.clock.now() >= self._next_try

    def retry_in(self) -> float:
        """Seconds until the next allowed attempt (0 when not gated)."""
        with self._lock:
            if self.state != DOWN:
                return 0.0
            return max(0.0, self._next_try - self.clock.now())

    # -- transitions -------------------------------------------------------
    def _notify(self, old: str, new: str) -> None:
        cb = self.on_transition
        if cb is not None and old != new:
            try:
                cb(self.shard_id, old, new)
            except Exception:  # dascheck: disable=DAS303 -- observers must never break RPC paths
                pass

    def record_failure(self) -> str:
        """One failed RPC (connect refused, timeout, torn frame).
        Returns the resulting state."""
        with self._lock:
            old = self.state
            self.consecutive_failures += 1
            self.total_failures += 1
            if self.state == DOWN or \
                    self.consecutive_failures >= self.suspect_after:
                if self.state != DOWN:
                    self.down_transitions += 1
                    self._down_since = self.clock.now()
                self.state = DOWN
                # Backoff grows with every failed probe while DOWN.
                self._next_try = self.clock.now() + self.policy.delay(
                    self.consecutive_failures - self.suspect_after + 1,
                    self._rng,
                )
            else:
                # RESYNCING that fails again is back to SUSPECT — the
                # recovery did not stick.
                self.state = SUSPECT
            new = self.state
        self._notify(old, new)
        return new

    def record_success(self) -> bool:
        """One successful RPC. Returns True when this success is a
        *recovery* from DOWN — the caller owes the shard a (hedged)
        resync before trusting its replica again."""
        with self._lock:
            old = self.state
            was_down = self.state == DOWN
            self.consecutive_failures = 0
            self._next_try = 0.0
            if was_down:
                self.state = RESYNCING
                self.recoveries += 1
                self._down_since = None
            elif self.state == SUSPECT:
                self.state = HEALTHY
            new = self.state
        self._notify(old, new)
        return was_down

    def resynced(self) -> None:
        """The post-recovery full sync completed: RESYNCING → HEALTHY."""
        with self._lock:
            old = self.state
            if self.state == RESYNCING:
                self.state = HEALTHY
            new = self.state
        self._notify(old, new)

    # -- introspection -----------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "state": self.state,
                "consecutive_failures": self.consecutive_failures,
                "total_failures": self.total_failures,
                "down_transitions": self.down_transitions,
                "recoveries": self.recoveries,
                "retry_in_s": (
                    max(0.0, self._next_try - self.clock.now())
                    if self.state == DOWN else 0.0
                ),
            }
