"""Rollout watchdog: deadline stuck rounds and dead workers.

DAS exists to kill the long tail, so a single hung verify round or dead
worker silently re-creates the problem the paper solves. The watchdog
is a progress deadline threaded through the engine's round loops
(``SpecEngine.generate``/``serve``): the loop calls ``check()`` at the
top of every round and ``progress()`` whenever a round completes; if no
progress lands within ``deadline_s`` the check raises ``StallError``,
which ``MultiWorkerRollout`` catches to expire the worker and re-queue
its unfinished problems to survivors (token-identical at T=0 — greedy
verification makes outputs independent of which worker runs them).

Time flows through an injectable ``Clock``; chaos tests use a
``VirtualClock`` plus the ``on_check`` hook (installed by
``fault.inject.FaultPlan``) to trip a stall at an exact round number
with no wall-clock sleeps.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from .clock import Clock, SystemClock


class StallError(RuntimeError):
    """A watched loop made no progress within its deadline."""


class RolloutWatchdog:
    """Progress deadline for one engine's round loops."""

    def __init__(
        self,
        deadline_s: float = 60.0,
        *,
        clock: Optional[Clock] = None,
        on_check: Optional[Callable[["RolloutWatchdog"], None]] = None,
        flight=None,
    ) -> None:
        self.deadline_s = float(deadline_s)
        self.clock = clock or SystemClock()
        # Fault-injection hook: called on every check BEFORE the
        # deadline comparison (a FaultPlan advances a virtual clock
        # here to stall a chosen round deterministically).
        self.on_check = on_check
        # Optional flight recorder: a tripped deadline stamps a
        # ``stall`` event (no trace — the requeue path attributes the
        # stall to each salvaged trace with its ``handoff``).
        self.flight = flight
        self._last: Optional[float] = None
        self.checks = 0
        self.stalls = 0

    def arm(self) -> None:
        """(Re)start the deadline — call at loop entry so a new serve
        never inherits a stale progress timestamp."""
        self._last = self.clock.now()

    def progress(self) -> None:
        """A round completed: push the deadline out."""
        self._last = self.clock.now()

    def check(self, what: str = "round") -> None:
        """Raise ``StallError`` if the deadline elapsed with no
        progress. Self-arms on first use."""
        self.checks += 1
        if self.on_check is not None:
            self.on_check(self)
        if self._last is None:
            self._last = self.clock.now()
            return
        idle = self.clock.now() - self._last
        if idle > self.deadline_s:
            self.stalls += 1
            if self.flight is not None and self.flight.enabled:
                self.flight.record(None, "stall", what=what,
                                   idle_s=float(idle))
            raise StallError(
                f"{what} made no progress for {idle:.3f}s "
                f"(deadline {self.deadline_s:.3f}s)"
            )

    def snapshot(self) -> Dict[str, Any]:
        return {
            "deadline_s": self.deadline_s,
            "checks": self.checks,
            "stalls": self.stalls,
        }
