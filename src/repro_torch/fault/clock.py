"""Injectable clocks for the fault-tolerance layer (copy of
``repro.fault.clock``).

Every time-dependent mechanism (request deadlines, preemption margins
in the serve loop; backoff and watchdog deadlines once ported) reads
time through a ``Clock`` object instead of calling ``time`` directly.
Production uses ``SystemClock``; tests use ``VirtualClock`` and advance
time explicitly — a deadline "elapses" instantly and deterministically,
with no wall-clock sleeps anywhere in the suite.
"""

from __future__ import annotations

import threading
import time


class Clock:
    """Monotonic clock interface (seconds)."""

    def now(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError


class SystemClock(Clock):
    """Real monotonic time (production default)."""

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


class VirtualClock(Clock):
    """Manually advanced clock for deterministic tests.

    ``sleep`` advances the clock instead of blocking, so code written
    against ``Clock`` runs at full speed under test. Not for use with
    free-running background threads (a sender loop sleeping on virtual
    time would spin) — pair it with synchronous/polled code paths.
    """

    def __init__(self, start: float = 0.0) -> None:
        self._now = float(start)
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._now

    def sleep(self, seconds: float) -> None:
        self.advance(max(0.0, float(seconds)))

    def advance(self, seconds: float) -> float:
        with self._lock:
            self._now += float(seconds)
            return self._now
