"""Graceful-drain controller: SIGTERM/SIGINT → stop admissions, finish
or journal-and-exit within a Clock-driven deadline.

A ``DrainController`` is the one object shared between a signal handler
and a serving loop. The handler (installed by ``install()``) only flips
a flag and stamps the drain start time — both async-signal-safe. The
serve loop polls ``draining`` (stop admitting new requests) and
``expired`` (deadline overrun: journal resident progress and exit);
everything reads the injectable ``repro_torch.fault.clock.Clock``, so the
drain-deadline chaos tests run on a ``VirtualClock`` with zero sleeps
(dascheck DAS201 keeps it that way).
"""

from __future__ import annotations

import logging
import signal as _signal
from typing import Optional

from .clock import Clock, SystemClock

log = logging.getLogger("repro_torch.fault.drain")


class DrainController:
    """Shared drain state between signal handlers and serving loops."""

    def __init__(
        self,
        deadline_s: float = 30.0,
        *,
        clock: Optional[Clock] = None,
        telemetry=None,
    ) -> None:
        from repro_torch import obs

        self.deadline_s = float(deadline_s)
        self.clock = clock if clock is not None else SystemClock()
        self.telemetry = telemetry if telemetry is not None else obs.NULL
        self.reason = ""
        self._t0: Optional[float] = None
        self._installed = []

    # -- state ------------------------------------------------------------
    @property
    def draining(self) -> bool:
        return self._t0 is not None

    def expired(self) -> bool:
        """True once the drain deadline has passed: residents must
        journal-and-exit instead of finishing."""
        if self._t0 is None:
            return False
        return (self.clock.now() - self._t0) >= self.deadline_s

    def remaining(self) -> float:
        if self._t0 is None:
            return float("inf")
        return max(0.0, self.deadline_s - (self.clock.now() - self._t0))

    def request(self, reason: str = "manual") -> None:
        """Start draining (idempotent — the first reason wins)."""
        if self._t0 is not None:
            return
        self.reason = str(reason)
        self._t0 = self.clock.now()
        if self.telemetry.enabled:
            self.telemetry.emit(
                "drain", reason=self.reason, deadline_s=self.deadline_s
            )
        log.info(
            "drain requested (%s): admissions stopped, deadline %.1fs",
            self.reason, self.deadline_s,
        )

    # -- signals -----------------------------------------------------------
    def install(self, signals=(_signal.SIGTERM, _signal.SIGINT)):
        """Register signal handlers that request a drain (main thread
        only — elsewhere signal registration raises and we skip it: the
        controller still works via explicit ``request()``)."""
        for sig in signals:
            try:
                prev = _signal.signal(sig, self._handler)
            except ValueError:  # not the main thread
                break
            self._installed.append((sig, prev))
        return self

    def uninstall(self) -> None:
        while self._installed:
            sig, prev = self._installed.pop()
            try:
                _signal.signal(sig, prev)
            except ValueError:
                break

    def _handler(self, signum, frame) -> None:
        self.request(reason=_signal.Signals(signum).name)
