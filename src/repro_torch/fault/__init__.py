"""Fault-tolerance layer of the port: the injectable clocks (they drive
the serve loop's deadlines and preemption margins), the rollout
watchdog's ``StallError`` and the graceful-drain controller that
``rl.trainer.Trainer.run`` installs. Supervision, the journal, health
checks and fault injection are not ported yet."""

from .clock import Clock, SystemClock, VirtualClock
from .drain import DrainController
from .watchdog import RolloutWatchdog, StallError

__all__ = [
    "Clock",
    "DrainController",
    "RolloutWatchdog",
    "StallError",
    "SystemClock",
    "VirtualClock",
]
