"""Fault-tolerance layer of the port. Only the injectable clocks are
ported so far (they drive the serve loop's deadlines and preemption
margins); supervision, the journal, the watchdog and drain are not."""

from .clock import Clock, SystemClock, VirtualClock

__all__ = ["Clock", "SystemClock", "VirtualClock"]
