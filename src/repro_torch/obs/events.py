"""Bounded structured event log.

Events are small dicts with a kind, a monotonic sequence number, and a
wall-clock timestamp: admissions, slot recycles, shard state
transitions, watchdog requeues, fault injections, train steps.  The log
is a fixed-capacity deque — old events fall off — and per-kind counts
are mirrored into ``das_events_total{kind=...}`` so the Prometheus view
keeps totals even after the raw events rotate out.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional


class EventLog:
    def __init__(self, registry=None, cap: int = 4096):
        self._events: deque = deque(maxlen=cap)
        self._seq = 0
        self._lock = threading.Lock()
        self._counter_fam = None
        self._counter_cache = {}
        if registry is not None:
            self._counter_fam = registry.counter_family(
                "das_events_total", "Structured events by kind", ("kind",)
            )

    def emit(self, kind: str, **fields) -> None:
        with self._lock:
            seq = self._seq
            self._seq += 1
        ev = {"kind": kind, "seq": seq, "ts": time.time()}  # dascheck: disable=DAS201 -- wall-clock event timestamp, not a duration
        ev.update(fields)
        self._events.append(ev)
        if self._counter_fam is not None:
            ctr = self._counter_cache.get(kind)
            if ctr is None:
                ctr = self._counter_fam.labels(kind)
                self._counter_cache[kind] = ctr
            ctr.inc()

    def recent(self, n: Optional[int] = None,
               kind: Optional[str] = None) -> List[dict]:
        evs = list(self._events)
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        return evs if n is None else evs[-n:]

    def __len__(self) -> int:
        return len(self._events)

    def clear(self) -> None:
        self._events.clear()


class NullEventLog:
    def emit(self, kind: str, **fields) -> None:
        pass

    def recent(self, n: Optional[int] = None,
               kind: Optional[str] = None) -> List[dict]:
        return []

    def __len__(self) -> int:
        return 0

    def clear(self) -> None:
        pass
