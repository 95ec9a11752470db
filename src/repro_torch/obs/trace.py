"""Span tracer for the rollout round pipeline.

A span is a named host-side wall-time interval.  Spans nest via a
per-thread stack, so the fused round shows up as

    round
    ├─ budget_solve
    ├─ fused_dispatch
    └─ accept_emit

and the unfused round as ``round → budget_solve / draft_dispatch /
verify_forward / accept_emit``.  Each finished span is observed into
the ``das_phase_seconds{phase=...}`` histogram family (per-phase
latency distributions for Prometheus) and kept in a bounded ring of
recent spans (for tests and ``/metrics.json``).

Spans carry optional integer attributes — the engine attaches H2D/D2H
transfer counts to dispatch/consume spans via ``sp.set(h2d=..., ...)``.

The hot path is deliberately tiny: span exit appends one raw tuple to
a bounded pending buffer and nothing else.  Histogram observes and
:class:`SpanRecord` construction happen in :meth:`Tracer.drain`, which
runs at *collection* time — every Prometheus render, snapshot, or
``recent()`` read drains first (the tracer registers itself as a
registry collect hook).  If nothing ever collects, the pending buffer
caps at ``4 * max_spans`` raw events and drops its oldest — bounded
memory, monitoring-grade loss.  Span objects are recycled through a
per-thread freelist, so steady state allocates only the raw tuple.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from .registry import MetricsRegistry, exp_buckets

PHASE_BUCKETS = exp_buckets(1e-6, 2.0, 18)  # 1us .. ~131ms


class SpanRecord:
    __slots__ = ("name", "parent", "depth", "t0", "dur_s", "attrs", "seq")

    def __init__(self, name: str, parent: Optional[str], depth: int,
                 t0: float, dur_s: float, attrs: Optional[Dict[str, float]],
                 seq: int):
        self.name = name
        self.parent = parent
        self.depth = depth
        self.t0 = t0
        self.dur_s = dur_s
        self.attrs = attrs
        self.seq = seq

    def to_dict(self) -> dict:
        d = {
            "name": self.name,
            "parent": self.parent,
            "depth": self.depth,
            "t0": self.t0,
            "dur_s": self.dur_s,
            "seq": self.seq,
        }
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        return d


class _Span:
    """Context manager handed out by :meth:`Tracer.span`.

    Holds direct references to its thread's span stack and freelist so
    enter/exit never touch ``threading.local`` (resolved once in
    ``Tracer.span``).
    """

    __slots__ = ("_pending", "_stk", "_free", "name", "attrs", "_t0",
                 "_parent", "_depth")

    def __init__(self, pending: deque, stack: list, free: list, name: str):
        self._pending = pending
        self._stk = stack
        self._free = free
        self.name = name
        self.attrs: Optional[Dict[str, float]] = None
        self._t0 = 0.0
        self._parent: Optional[str] = None
        self._depth = 0

    def set(self, **attrs) -> "_Span":
        if self.attrs is None:
            self.attrs = {}
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "_Span":
        stack = self._stk
        self._parent = stack[-1] if stack else None
        self._depth = len(stack)
        stack.append(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        t0 = self._t0
        dur = time.perf_counter() - t0
        stack = self._stk
        if stack and stack[-1] == self.name:
            stack.pop()
        # Raw event only; histograms/records are built in drain().
        self._pending.append(
            (self.name, self._parent, self._depth, t0, dur, self.attrs)
        )
        free = self._free
        if len(free) < 16:
            free.append(self)


class _NullSpan:
    __slots__ = ()

    def set(self, **attrs) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpan()


class Tracer:
    def __init__(self, registry: MetricsRegistry, max_spans: int = 2048):
        self._registry = registry
        self._local = threading.local()
        self._recent: deque = deque(maxlen=max_spans)
        self._pending: deque = deque(maxlen=4 * max_spans)
        # itertools.count is GIL-atomic: no lock on the seq counter.
        self._seq = itertools.count()
        self._drain_lock = threading.Lock()
        self._phase_hist = registry.histogram_family(
            "das_phase_seconds",
            "Host wall time per round-pipeline phase",
            ("phase",),
            buckets=PHASE_BUCKETS,
            ring=512,
        )
        self._phase_cache: Dict[str, object] = {}
        add_hook = getattr(registry, "add_collect_hook", None)
        if add_hook is not None:
            add_hook(self.drain)

    def _state(self) -> tuple:
        local = self._local
        try:
            return local.state
        except AttributeError:
            st = local.state = ([], [])
            return st

    def span(self, name: str) -> _Span:
        # Per-thread freelist: a span popped here is in use until its
        # __exit__, so nested spans always draw distinct objects.
        stack, free = self._state()
        if free:
            sp = free.pop()
            sp.name = name
            sp.attrs = None
            return sp
        return _Span(self._pending, stack, free, name)

    def drain(self) -> None:
        """Fold buffered raw span events into histograms and records.

        Runs as a registry collect hook (every export) and before any
        ``recent()`` read; safe to call from several threads.
        """
        with self._drain_lock:
            pending = self._pending
            cache = self._phase_cache
            recent = self._recent
            seq = self._seq
            while True:
                try:
                    name, parent, depth, t0, dur, attrs = pending.popleft()
                except IndexError:
                    break
                hist = cache.get(name)
                if hist is None:
                    hist = self._phase_hist.labels(name)
                    cache[name] = hist
                hist.observe(dur)
                recent.append(
                    SpanRecord(name, parent, depth, t0, dur, attrs,
                               next(seq))
                )

    def recent(self, n: Optional[int] = None) -> List[SpanRecord]:
        """Most recent finished spans, oldest first."""
        self.drain()
        with self._drain_lock:
            spans = list(self._recent)
        return spans if n is None else spans[-n:]

    def clear(self) -> None:
        self.drain()
        with self._drain_lock:
            self._recent.clear()


class NullTracer:
    def span(self, name: str) -> _NullSpan:
        return _NULL_SPAN

    def drain(self) -> None:
        pass

    def recent(self, n: Optional[int] = None) -> List[SpanRecord]:
        return []

    def clear(self) -> None:
        pass
