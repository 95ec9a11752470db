"""Per-rollout flight recorder: fleet-unique trace IDs + lifecycle events.

A rollout's life crosses process boundaries — admission on one worker,
a watchdog requeue onto a survivor, a journal resume after a crash, a
history publish into a shard — and the round-phase tracer only sees
*rounds inside one process*. The flight recorder restores the
per-rollout view: every request gets a fleet-unique **trace ID** at
admission, and each lifecycle step stamps an event onto that trace with
``(worker, shard, wall-interval)``:

    queued → prefill/admit → round (accept count per verify round)
           → preempt → requeue → handoff → resume → finish

Hot-path discipline mirrors :class:`repro_torch.obs.trace.Tracer`: recording
is ONE tuple append onto a bounded deque (no dict building, no clock
math beyond ``time.time()``); normalization into event dicts is
deferred to :meth:`FlightRecorder.drain`, which callers run off the
round loop (collect hooks, exports, end of serve). The per-verify-round
accept counts for the whole pool land as a single **batched** raw
record per round (:meth:`record_round`) and explode into per-trace
``round`` events only at drain time, so the round loop pays one append
regardless of pool size — the same ≤2 % bar as the journal's group
commit (asserted in ``benchmarks/bench_obs.py``).

Trace IDs propagate across processes as opaque strings: the journal's
``begin`` records carry them (a resumed session continues the SAME
trace), history publish frames carry them as an optional field (old
peers ignore unknown keys), and the watchdog-requeue path stamps a
``handoff`` event before a survivor resumes the trace.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence

__all__ = [
    "EVENT_KINDS",
    "FlightRecorder",
    "NullFlightRecorder",
    "NULL_FLIGHT",
    "new_trace_id",
    "merge_events",
]

# Lifecycle event taxonomy (documented in the README "Observability"
# section; attrib.py and perfetto.py key off these).
EVENT_KINDS = (
    "queued",    # submitted to the scheduler queue
    "admit",     # fresh admission into a slot (prefill complete)
    "resume",    # re-admission via prefix re-prefill (journal/preempt)
    "round",     # one verify round: accepted/drafted for this trace
    "preempt",   # evicted from its slot (reason attached)
    "requeue",   # re-queued after preemption (same worker)
    "handoff",   # a survivor adopts a dead worker's in-flight trace
    "publish",   # rollout landed in a history shard (shard side)
    "stall",     # watchdog deadline overrun on the owning worker
    "finish",    # terminal: finished/cancelled/expired/preempted
)

# Fleet-unique trace IDs: worker tag + pid + per-process random nonce +
# a process-wide counter. ``itertools.count`` is a single atomic
# bytecode in CPython, so minting is lock-free and thread-safe.
_NONCE = os.urandom(3).hex()
_COUNTER = itertools.count()


def new_trace_id(tag: str = "w?") -> str:
    """Mint a fleet-unique trace ID (``tag-pid-nonce-n``)."""
    return f"{tag}-{os.getpid():x}-{_NONCE}-{next(_COUNTER):x}"


class FlightRecorder:
    """Per-process lifecycle event store for rollout traces.

    ``worker`` / ``shard`` name the owning process; every drained event
    carries them so a fleet-wide merge (:func:`merge_events`) can
    attribute each interval to its track. ``cap`` bounds both the raw
    append buffer and the normalized store (oldest events drop, with a
    ``dropped`` count, never an allocation storm).
    """

    enabled = True

    def __init__(
        self,
        worker: str = "w0",
        shard: Optional[str] = None,
        cap: int = 65536,
        registry=None,
    ) -> None:
        self.worker = worker
        self.shard = shard
        self._cap = int(cap)
        self._raw: deque = deque(maxlen=self._cap)
        self._seq = itertools.count()
        self._events: List[dict] = []
        self._drain_lock = threading.Lock()
        self.dropped = 0
        # perf_counter ↔ wall anchor: spans stamp perf_counter, flight
        # events stamp wall time; Perfetto export aligns them with this
        # per-process offset.
        self.perf_offset = time.time() - time.perf_counter()  # dascheck: disable=DAS201 -- the wall/perf anchor IS the point: Perfetto export shifts span perf stamps onto the wall axis
        self._kind_fam = None
        if registry is not None:
            self._kind_fam = registry.counter_family(
                "das_flight_events_total",
                "Flight-recorder lifecycle events drained, by kind",
                ("kind",),
            )
            self._kind_ctrs: Dict[str, object] = {}

    # -- trace minting ------------------------------------------------
    def new_trace(self) -> str:
        return new_trace_id(self.worker)

    # -- hot-path capture ---------------------------------------------
    # das: hot-path callers (serve/generate round loops) pay exactly one
    # deque append per call; everything else is deferred to drain().
    def record(self, trace, kind, dur: float = 0.0, **fields) -> None:  # dascheck: disable=DAS006 -- the recorder is the instrument, not a measured phase; one deque append, bounded by bench_obs flight mode at <0.1% of round host time
        self._raw.append(
            (next(self._seq), time.time(), trace, kind, dur,  # dascheck: disable=DAS201 -- lifecycle events need wall time to merge across processes; a virtual clock would break fleet-wide ordering
             fields or None)
        )

    def record_round(
        self,
        round_no: int,
        traces: Sequence,
        accepted: Sequence,
        drafted: Sequence,
        dur: float = 0.0,
    ) -> None:
        """One append covering the whole pool's verify round; explodes
        into per-trace ``round`` events at drain time."""
        self._raw.append(
            (next(self._seq), time.time(), None, "__round__", dur,  # dascheck: disable=DAS201 -- same wall-clock contract as record()
             {"round": int(round_no), "traces": traces,
              "accepted": accepted, "drafted": drafted})
        )

    # -- drain / query (off the round loop) ---------------------------
    def _normalize(self, raw) -> List[dict]:
        seq, ts, trace, kind, dur, fields = raw
        base = {"worker": self.worker, "shard": self.shard, "seq": seq}
        if kind == "__round__":
            out = []
            rno = fields["round"]
            for tr, acc, bud in zip(
                fields["traces"], fields["accepted"], fields["drafted"]
            ):
                ev = dict(base)
                ev.update(
                    trace=tr, kind="round", ts=ts, dur=float(dur),
                    round=rno, accepted=int(acc), drafted=int(bud),
                )
                out.append(ev)
            return out
        ev = dict(base)
        ev.update(trace=trace, kind=kind, ts=ts, dur=float(dur))
        if fields:
            ev.update(fields)
        return [ev]

    def drain(self) -> None:
        """Fold raw appends into normalized event dicts (idempotent,
        thread-safe; safe to call from a registry collect hook)."""
        with self._drain_lock:
            while True:
                try:
                    raw = self._raw.popleft()
                except IndexError:
                    break
                evs = self._normalize(raw)
                self._events.extend(evs)
                if self._kind_fam is not None:
                    for ev in evs:
                        k = ev["kind"]
                        ctr = self._kind_ctrs.get(k)
                        if ctr is None:
                            ctr = self._kind_ctrs[k] = \
                                self._kind_fam.labels(k)
                        ctr.inc()
            if len(self._events) > self._cap:
                n = len(self._events) - self._cap
                del self._events[:n]
                self.dropped += n

    def events(
        self, trace: Optional[str] = None, kind: Optional[str] = None
    ) -> List[dict]:
        self.drain()
        evs = self._events
        if trace is not None:
            evs = [e for e in evs if e["trace"] == trace]
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        return list(evs)

    def traces(self) -> List[str]:
        """Distinct trace IDs seen, in first-event order."""
        self.drain()
        seen: Dict[str, None] = {}
        for e in self._events:
            t = e["trace"]
            if t is not None and t not in seen:
                seen[t] = None
        return list(seen)

    def clear(self) -> None:
        with self._drain_lock:
            self._raw.clear()
            self._events.clear()
            self.dropped = 0


class NullFlightRecorder:
    """No-op recorder: capture calls vanish, but trace minting stays
    real — journal/wire trace continuity must hold even when nobody is
    recording locally (a later process may be)."""

    enabled = False
    worker = "w?"
    shard = None
    dropped = 0
    perf_offset = 0.0

    def new_trace(self) -> str:
        return new_trace_id(self.worker)

    def record(self, trace, kind, dur: float = 0.0, **fields) -> None:  # dascheck: disable=DAS006 -- the recorder is the instrument, not a measured phase; one deque append, bounded by bench_obs flight mode at <0.1% of round host time
        pass

    def record_round(self, round_no, traces, accepted, drafted,
                     dur: float = 0.0) -> None:
        pass

    def drain(self) -> None:
        pass

    def events(self, trace=None, kind=None) -> List[dict]:
        return []

    def traces(self) -> List[str]:
        return []

    def clear(self) -> None:
        pass


NULL_FLIGHT = NullFlightRecorder()


def merge_events(recorders: Iterable) -> List[dict]:
    """Fleet-wide event view: drain every recorder and merge by wall
    timestamp (ties broken by (worker, seq) for determinism)."""
    out: List[dict] = []
    for fr in recorders:
        out.extend(fr.events())
    out.sort(key=lambda e: (e["ts"], str(e.get("worker")), e["seq"]))
    return out
