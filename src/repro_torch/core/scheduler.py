"""Continuous-batching slot scheduler (the Fig. 1 remedy).

The paper's core observation is that long-tailed rollout lengths make
the *effective* batch collapse: short rows finish early, yet a lock-step
batched engine keeps them as dead padded slots while the stragglers set
the makespan. This module treats rollout as a continuously scheduled
serving problem instead:

* a fixed pool of ``n_slots`` device slots (one KV/state-cache row each),
* an admission queue ordered **longest-predicted-first** using
  ``LengthPolicy.expected_length`` — the classic LPT makespan heuristic:
  stragglers start as early as possible, short rows backfill around them,
* **slot recycling**: the moment a row finishes (EOS / token limit) its
  slot is released and the next pending request is prefilled into it, so
  the pool stays full through the long tail.

Requests move through an explicit lifecycle::

    QUEUED ──admit──► RUNNING ──release──► FINISHED
      │  ▲              │ ├─────preempt──► PREEMPTED ──submit──► QUEUED
      │  └──────────────┘ ├─────cancel───► CANCELLED
      ├──────cancel──────►┘─────expire───► EXPIRED
      └──────expire──────► EXPIRED

FINISHED / CANCELLED / EXPIRED are terminal; PREEMPTED is
terminal-until-resubmitted (the engine journals the victim's progress
and re-queues it with remaining-length priority, enabling pool
oversubscription). Non-FINISHED terminals keep their partial
``Request.output`` — at T=0 that prefix is exactly what an
uninterrupted run would have produced, so it is salvageable, not
garbage. Illegal transitions raise ``SchedulerStateError``.

Deadlines read the injectable ``repro_torch.fault.clock.Clock``, so the
drain/deadline chaos tests run on a ``VirtualClock`` with zero sleeps.

The scheduler is pure host-side bookkeeping (no torch): the engine owns
the device pool and asks the scheduler *which* request goes into *which*
slot.  See ``SpecEngine.serve`` for the device side.
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Any, List, Optional

from repro_torch.obs.flight import new_trace_id

QUEUED = "queued"
RUNNING = "running"
FINISHED = "finished"
PREEMPTED = "preempted"
CANCELLED = "cancelled"
EXPIRED = "expired"

#: States a request can never leave (PREEMPTED can, via re-submit).
TERMINAL = frozenset({FINISHED, CANCELLED, EXPIRED})

_LEGAL = frozenset({
    (QUEUED, RUNNING),      # admission
    (RUNNING, FINISHED),    # release
    (RUNNING, PREEMPTED),   # preempt (slot evicted, progress journaled)
    (RUNNING, CANCELLED),
    (RUNNING, EXPIRED),     # per-request deadline passed while resident
    (QUEUED, CANCELLED),
    (QUEUED, EXPIRED),      # deadline passed while still waiting
    (PREEMPTED, QUEUED),    # re-submit with remaining-length priority
})


class SchedulerStateError(ValueError):
    """Illegal request-lifecycle transition (or slot bookkeeping that
    contradicts the lifecycle). Subclasses ``ValueError``: these are
    caller contract violations, not runtime faults."""


@dataclass
class Request:
    """One generation request flowing through the slot pool.

    The first block of fields is caller-provided; the rest is runtime
    state owned by the scheduler/engine while the request is resident.
    """

    rid: int
    problem_id: Any = None
    prompt: List[int] = field(default_factory=list)
    max_new_tokens: int = 256
    predicted_len: Optional[float] = None  # admission-priority override
    deadline_s: Optional[float] = None  # absolute, on the pool's Clock
    journal_key: Optional[str] = None  # WAL session key (default: rid)
    # Salvaged output prefix (journal recovery / preemption): the engine
    # re-admits via prefix re-prefill of prompt + resume_tokens[:-1],
    # head = resume_tokens[-1] — token-identical at T=0.
    resume_tokens: Optional[List[int]] = None
    # Fleet-unique flight-recorder trace ID (repro_torch.obs.flight): minted
    # at admission and carried across journal resumes / watchdog
    # handoffs, so one rollout is one trace fleet-wide.
    trace: Optional[str] = None

    # -- runtime state -----------------------------------------------------
    state: str = QUEUED
    slot: int = -1  # device slot while RUNNING
    output: List[int] = field(default_factory=list)  # EOS-stripped on finish
    emitted: int = 0
    rounds: int = 0  # verify rounds while resident
    admit_round: int = -1  # pool round at (most recent) admission
    finish_round: int = -1
    session: Any = None  # drafter DraftSession while RUNNING
    head: int = -1  # last emitted-but-unverified token
    cancel_requested: bool = False  # engine converts to CANCELLED
    n_preempted: int = 0  # times this request was evicted


@dataclass
class PreemptionPolicy:
    """When the engine may evict a resident rollout (progress is
    journaled, the victim re-queues with remaining-length priority).

    * ``max_resident_rounds`` — with requests waiting, a resident that
      has held its slot for this many verify rounds is evicted (bounded
      slot monopoly → pool oversubscription stays live-ish for every
      request, and short deadline-bound arrivals are not starved by a
      10k-token straggler).
    * ``deadline_margin_s`` — a queued request whose deadline is within
      this margin evicts the resident with the largest predicted
      remaining length (LPT inverted: the straggler can absorb the
      delay, the deadline-near request cannot).
    """

    max_resident_rounds: Optional[int] = None
    deadline_margin_s: float = 0.0


class SlotScheduler:
    """Fixed pool of device slots + longest-predicted-first admission.

    ``submit`` enqueues requests with priority = predicted final length
    (``Request.predicted_len`` if given, else the length policy's
    ``expected_length`` for the request's problem, else its token limit).
    ``next_admissions`` pairs free slots with the longest queued requests;
    ``release`` recycles a finished request's slot back into the pool.
    Ties admit in submission order (deterministic).
    """

    def __init__(self, n_slots: int, length_policy=None, *,
                 clock=None) -> None:
        if n_slots <= 0:
            raise ValueError(f"n_slots must be positive, got {n_slots}")
        self.n_slots = n_slots
        self.length_policy = length_policy
        if clock is None:
            from repro_torch.fault.clock import SystemClock

            clock = SystemClock()
        self.clock = clock
        self._free: List[int] = list(range(n_slots))
        heapq.heapify(self._free)  # lowest slot first: deterministic
        self._queue: List[Any] = []  # heap of (-priority, seq, Request)
        self._enqueued: set = set()  # id(req) of live queue entries
        self._seq = itertools.count()
        self.slots: List[Optional[Request]] = [None] * n_slots
        self.n_submitted = 0
        self.n_finished = 0
        self.n_preempted = 0
        self.n_cancelled = 0
        self.n_expired = 0

    # -- lifecycle ---------------------------------------------------------
    def _transition(self, req: Request, new: str) -> None:
        if (req.state, new) not in _LEGAL:
            raise SchedulerStateError(
                f"request {req.rid}: illegal transition "
                f"{req.state!r} -> {new!r}"
            )
        req.state = new

    def _drop_queued(self, req: Request) -> None:
        """Lazy queue removal: the heap entry stays; ``next_admissions``
        skips entries whose request is no longer live-queued."""
        self._enqueued.discard(id(req))

    def _evict_slot(self, req: Request) -> int:
        slot = req.slot
        if slot < 0 or self.slots[slot] is not req:
            raise SchedulerStateError(
                f"request {req.rid} does not own a slot"
            )
        self.slots[slot] = None
        heapq.heappush(self._free, slot)
        req.slot = -1
        return slot

    # -- queue -----------------------------------------------------------
    def priority(self, req: Request) -> float:
        """Predicted final length — larger admits earlier (LPT)."""
        if req.predicted_len is not None:
            return float(req.predicted_len)
        if self.length_policy is not None:
            return float(self.length_policy.expected_length(req.problem_id))
        return float(req.max_new_tokens)

    def remaining_len(self, req: Request) -> float:
        """Predicted *remaining* length — the re-queue priority after a
        preemption (what is left to generate, not what was predicted at
        first submit)."""
        done = max(len(req.output), req.emitted)
        cap = float(max(req.max_new_tokens - done, 1))
        return min(max(self.priority(req) - done, 1.0), cap)

    def submit(self, req: Request) -> None:
        if id(req) in self._enqueued:
            raise SchedulerStateError(
                f"request {req.rid} is already queued"
            )
        if req.state == PREEMPTED:
            self._transition(req, QUEUED)
        elif req.state != QUEUED:
            raise SchedulerStateError(
                f"request {req.rid}: cannot submit from state "
                f"{req.state!r}"
            )
        if req.trace is None:
            # scheduler-level guarantee: every request entering the pool
            # carries a fleet-unique trace (re-submits keep theirs)
            req.trace = new_trace_id()
        heapq.heappush(self._queue, (-self.priority(req), next(self._seq), req))
        self._enqueued.add(id(req))
        self.n_submitted += 1

    # -- admission / recycling -------------------------------------------
    def next_admissions(self) -> List[Request]:
        """Pair each free slot with the longest-predicted queued request.

        Returns the admitted requests (their ``slot`` fields set); empty
        when the pool is full or the queue is drained.
        """
        out: List[Request] = []
        while self._free and self._queue:
            _, _, req = self._queue[0]
            if id(req) not in self._enqueued:  # cancelled/expired entry
                heapq.heappop(self._queue)
                continue
            heapq.heappop(self._queue)
            self._enqueued.discard(id(req))
            slot = heapq.heappop(self._free)
            req.slot = slot
            self._transition(req, RUNNING)
            self.slots[slot] = req
            out.append(req)
        return out

    def release(self, req: Request) -> int:
        """Recycle a finished request's slot back into the free pool."""
        slot = self._evict_slot(req)
        self._transition(req, FINISHED)
        self.n_finished += 1
        return slot

    def preempt(self, req: Request) -> int:
        """Evict a RUNNING request (slot freed, partial output kept).
        The caller journals its progress and usually re-``submit``s it
        with remaining-length priority."""
        slot = self._evict_slot(req)
        self._transition(req, PREEMPTED)
        req.n_preempted += 1
        self.n_preempted += 1
        return slot

    def cancel(self, req: Request) -> None:
        """QUEUED or RUNNING → CANCELLED (partial output preserved)."""
        if req.state == RUNNING:
            self._evict_slot(req)
        elif req.state == QUEUED:
            self._drop_queued(req)
        self._transition(req, CANCELLED)
        self.n_cancelled += 1

    def expire(self, req: Request) -> None:
        """QUEUED or RUNNING → EXPIRED (deadline passed; partial output
        preserved)."""
        if req.state == RUNNING:
            self._evict_slot(req)
        elif req.state == QUEUED:
            self._drop_queued(req)
        self._transition(req, EXPIRED)
        self.n_expired += 1

    # -- deadlines / preemption ------------------------------------------
    def due_requests(self, now: Optional[float] = None) -> List[Request]:
        """Live requests (queued or running) whose deadline has passed
        on the pool clock. The caller tears down device state for the
        running ones and calls ``expire``."""
        now = self.clock.now() if now is None else now
        out: List[Request] = []
        for _, _, req in self._queue:
            if (
                id(req) in self._enqueued
                and req.deadline_s is not None
                and now >= req.deadline_s
            ):
                out.append(req)
        for req in self.slots:
            if (
                req is not None
                and req.deadline_s is not None
                and now >= req.deadline_s
            ):
                out.append(req)
        return out

    def queued_requests(self) -> List[Request]:
        """Live queued requests (heap order, not priority-sorted)."""
        return [
            req for _, _, req in self._queue if id(req) in self._enqueued
        ]

    def preemption_victims(
        self,
        policy: Optional[PreemptionPolicy],
        round_no: int,
        now: Optional[float] = None,
    ) -> List[Request]:
        """Residents the policy says to evict this round (deterministic
        order: largest predicted remaining length first, slot index as
        the tie-break). Never proposes more victims than there are
        waiting requests — an eviction only pays off if someone
        backfills the slot."""
        if policy is None:
            return []
        waiting = self.queued_requests()
        if not waiting:
            return []
        victims: List[Request] = []
        seen: set = set()

        def add(req: Request) -> None:
            if id(req) not in seen:
                seen.add(id(req))
                victims.append(req)

        if policy.max_resident_rounds is not None:
            for req in self.slots:
                if (
                    req is not None
                    and round_no - req.admit_round
                    >= policy.max_resident_rounds
                ):
                    add(req)
        if policy.deadline_margin_s > 0 and not self._free:
            now = self.clock.now() if now is None else now
            n_near = sum(
                1 for q in waiting
                if q.deadline_s is not None
                and q.deadline_s - now <= policy.deadline_margin_s
            )
            if n_near:
                residents = sorted(
                    (r for r in self.slots if r is not None),
                    key=lambda r: (-self.remaining_len(r), r.slot),
                )
                for req in residents[:n_near]:
                    add(req)
        victims.sort(key=lambda r: (-self.remaining_len(r), r.slot))
        return victims[: len(waiting)]

    # -- introspection ---------------------------------------------------
    def running(self) -> List[Request]:
        return [r for r in self.slots if r is not None]

    @property
    def n_running(self) -> int:
        return sum(1 for r in self.slots if r is not None)

    @property
    def n_queued(self) -> int:
        return len(self._enqueued)

    def has_work(self) -> bool:
        return bool(self._enqueued) or self.n_running > 0
