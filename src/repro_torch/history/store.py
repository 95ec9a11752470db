"""Cross-epoch rollout history store (paper §4.1: the drafter's corpus).

One ``RolloutHistoryStore`` is the single source of truth for everything
the distribution-aware pipeline learns from past rollouts:

* an **append-only per-problem rollout log** — every completed rollout
  gets a monotonically increasing ``doc_id`` (the stable cursor; ids are
  never reused, so downstream indexes can key on them across window
  slides, process restarts and checkpoint resumes);
* **windowed eviction** — only the newest ``window_size`` rollouts per
  problem keep their token payloads (they are what the suffix trees
  index); evicted records surface to the caller exactly once so an
  incremental index can retire the matching documents;
* **length + acceptance telemetry per prompt** — final response lengths
  (retained past eviction: they feed ``LengthPolicy`` quantiles and the
  scheduler's longest-predicted-first admission) and drafted/accepted
  token counters per problem;
* a **stable iteration/epoch cursor** shared by trainer and server.

The store is pure host-side bookkeeping (no jax) and round-trips
through ``state_dict``/``from_state`` as plain JSON-able data — see
``history/persist.py`` for the on-disk format.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple


@dataclass
class RolloutRecord:
    """One logged rollout. ``tokens`` is dropped when the record slides
    out of the window; the metadata stays queryable via telemetry."""

    doc_id: int
    epoch: int
    n_tokens: int
    response_len: int  # -1 when the caller did not report it
    tokens: Optional[List[int]]


class _ProblemLog:
    __slots__ = (
        "next_doc_id", "window", "lengths", "drafted", "accepted",
        "n_appended", "n_evicted",
    )

    def __init__(self) -> None:
        self.next_doc_id = 0
        self.window: Deque[RolloutRecord] = collections.deque()
        self.lengths: List[int] = []  # response lengths, append-only
        self.drafted = 0
        self.accepted = 0
        self.n_appended = 0
        self.n_evicted = 0


# Per-problem response-length telemetry keeps only this newest tail:
# LengthPolicy quantiles/means don't need unbounded history, and the
# lists are serialized into every history.json / checkpoint sidecar.
# Within this horizon a warm-started LengthPolicy replays exactly what
# the live one observed (resume parity); past it the oldest lengths age
# out of both size and influence.
LENGTHS_CAP = 4096


class RolloutHistoryStore:
    """Append-only rollout log with windowed eviction and telemetry."""

    def __init__(self, window_size: int = 16) -> None:
        if window_size < 1:
            raise ValueError(f"window_size must be >= 1, got {window_size}")
        self.window_size = int(window_size)
        self._logs: Dict[Any, _ProblemLog] = {}
        self.epoch = 0
        self.iteration = 0  # begin_iteration calls (monotone cursor)

    # -- logging -----------------------------------------------------------
    def append(
        self,
        key,
        tokens: Sequence[int],
        epoch: int,
        response_len: Optional[int] = None,
    ) -> Tuple[RolloutRecord, List[RolloutRecord]]:
        """Log one completed rollout.

        Returns ``(record, evicted)`` where ``evicted`` holds the records
        that just slid out of the window (their ``tokens`` already
        dropped; use ``doc_id`` to retire them from any live index).
        """
        log = self._logs.setdefault(key, _ProblemLog())
        toks = [int(t) for t in tokens]
        rec = RolloutRecord(
            doc_id=log.next_doc_id,
            epoch=int(epoch),
            n_tokens=len(toks),
            response_len=-1 if response_len is None else int(response_len),
            tokens=toks,
        )
        log.next_doc_id += 1
        log.n_appended += 1
        log.window.append(rec)
        if response_len is not None:
            log.lengths.append(int(response_len))
            if len(log.lengths) > LENGTHS_CAP:
                del log.lengths[: -LENGTHS_CAP]
        return rec, self._evict(log, self.window_size)

    @staticmethod
    def _evict(log: _ProblemLog, limit: int) -> List[RolloutRecord]:
        out: List[RolloutRecord] = []
        while len(log.window) > limit:
            ev = log.window.popleft()
            ev.tokens = None  # payload evicted; metadata stays
            log.n_evicted += 1
            out.append(ev)
        return out

    def set_window_size(self, w: int) -> Dict[Any, List[RolloutRecord]]:
        """Resize the live window (drafter window adaptation, §4.1.2).

        Shrinking evicts immediately; the evicted records are returned
        per problem so indexes can retire them. Growing never resurrects
        evicted payloads (they are gone) — the window refills naturally.
        """
        if w < 1:
            raise ValueError(f"window_size must be >= 1, got {w}")
        self.window_size = int(w)
        evicted: Dict[Any, List[RolloutRecord]] = {}
        for key, log in self._logs.items():
            evs = self._evict(log, self.window_size)
            if evs:
                evicted[key] = evs
        return evicted

    def begin_iteration(self, epoch: int) -> None:
        self.epoch = int(epoch)
        self.iteration += 1

    # -- telemetry ---------------------------------------------------------
    def record_draft(self, key, drafted: int, accepted: int) -> None:
        log = self._logs.setdefault(key, _ProblemLog())
        log.drafted += int(drafted)
        log.accepted += int(accepted)

    def acceptance(self, key=None) -> float:
        """Accepted/drafted ratio for one problem (or all)."""
        if key is not None:
            log = self._logs.get(key)
            return 0.0 if log is None else log.accepted / max(log.drafted, 1)
        d = sum(l.drafted for l in self._logs.values())
        a = sum(l.accepted for l in self._logs.values())
        return a / max(d, 1)

    def lengths(self, key) -> List[int]:
        """Recorded response lengths (newest ``LENGTHS_CAP`` tail).
        Length *prediction* lives in ``LengthPolicy`` — warm it from
        here via ``warm_length_policy`` rather than re-deriving means."""
        log = self._logs.get(key)
        return [] if log is None else list(log.lengths)

    def telemetry(self, key) -> Dict[str, int]:
        log = self._logs.get(key)
        if log is None:
            return {"appended": 0, "evicted": 0, "drafted": 0, "accepted": 0}
        return {
            "appended": log.n_appended,
            "evicted": log.n_evicted,
            "drafted": log.drafted,
            "accepted": log.accepted,
        }

    # -- views -------------------------------------------------------------
    def window(self, key) -> List[RolloutRecord]:
        """Live (token-bearing) records, oldest -> newest."""
        log = self._logs.get(key)
        return [] if log is None else list(log.window)

    def keys(self) -> List[Any]:
        return list(self._logs.keys())

    @property
    def n_problems(self) -> int:
        return len(self._logs)

    @property
    def n_rollouts(self) -> int:
        return sum(l.n_appended for l in self._logs.values())

    def warm_length_policy(self, length_policy) -> int:
        """Replay recorded response lengths into a ``LengthPolicy``;
        returns the number of observations replayed."""
        n = 0
        for key, log in self._logs.items():
            for L in log.lengths:
                length_policy.observe(key, float(L))
                n += 1
        return n

    # -- (de)serialization -------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """JSON-able snapshot (problem keys must be str/int)."""
        problems = []
        for key, log in self._logs.items():
            problems.append([
                key,
                {
                    "next_doc_id": log.next_doc_id,
                    "lengths": list(log.lengths),
                    "drafted": log.drafted,
                    "accepted": log.accepted,
                    "n_appended": log.n_appended,
                    "n_evicted": log.n_evicted,
                    "window": [
                        [r.doc_id, r.epoch, r.response_len, list(r.tokens or [])]
                        for r in log.window
                    ],
                },
            ])
        return {
            "window_size": self.window_size,
            "epoch": self.epoch,
            "iteration": self.iteration,
            "problems": problems,
        }

    @classmethod
    def from_state(cls, state: Dict[str, Any]) -> "RolloutHistoryStore":
        store = cls(window_size=int(state["window_size"]))
        store.epoch = int(state["epoch"])
        store.iteration = int(state["iteration"])
        for key, d in state["problems"]:
            log = _ProblemLog()
            log.next_doc_id = int(d["next_doc_id"])
            log.lengths = [int(x) for x in d["lengths"]][-LENGTHS_CAP:]
            log.drafted = int(d["drafted"])
            log.accepted = int(d["accepted"])
            log.n_appended = int(d["n_appended"])
            log.n_evicted = int(d["n_evicted"])
            for doc_id, epoch, rlen, toks in d["window"]:
                log.window.append(RolloutRecord(
                    doc_id=int(doc_id), epoch=int(epoch),
                    n_tokens=len(toks), response_len=int(rlen),
                    tokens=[int(t) for t in toks],
                ))
            store._logs[key] = log
        return store
