"""Fleet fault tolerance: supervision, degraded drafting, watchdogs,
and deterministic fault injection.

The layer's contract, threaded through history/rollout/serve:

* a dead **shard** degrades drafting (stale replicas + local fallback
  trees → lower acceptance) but never stalls a round or changes a
  token; the supervisor restarts it and republishes its address.
* a dead/stuck **worker** trips the rollout watchdog; its unfinished
  problems re-queue to survivors and the merged batch stays
  token-identical at T=0 (greedy verification is worker-independent).
* every **in-flight rollout** is durable: a per-worker write-ahead
  token journal (``fault.journal``) group-commits each consumed verify
  round, so a crash, preemption, or drain loses at most the final
  un-synced round and survivors resume token-identically (T=0) via
  prefix re-prefill. ``DrainController`` turns SIGTERM/SIGINT into
  stop-admissions + journal-and-exit within a Clock-driven deadline.
* every failure path is reachable deterministically via
  ``fault.inject.FaultPlan`` (seeded, countable, virtual-clocked).
"""

from .clock import Clock, SystemClock, VirtualClock
from .drain import DrainController
from .health import (
    DOWN,
    HEALTHY,
    RESYNCING,
    SUSPECT,
    BackoffPolicy,
    ShardBackoffError,
    ShardHealth,
)
from .inject import (
    FaultPlan,
    FlakyWorker,
    JournalCrashError,
    SilentServer,
    garble_json_file,
    tear_journal_tail,
    truncate_json_file,
)
from .journal import (
    JournalCorruptError,
    JournalError,
    JournalSession,
    RolloutJournal,
    resume_requests,
)
from .supervisor import AddressBook, ShardSupervisor
from .watchdog import RolloutWatchdog, StallError

__all__ = [
    "AddressBook",
    "BackoffPolicy",
    "Clock",
    "DOWN",
    "DrainController",
    "FaultPlan",
    "FlakyWorker",
    "HEALTHY",
    "JournalCorruptError",
    "JournalCrashError",
    "JournalError",
    "JournalSession",
    "RESYNCING",
    "RolloutJournal",
    "RolloutWatchdog",
    "ShardBackoffError",
    "ShardHealth",
    "ShardSupervisor",
    "SilentServer",
    "StallError",
    "SUSPECT",
    "SystemClock",
    "VirtualClock",
    "garble_json_file",
    "resume_requests",
    "tear_journal_tail",
    "truncate_json_file",
]
