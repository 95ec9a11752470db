"""Cross-epoch rollout history of the port: the local per-problem store
and the live suffix-tree index maintained from it."""

from .incremental import IncrementalIndex, IndexStats, apply_rollout
from .store import RolloutHistoryStore, RolloutRecord

__all__ = [
    "IncrementalIndex",
    "IndexStats",
    "RolloutHistoryStore",
    "RolloutRecord",
    "apply_rollout",
]
