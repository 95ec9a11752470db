"""Cross-epoch rollout history subsystem.

``store``       — append-only per-problem rollout log (windowed
                  eviction, telemetry, epoch cursor).
``incremental`` — live suffix-tree maintenance from store deltas
                  (online extend + retire, compaction, rebuild fallback).
``service``     — sharded cross-worker history service: shards own
                  contiguous problem ranges and replicate version-gated
                  ``SuffixTree.pack()`` deltas to every worker.
``client``      — worker-side client (async bounded-outbox publish,
                  delta sync, crash/reconnect).
``wire``        — length-prefixed msgpack/JSON socket framing.
``persist``     — save/load of history + drafter + length-policy state,
                  single-store or sharded-manifest (import explicitly:
                  ``from repro_torch.history import persist`` — kept out of
                  the eager exports because it reaches back into
                  ``core.drafter``).
"""

from .incremental import IncrementalIndex, IndexStats, apply_rollout
from .store import RolloutHistoryStore, RolloutRecord

__all__ = [
    "IncrementalIndex",
    "IndexStats",
    "RolloutHistoryStore",
    "RolloutRecord",
    "apply_rollout",
]
