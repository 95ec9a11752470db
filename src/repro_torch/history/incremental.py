"""Incremental suffix-tree maintenance over the rollout history store.

The seed engine rebuilt every per-problem suffix tree from its sliding
window at each ``begin_iteration`` — O(window tokens) of Ukkonen work
per problem per iteration, even when the window moved by one rollout.
``IncrementalIndex`` keeps the trees *live* instead:

* ``add``    — extend the tree online with one new rollout (amortized
  O(doc_len), Ukkonen);
* ``evict``  — retire one document online (``SuffixTree.remove_document``,
  O(doc_len) dictionary surgery, no rebuild);
* ``maybe_compact`` — the corpus text is append-only, so retired
  documents leave dead text behind; once dead text dominates
  (``compact_ratio``) the tree is rebuilt from the live window and the
  corpus reset. Amortized over the refreshes in between, per-refresh
  cost stays sub-linear in the window size.

``rebuild`` is the verified fallback path (identical to the seed's
``SuffixDrafter._rebuild``): property tests assert the incremental tree
is query-equivalent — same longest suffix match, same continuation walk
— to a fresh rebuild after any interleaving of adds and evictions.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional

from repro_torch.core.suffix_tree import SuffixTree

from .store import RolloutRecord


@dataclass
class IndexStats:
    docs_added: int = 0
    docs_evicted: int = 0
    tokens_added: int = 0
    rebuilds: int = 0
    compactions: int = 0


def apply_rollout(
    store,
    index: "IncrementalIndex",
    key,
    tokens: List[int],
    epoch: int,
    response_len: Optional[int] = None,
    rebuild_epoch: Optional[int] = None,
):
    """Apply ONE completed rollout to a (store, index) pair.

    This is the single shared maintenance routine behind both
    ``SuffixDrafter.observe_rollout`` and the history service's shard
    ``publish`` handler: append to the store, extend the live tree
    online, retire whatever slid out of the window, compact when dead
    text dominates. Sharing it is what guarantees a shard's tree is
    *bit-identical* (same pack) to a local drafter fed the same
    per-key rollout sequence — the pooled-vs-oracle contract the
    multi-worker tests assert. Returns the appended ``RolloutRecord``.
    """
    toks = [int(t) for t in tokens]
    ep = int(epoch)
    rec, evicted = store.append(key, toks, ep, response_len=response_len)
    if index.tree(key) is None and len(store.window(key)) > 1:
        # Warm store (e.g. restored from a snapshot), cold tree: build
        # from the full window so earlier history is not dropped.
        index.rebuild(
            key, store.window(key),
            epoch=store.epoch if rebuild_epoch is None else int(rebuild_epoch),
        )
        return rec
    index.add(key, rec.doc_id, toks, ep)
    for ev in evicted:
        index.evict(key, ev.doc_id)
    if index.needs_compaction(key):  # O(1) gate on the hot path
        index.maybe_compact(key, store.window(key))
    return rec


class IncrementalIndex:
    """Per-key live suffix trees fed by store deltas."""

    def __init__(
        self,
        epoch_decay: float = 1.0,
        compact_ratio: float = 4.0,
        compact_min_tokens: int = 1 << 14,
    ) -> None:
        self.epoch_decay = float(epoch_decay)
        # Compact when corpus > ratio * live tokens (and past the floor):
        # bounds memory at ~ratio x window while keeping compactions rare
        # enough that their O(window) cost amortizes sub-linearly.
        self.compact_ratio = float(compact_ratio)
        self.compact_min_tokens = int(compact_min_tokens)
        self._trees: Dict[Any, SuffixTree] = {}
        # store doc_id -> tree-internal document index, per key
        self._docmap: Dict[Any, Dict[int, int]] = {}
        self.stats = IndexStats()

    # -- views -------------------------------------------------------------
    @property
    def trees(self) -> Dict[Any, SuffixTree]:
        return self._trees

    def tree(self, key) -> Optional[SuffixTree]:
        return self._trees.get(key)

    def __len__(self) -> int:
        return len(self._trees)

    # -- incremental maintenance ------------------------------------------
    def add(self, key, doc_id: int, tokens: List[int], epoch: int) -> None:
        tree = self._trees.get(key)
        if tree is None:
            tree = self._trees[key] = SuffixTree(epoch_decay=self.epoch_decay)
            self._docmap[key] = {}
        d = tree.add_document([int(t) for t in tokens], epoch=int(epoch))
        if d >= 0:
            self._docmap[key][int(doc_id)] = d
        self.stats.docs_added += 1
        self.stats.tokens_added += len(tokens)

    def evict(self, key, doc_id: int) -> None:
        """Retire one evicted rollout from the live tree (no rebuild)."""
        dm = self._docmap.get(key)
        if dm is None or int(doc_id) not in dm:
            return  # tree never indexed this doc (e.g. warm store, cold tree)
        tree = self._trees[key]
        tree.remove_document(dm.pop(int(doc_id)))
        self.stats.docs_evicted += 1

    def begin_epoch(self, epoch: int) -> None:
        """Advance the decay reference epoch on every live tree."""
        for tree in self._trees.values():
            if tree.current_epoch != int(epoch):
                tree.current_epoch = int(epoch)
                tree._dirty = True  # decayed weights depend on the epoch

    # -- rebuild fallback / compaction ------------------------------------
    def rebuild(
        self, key, records: Iterable[RolloutRecord],
        epoch: Optional[int] = None,
    ) -> SuffixTree:
        """Reference path: fresh tree from the window (oldest -> newest).

        Query-equivalent to the incrementally maintained tree — asserted
        by the property tests — and used (a) as the verified fallback,
        (b) for compaction, (c) to warm trees from a persisted store.

        The replacement tree's ``version`` continues strictly past the
        replaced tree's: version is the staleness signal of the history
        service's delta replication, and a compaction rebuild that reset
        it would make every post-compaction pack look stale to remote
        workers (frozen replicas for the hottest keys).
        """
        old = self._trees.get(key)
        tree = SuffixTree(epoch_decay=self.epoch_decay)
        dm: Dict[int, int] = {}
        for rec in records:
            if rec.tokens is None:
                raise ValueError(
                    f"record {rec.doc_id} has no tokens (already evicted)"
                )
            d = tree.add_document(list(rec.tokens), epoch=rec.epoch)
            if d >= 0:
                dm[int(rec.doc_id)] = d
        if epoch is not None:
            tree.current_epoch = max(tree.current_epoch, int(epoch))
        if old is not None:
            tree.version = max(tree.version, old.version + 1)
        self._trees[key] = tree
        self._docmap[key] = dm
        self.stats.rebuilds += 1
        return tree

    def needs_compaction(self, key) -> bool:
        """Cheap threshold check — callers gate the (window-copying)
        ``maybe_compact`` on this so the no-op common case costs O(1)."""
        tree = self._trees.get(key)
        return (
            tree is not None
            and tree.n_tokens >= self.compact_min_tokens
            and tree.n_tokens > self.compact_ratio * max(tree.n_live_tokens, 1)
        )

    def maybe_compact(self, key, records: List[RolloutRecord]) -> bool:
        """Rebuild iff dead (retired) text dominates the corpus."""
        if not self.needs_compaction(key):
            return False
        tree = self._trees[key]
        self.rebuild(key, records, epoch=tree.current_epoch)
        self.stats.compactions += 1
        return True

    def drop(self, key) -> None:
        self._trees.pop(key, None)
        self._docmap.pop(key, None)

    def clear(self) -> None:
        self._trees.clear()
        self._docmap.clear()
