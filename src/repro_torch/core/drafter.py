"""Distribution-aware nonparametric drafter (paper §4.1) — the port's
counterpart of ``repro.core.drafter``.

Maintains suffix-tree speculators over a *sliding window* of recent
rollouts, scoped per problem (the paper's best configuration), per
request, or globally. Proposals come from the longest suffix match of the
current decode context; continuations follow the highest (epoch-decayed)
frequency path.

Scopes
------
* ``problem``          — one tree per problem id (paper default).
* ``problem+request``  — problem tree + a per-request tree built online
                         from the tokens generated so far.
* ``global``           — single tree over everything.

Rollouts live in a local ``RolloutHistoryStore`` that keeps the last
``window_size`` rollouts per problem; trees are maintained live by an
``IncrementalIndex`` (online extend, online retire). Batched device
drafting packs the rows' trees into one forest — flat (one concatenated
table) or chunked (one row per tree) — and proposes for the whole batch
in one ``kernels/suffix_match`` call: a CUDA kernel on the card, its
plain version on the CPU.

Not ported yet: the remote (history-service) backing.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch import resolve_device

from .suffix_tree import MatchState, SuffixTree


@dataclass
class DrafterConfig:
    scope: str = "problem"  # problem | problem+request | global
    window_size: int = 16  # rollouts kept per problem (or globally)
    max_draft: int = 16  # hard cap on tokens per proposal
    min_match: int = 1  # minimum suffix-match length to draft at all
    epoch_decay: float = 0.9  # down-weight for older epochs (1.0 = off)
    use_prefix_trie: bool = False  # route requests by prompt prefix
    # Window adaptation: window = clip(base / (1 + gamma * update_norm))
    adapt_window_to_updates: bool = False
    window_gamma: float = 1.0
    min_window: int = 4
    # Context-tail length fed to the device matcher (batched sessions):
    # the usable match depth is capped at this many tokens, equal to
    # MatchState's resync_cap (acceptance-only effect — T=0 verification
    # is lossless either way).
    device_tail: int = 64
    # Packed-forest device layout. "flat" shares one concatenated forest
    # with every row; "chunked" packs one row per tree and each row reads
    # only its own tree. "auto" takes chunked only on a TPU whose VMEM
    # the flat forest outgrows (the reference's rule), so in the port
    # "auto" is flat.
    forest_layout: str = "auto"  # auto | flat | chunked

    def __post_init__(self) -> None:
        if self.scope not in ("problem", "problem+request", "global"):
            raise ValueError(f"unknown drafter scope: {self.scope}")
        if self.forest_layout not in ("auto", "flat", "chunked"):
            raise ValueError(
                f"forest_layout must be 'auto'|'flat'|'chunked', "
                f"got {self.forest_layout!r}"
            )


class PrefixTrie:
    """Lightweight prompt-prefix router (paper §4.1.2, per-request trees).

    Maps prompt token prefixes to problem ids so that at decode time a
    request can be routed to the right per-problem tree even when the
    engine does not carry an explicit problem id.
    """

    def __init__(self) -> None:
        self._root: dict = {}

    def insert(self, prompt: Sequence[int], problem_id) -> None:
        node = self._root
        for t in prompt:
            node = node.setdefault(int(t), {})
        node["$"] = problem_id

    def route(self, prompt: Sequence[int]):
        """Deepest registered problem id along the prompt's path."""
        node = self._root
        best = None
        for t in prompt:
            if "$" in node:
                best = node["$"]
            node = node.get(int(t))
            if node is None:
                return best
        return node.get("$", best)


class DraftSession:
    """Per-request streaming draft state (host).

    ``feed`` consumes accepted tokens (amortized O(1) each); ``propose``
    returns up to ``budget`` draft tokens. With scope problem+request the
    request's own generation is also indexed online; the problem tree
    proposes first and the request tree is the fallback.
    """

    def __init__(
        self,
        cfg: DrafterConfig,
        problem_tree: Optional[SuffixTree],
        request_tree: Optional[SuffixTree],
    ) -> None:
        self.cfg = cfg
        self._pstate: Optional[MatchState] = (
            problem_tree.match_state() if problem_tree is not None else None
        )
        self._rtree = request_tree
        self._rstate: Optional[MatchState] = (
            request_tree.match_state() if request_tree is not None else None
        )
        self.tokens_fed = 0

    def feed(self, tokens: Sequence[int]) -> None:
        toks = [int(t) for t in tokens]
        self.tokens_fed += len(toks)
        if self._pstate is not None:
            self._pstate.feed_many(toks)
        if self._rtree is not None:
            # Index the request's own generation online (Ukkonen extend),
            # then advance the matcher over the same tokens.
            for t in toks:
                self._rtree.extend(t)
            self._rstate.feed_many(toks)

    def propose(self, budget: int) -> List[int]:
        """Problem tree first, request tree as fallback."""
        budget = min(int(budget), self.cfg.max_draft)
        if budget <= 0:
            return []
        if self._pstate is not None and self._pstate.match_len >= self.cfg.min_match:
            d = self._pstate.propose(budget, self.cfg.min_match)
            if d:
                return d
        if self._rstate is not None and self._rstate.match_len >= self.cfg.min_match:
            return self._rstate.propose(budget, self.cfg.min_match)
        return []


class BatchedDraftSessions:
    """B-row draft state issuing ONE batched device propose per round.

    Keeps a bounded context tail per row (cheap list bookkeeping on
    ``feed``) and resolves the whole batch's longest-suffix matches +
    greedy continuations in a single ``kernels/suffix_match`` call over
    the packed forest of the rows' per-problem trees (``SuffixTree.pack()``,
    version-gated so the flat export is reused until the index mutates).

    ``device`` (bool) selects batched device drafting; scope
    ``problem+request`` needs the per-request tree and keeps per-row host
    sessions instead. ``tensor_device`` is where the forest lives: CUDA
    unless the caller asks for the CPU (it raises without a card).
    """

    def __init__(
        self, drafter: "SuffixDrafter", n_rows: int, device: bool = True,
        tensor_device=None,
    ) -> None:
        self.drafter = drafter
        self.cfg = drafter.cfg
        self.n_rows = int(n_rows)
        self.device = bool(device) and self.cfg.scope != "problem+request"
        self.tensor_device = resolve_device(tensor_device)
        self.tail_len = int(self.cfg.device_tail)
        self._sessions: List[Optional[DraftSession]] = [None] * self.n_rows
        self._keys: List[object] = [None] * self.n_rows
        # per-row context tails as flat buffers (numpy slice writes)
        self._tails = np.full((self.n_rows, 4 * self.tail_len), -1, np.int32)
        self._tlen = np.zeros(self.n_rows, np.int64)
        self._open = [False] * self.n_rows
        # forest cache: packed trees by key + their combined device form
        self._packed_by_key: Dict[object, object] = {}
        self._forest = None
        self._empty_forest = None
        self._roots_by_key: Dict[object, int] = {}
        # monotone bucket floors: buckets only grow, so a sliding window
        # never flips a size back and forth
        self._min_nodes = 0
        self._min_edges = 0
        self._min_corpus = 0
        # chunked-layout floors (per-tree strides + tree count)
        self._min_stride_n = 0
        self._min_stride_e = 0
        self._min_stride_c = 0
        self._min_trees = 0
        # Bumped on every repack: the fused path keys its device
        # roots/forest uploads on this.
        self.repack_version = 0
        # host<->device transfer tally for the engine's round accounting
        self.xfers = collections.Counter()

    # -- row lifecycle -----------------------------------------------------
    def open(self, row: int, problem_id, prompt: Optional[Sequence[int]] = None) -> None:
        if not self.device:
            self._sessions[row] = self.drafter.new_session(problem_id, prompt)
            self._open[row] = True
            return
        self._keys[row] = self.drafter._key(problem_id)
        self._tlen[row] = 0
        self._open[row] = True
        if prompt is not None:
            self.feed(row, prompt)
        self.drafter.stats["sessions"] += 1

    def feed(self, row: int, tokens: Sequence[int]) -> None:
        if not self.device:
            if self._sessions[row] is not None:
                self._sessions[row].feed(tokens)
            return
        arr = np.asarray(tokens, np.int64)
        m = self.tail_len
        k = len(arr)
        if k >= m:
            arr = arr[-m:]
            k = m
        cur = int(self._tlen[row])
        buf = self._tails[row]
        if cur + k > buf.shape[0]:
            buf[:m] = buf[cur - m:cur]  # compact: keep the live tail
            cur = m
        buf[cur:cur + k] = arr
        self._tlen[row] = cur + k

    def close(self, row: int) -> None:
        self._sessions[row] = None
        self._tlen[row] = 0
        self._keys[row] = None
        self._open[row] = False

    # -- batched propose ---------------------------------------------------
    def _refresh_forest(self, need_keys) -> None:
        """(Re)pack the device forest iff any needed key's flat export
        changed — ``drafter.pack_for`` is identity-stable (version-gated
        tree pack), so identity of the returned pack is the change
        signal."""
        from repro_torch.kernels.suffix_match import ops as sm_ops

        drafter = self.drafter
        changed = False
        for key in need_keys:
            pk = drafter.pack_for(key)
            if pk is None:
                continue
            if self._packed_by_key.get(key) is not pk:
                self._packed_by_key[key] = pk
                changed = True
        if changed or (self._forest is None and self._packed_by_key):
            open_keys = {self._keys[b] for b in range(self.n_rows)
                         if self._open[b]}
            # Prune packs of recycled-away problems lazily: idle packs
            # are cheap to keep; drop them once they dominate the forest.
            if len(self._packed_by_key) > max(2 * len(open_keys), 8):
                for key in [k for k in self._packed_by_key
                            if k not in open_keys]:
                    del self._packed_by_key[key]
            keys = list(self._packed_by_key.keys())
            packs = [self._packed_by_key[k] for k in keys]
            if self._pick_layout(packs) == "chunked":
                # Per-tree strides floor at the cycle maximum of the
                # largest tree (the compaction-cycle argument below,
                # applied per chunk).
                live_max = max(
                    (drafter.live_tokens_for(k) for k in keys), default=0
                )
                floor_c = int((drafter.index.compact_ratio + 1.0) * live_max)
                p2 = sm_ops._bucket(max(floor_c, sm_ops._MIN_STRIDE), 1)
                self._forest, roots = sm_ops.pack_forest_chunked(
                    packs,
                    min_stride_nodes=max(self._min_stride_n, 2 * p2),
                    min_stride_edges=max(self._min_stride_e, 2 * p2),
                    min_stride_corpus=max(self._min_stride_c, p2),
                    min_trees=max(self._min_trees, 1),
                    device=self.tensor_device,
                )
                self._min_trees = int(self._forest.corpus.shape[0])
                self._min_stride_n = int(self._forest.suffix_link.shape[1])
                self._min_stride_e = int(self._forest.edge_node.shape[1])
                self._min_stride_c = int(self._forest.corpus.shape[1])
            else:
                # The packed corpus carries retired text until the index
                # compacts at compact_ratio x live, so sizes cycle between
                # ~live and ~ratio x live: floor every bucket at the
                # cycle's maximum (nodes <= 2 x corpus tokens), rounded to
                # a power of two, so steady-state serving keeps one forest
                # geometry.
                live = sum(drafter.live_tokens_for(k) for k in keys)
                floor_c = int((drafter.index.compact_ratio + 1.0) * live)
                p2 = sm_ops._bucket(max(floor_c, sm_ops._MIN_CORPUS), 1)
                self._forest, roots = sm_ops.pack_forest(
                    packs,
                    min_nodes=max(self._min_nodes, 2 * p2,
                                  sm_ops._MIN_NODES),
                    min_edges=max(self._min_edges, 2 * p2,
                                  sm_ops._MIN_EDGES),
                    min_corpus=max(self._min_corpus, p2),
                    device=self.tensor_device,
                )
                self._min_nodes = int(self._forest.suffix_link.shape[0])
                self._min_edges = int(self._forest.edge_node.shape[0])
                self._min_corpus = int(self._forest.corpus.shape[0])
            self._roots_by_key = {k: int(r) for k, r in zip(keys, roots)}
            self.repack_version += 1
            self.drafter.stats["forest_repacks"] += 1

    def _pick_layout(self, packs) -> str:
        """Flat vs chunked forest layout: a set layout wins. ``auto`` takes
        chunked only on a TPU whose VMEM the flat forest outgrows (the
        reference's rule, which then stays chunked), so in the port
        ``auto`` is flat."""
        if self.cfg.forest_layout != "auto":
            return self.cfg.forest_layout
        return "flat"

    def prewarm(self) -> None:
        """Refresh packs/forest for every open row's tree now (before the
        first round)."""
        if not self.device:
            return
        keys = {self._keys[b] for b in range(self.n_rows) if self._open[b]}
        if keys:
            self._refresh_forest(keys)

    def refresh_for(self, rows) -> None:
        """Refresh packs/forest for the given rows' trees (the fused
        engine's pre-dispatch hook — version-gated, cheap when warm)."""
        if not self.device:
            return
        keys = {self._keys[b] for b in rows if self._open[b]}
        if keys:
            self._refresh_forest(keys)

    def forest_arrays(self):
        """Current packed forest for the fused round. Falls back to a
        cached empty forest of the configured layout when no tree is
        packed yet (cold start: every row proposes nothing, root -1), so
        a chunked configuration launches only the chunked kernel."""
        if self._forest is not None:
            return self._forest
        if self._empty_forest is None:
            from repro_torch.kernels.suffix_match import ops as sm_ops

            pack = (sm_ops.pack_forest_chunked
                    if self._pick_layout([]) == "chunked"
                    else sm_ops.pack_forest)
            self._empty_forest, _ = pack([], device=self.tensor_device)
        return self._empty_forest

    def roots_array(self) -> np.ndarray:
        """(n_rows,) per-row root handle into the current forest (node id
        for the flat layout, tree ordinal for chunked); -1 for closed rows
        and rows whose tree is not packed yet."""
        roots = np.full(self.n_rows, -1, np.int32)
        for b in range(self.n_rows):
            if self._open[b]:
                roots[b] = self._roots_by_key.get(self._keys[b], -1)
        return roots

    def tails_matrix(self) -> np.ndarray:
        """(n_rows, tail_len) left-padded context tails — the one-time
        host→device seed of the fused round state."""
        return np.stack([self.tail_row(b) for b in range(self.n_rows)])

    def tail_row(self, row: int) -> np.ndarray:
        """(tail_len,) left-padded tail of one row (fused admissions)."""
        m = self.tail_len
        out = np.full(m, -1, np.int32)
        cur = int(self._tlen[row])
        n = min(cur, m)
        if n:
            out[m - n:] = self._tails[row, cur - n:cur]
        return out

    def feed_rows(self, rows, cand: np.ndarray, n_take) -> None:
        """Feed each row its accepted tokens ``cand[b, :n_take[b]]`` (the
        unfused consume path)."""
        for b in rows:
            k = int(n_take[b])
            if k:
                self.feed(b, cand[b, :k])

    def dispatch(self, budgets) -> Optional[tuple]:
        """Issue the round's batched propose; returns an opaque handle
        for ``consume`` (device tensors still in flight)."""
        budgets = np.asarray(budgets)
        if not self.device:
            out = [[] for _ in range(self.n_rows)]
            for b in range(self.n_rows):
                if self._open[b] and self._sessions[b] is not None \
                        and budgets[b] > 0:
                    out[b] = self._sessions[b].propose(int(budgets[b]))
            return ("host", out)
        need = [b for b in range(self.n_rows)
                if self._open[b] and budgets[b] > 0]
        if not need:
            return None
        self._refresh_forest({self._keys[b] for b in need})
        if self._forest is None:
            return None
        from repro_torch.kernels.suffix_match import ops as sm_ops

        m = self.tail_len
        B = -(-self.n_rows // 8) * 8  # row bucket, as the reference pads
        query = np.full((B, m + 2), -1, np.int32)
        query[:, -1] = 0  # budgets
        rows = []
        for b in need:
            root = self._roots_by_key.get(self._keys[b], -1)
            if root < 0:
                continue
            cur = int(self._tlen[b])
            n = min(cur, m)
            if n:
                query[b, m - n:m] = self._tails[b, cur - n:cur]
            query[b, -2] = root
            query[b, -1] = min(int(budgets[b]), self.cfg.max_draft)
            rows.append(b)
        if not rows:
            return None
        res = sm_ops.suffix_match_propose(
            self._forest, None, None, None,
            n_prop_max=self.cfg.max_draft,
            min_match=self.cfg.min_match,
            query=query,
        )
        self.xfers["h2d"] += 1  # the packed (B, m+2) query upload
        self.drafter.stats["batched_proposes"] += 1
        return ("device", rows, res)

    def consume(self, handle) -> List[List[int]]:
        """Materialize a ``dispatch`` handle into per-row proposals."""
        out = [[] for _ in range(self.n_rows)]
        if handle is None:
            return out
        if handle[0] == "host":
            return handle[1]
        _, rows, (_, n_prop, props) = handle
        n_prop = n_prop.cpu().numpy()
        props = props.cpu().numpy()
        self.xfers["d2h"] += 2  # n_prop + props materialization
        for b in rows:
            n = int(n_prop[b])
            if n > 0:
                out[b] = props[b, :n].tolist()
        return out

    def propose_batch(self, budgets) -> List[List[int]]:
        """One batched propose for the round (synchronous wrapper)."""
        return self.consume(self.dispatch(budgets))


_GLOBAL_KEY = "__global__"


class SuffixDrafter:
    """Store-backed collection of incrementally maintained speculators
    (local store only; ``remote`` backing is not ported yet)."""

    def __init__(
        self,
        cfg: Optional[DrafterConfig] = None,
        store=None,
        remote=None,
    ) -> None:
        from repro_torch.history.incremental import IncrementalIndex
        from repro_torch.history.store import RolloutHistoryStore

        if remote is not None:
            raise NotImplementedError(
                "remote-backed drafting (history service) is not ported yet"
            )
        self.cfg = cfg or DrafterConfig()
        self._window_size = self.cfg.window_size
        self.store = (
            store if store is not None
            else RolloutHistoryStore(window_size=self._window_size)
        )
        self.index = IncrementalIndex(epoch_decay=self.cfg.epoch_decay)
        self._trie = PrefixTrie() if self.cfg.use_prefix_trie else None
        self.epoch = self.store.epoch
        self.stats: collections.Counter = collections.Counter()

    # -- window / lifecycle ------------------------------------------------
    def _key(self, problem_id) -> object:
        return _GLOBAL_KEY if self.cfg.scope == "global" else problem_id

    def register_prompt(self, problem_id, prompt: Sequence[int]) -> None:
        if self._trie is not None:
            self._trie.insert(prompt, problem_id)

    def observe_rollout(
        self,
        problem_id,
        tokens: Sequence[int],
        epoch: Optional[int] = None,
        response_len: Optional[int] = None,
    ) -> None:
        """Record one completed rollout: append to the history store,
        extend the live tree online and retire any rollout that just slid
        out of the window."""
        from repro_torch.history.incremental import apply_rollout

        ep = self.epoch if epoch is None else int(epoch)
        key = self._key(problem_id)
        toks = [int(t) for t in tokens]
        self.stats["rollouts_observed"] += 1
        apply_rollout(
            self.store, self.index, key, toks, ep,
            response_len=response_len, rebuild_epoch=self.epoch,
        )

    def note_draft(self, problem_id, drafted: int, accepted: int) -> None:
        """Per-problem acceptance telemetry (fed by the engine)."""
        self.stats["toks_drafted"] += int(drafted)
        self.stats["toks_accepted"] += int(accepted)
        self.store.record_draft(self._key(problem_id), drafted, accepted)

    def note_draft_rows(self, problem_ids, drafted, accepted) -> None:
        """Batched ``note_draft`` for one verify round: one store write
        per distinct problem."""
        self.stats["toks_drafted"] += int(np.sum(drafted))
        self.stats["toks_accepted"] += int(np.sum(accepted))
        agg: Dict[object, List[int]] = {}
        for pid, d, a in zip(problem_ids, drafted, accepted):
            key = self._key(pid)
            cur = agg.get(key)
            if cur is None:
                agg[key] = [int(d), int(a)]
            else:
                cur[0] += int(d)
                cur[1] += int(a)
        for key, (d, a) in agg.items():
            self.store.record_draft(key, d, a)

    def _rebuild(self, key) -> SuffixTree:
        """Reference path: fresh tree from the store window."""
        return self.index.rebuild(key, self.store.window(key), epoch=self.epoch)

    def warm_trees(self) -> int:
        """Eagerly (re)build every per-problem tree from the store — the
        warm-start path after loading persisted history."""
        n = 0
        for key in self.store.keys():
            if self.store.window(key):
                self._rebuild(key)
                n += 1
        return n

    def load_store(self, store) -> None:
        """Swap in a (persisted) ``RolloutHistoryStore``; live trees are
        dropped and rebuilt lazily per key (or eagerly via
        ``warm_trees``). The drafter's configured window size wins over
        the persisted one: shrinking evicts immediately, growing lets
        the window refill naturally (evicted payloads are gone)."""
        self.store = store
        self.index.clear()
        self.epoch = store.epoch
        if store.window_size != self._window_size:
            store.set_window_size(self._window_size)

    def begin_iteration(
        self, epoch: int, update_norm: Optional[float] = None
    ) -> None:
        """Advance the epoch cursor and reconcile windows (incremental):
        advance the decay reference, apply window adaptation (larger
        updates shrink the window, paper §4.1.2), compact corpora whose
        retired text dominates."""
        self.epoch = int(epoch)
        self.store.begin_iteration(self.epoch)
        if self.cfg.adapt_window_to_updates and update_norm is not None:
            w = int(round(self.cfg.window_size / (1.0 + self.cfg.window_gamma * float(update_norm))))
            self._window_size = max(self.cfg.min_window, min(self.cfg.window_size, w))
        if self.store.window_size != self._window_size:
            for key, evs in self.store.set_window_size(self._window_size).items():
                for ev in evs:
                    self.index.evict(key, ev.doc_id)
        self.index.begin_epoch(self.epoch)
        for key in self.store.keys():
            if self.index.needs_compaction(key):
                self.index.maybe_compact(key, self.store.window(key))
        self.stats["iterations"] += 1

    # -- sessions ------------------------------------------------------------
    def new_session(
        self, problem_id=None, prompt: Optional[Sequence[int]] = None
    ) -> DraftSession:
        """Create the per-request host draft session; feeds the prompt."""
        if problem_id is None and self._trie is not None and prompt is not None:
            problem_id = self._trie.route(prompt)
        key = self._key(problem_id)
        tree = self.index.tree(key)
        if tree is None and self.store.window(key):
            tree = self._rebuild(key)
        rtree = None
        if self.cfg.scope == "problem+request":
            rtree = SuffixTree(epoch_decay=1.0)
        sess = DraftSession(self.cfg, tree, rtree)
        if prompt is not None:
            sess.feed(prompt)
        self.stats["sessions"] += 1
        return sess

    def batched_sessions(
        self, n_rows: int, device: Optional[bool] = None, tensor_device=None,
    ) -> BatchedDraftSessions:
        """B-row draft state with one batched device propose per round.
        ``device=None`` auto-selects: the device path for tree-only
        scopes, per-row host sessions for ``problem+request``."""
        if device is None:
            device = self.cfg.scope != "problem+request"
        return BatchedDraftSessions(self, n_rows, device=device,
                                    tensor_device=tensor_device)

    # -- pack source -------------------------------------------------------
    def pack_for(self, key):
        """Current ``PackedSuffixTree`` for ``key`` (version-gated cache
        inside ``SuffixTree.pack``, identity-stable until the tree
        changes)."""
        tree = self.index.tree(key)
        if tree is None and self.store.window(key):
            tree = self._rebuild(key)
        return None if tree is None else tree.pack()

    def live_tokens_for(self, key) -> int:
        """Live-corpus size estimate for forest bucket floors."""
        tree = self.index.tree(key)
        return 0 if tree is None else tree.n_live_tokens
