"""Online token-level suffix tree (Ukkonen) for nonparametric drafting.

This is the paper's core data structure (§4.1.2): a suffix tree built
over a sliding window of recent rollouts, extended *online* in amortized
O(1) per token (Ukkonen 1995), queried for the longest suffix of the
current decode context in O(m) via matching-statistics streaming
(suffix-link descent), and used to propose multi-token drafts by walking
the highest-frequency continuation path.

Design notes
------------
* Tokens are non-negative ints. Documents (rollouts) are separated by
  unique negative separator tokens so that no match can bridge documents.
* Leaf counts (= number of occurrences of the path's substring) are
  maintained lazily: insertions mark the tree dirty and the first
  subsequent `propose` triggers a single O(n) DFS refresh. Insertions
  happen once per completed rollout; proposals happen every verify round,
  so the amortized cost is one DFS per observed rollout.
* Counts are *epoch-weighted*: a leaf contributes `decay**(cur_epoch -
  leaf_epoch)`, implementing the paper's "mild down-weighting of matches
  originating from older epochs" (§4.1.2, sliding-window selection tree).
* The hot query path is `MatchState`: a streaming matcher that maintains
  the longest suffix of the fed token stream that occurs in the tree,
  following suffix links on mismatch (Chang–Lawler matching statistics).
  Feeding a token is amortized O(1); total O(m) over a context of length
  m, matching the paper's claimed complexity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

_INF = 1 << 60


@dataclass
class PackedSuffixTree:
    """Flat, device-shippable export of one suffix tree.

    Node table in first-child/next-sibling form (children in ascending
    token order), edge spans into the packed corpus, per-node suffix
    links and precomputed greedy continuation children. This is the
    host-side contract of the ``kernels/suffix_match`` pallas kernel:
    the kernel never touches Python objects, only these arrays.

    Conventions (all int32, root = node 0):
    * ``first_child[v]`` / ``next_sibling[v]`` — child linked list,
      -1 terminated, siblings sorted by first edge token (host-side
      introspection/debugging view of the topology).
    * ``edge_node`` / ``edge_tok`` / ``edge_child`` — the same topology
      as a (node, token) → child table, lexicographically sorted and
      with separator edges excluded: this is what the kernel binary
      searches for child lookup (a context token can never match a
      separator edge, and re-descents only probe already-matched — i.e.
      separator-free — text).
    * ``edge_start[v]`` / ``edge_len[v]`` — label of the edge *into*
      ``v`` as a span of ``corpus`` (leaf edges frozen at pack time).
    * ``first_tok[v]`` — first token of the incoming edge (-1 for the
      root and for separator edges, which can never match a context
      token).
    * ``suffix_link[v]`` — valid for the root (self) and every internal
      node; Ukkonen's occasionally-missing last link is recomputed at
      pack time, so the kernel needs no re-descend fallback. Leaves
      carry the root (a matcher can never sit exactly on a leaf: the
      corpus ends with a separator, so every leaf edge ends in a token
      that cannot be matched).
    * ``best_child[v]`` — the child the greedy highest-weight
      continuation walk takes from ``v`` (ties to the smallest token,
      separator edges excluded; -1 when no continuation exists). Baked
      from the epoch-decayed ``wcount`` at pack time so the device walk
      is pure pointer-chasing.
    * ``corpus`` — the token text with every (unique, negative)
      document separator collapsed to -1.
    """

    first_child: np.ndarray
    next_sibling: np.ndarray
    edge_node: np.ndarray
    edge_tok: np.ndarray
    edge_child: np.ndarray
    suffix_link: np.ndarray
    edge_start: np.ndarray
    edge_len: np.ndarray
    first_tok: np.ndarray
    best_child: np.ndarray
    corpus: np.ndarray
    n_nodes: int
    version: int
    epoch: int

    @property
    def n_edges(self) -> int:
        return int(len(self.edge_node))


class _Node:
    __slots__ = ("children", "link", "parent", "start", "end", "count", "wcount")

    def __init__(self, start: int, end: int) -> None:
        # Edge label = text[start:end) on the edge *into* this node.
        self.children: Dict[int, "_Node"] = {}
        self.link: Optional["_Node"] = None
        self.parent: Optional["_Node"] = None  # maintained for removal
        self.start = start
        self.end = end  # _INF for open (leaf) edges
        self.count = 0  # occurrences (leaves below), refreshed lazily
        self.wcount = 0.0  # epoch-decayed occurrence weight

    def edge_len(self, text_len: int) -> int:
        return min(self.end, text_len) - self.start


class SuffixTree:
    """Ukkonen online suffix tree over a growing token corpus."""

    def __init__(self, epoch_decay: float = 1.0) -> None:
        self.text: List[int] = []
        self.root = _Node(-1, -1)
        self.root.link = self.root
        # Ukkonen active point
        self._active_node: _Node = self.root
        self._active_edge = -1  # index into text of first token on edge
        self._active_len = 0
        self._remainder = 0
        # Document bookkeeping
        self._sep = -1  # next (negative) separator token
        self.doc_epoch: List[int] = []  # epoch tag per document
        self._doc_start: List[int] = []  # corpus offset per document
        self._doc_end: List[int] = []  # offset past the separator
        self.doc_alive: List[bool] = []  # False once retired
        self.epoch_decay = float(epoch_decay)
        self.current_epoch = 0
        self._dirty = True
        self.n_docs = 0  # live documents
        self.n_live_tokens = 0  # corpus tokens owned by live docs (+seps)
        # Leaf registry: suffix start position -> its leaf node. Every
        # suffix becomes explicit once its document's unique separator is
        # inserted, so between documents this covers the whole corpus;
        # it is what makes online document retirement possible.
        self._leaf_at: Dict[int, _Node] = {}
        # Bumped on every mutation: live MatchStates resync lazily (an
        # Ukkonen extension may split the very edge a matcher stands on).
        self.version = 0
        # pack() cache, keyed on (version, current_epoch): the flat
        # export is reused until the index mutates or the decay epoch
        # moves, amortizing the O(n) repack against observe_rollout.
        self._packed: Optional[PackedSuffixTree] = None
        self._packed_key: Optional[Tuple[int, int]] = None

    # ------------------------------------------------------------------
    # Construction (Ukkonen)
    # ------------------------------------------------------------------
    def _edge_first(self, node: _Node) -> int:
        return self.text[node.start]

    def _walk_down(self, node: _Node) -> bool:
        """Canonicalize the active point: descend while active_len spans
        the whole active edge."""
        n = len(self.text)
        if self._active_len == 0:
            return False
        child = self._active_node.children.get(self.text[self._active_edge])
        assert child is not None
        el = child.edge_len(n)
        if self._active_len >= el:
            self._active_edge += el
            self._active_len -= el
            self._active_node = child
            return True
        return False

    def extend(self, token: int) -> None:
        """Append one token to the corpus (amortized O(1))."""
        self.text.append(token)
        n = len(self.text)
        pos = n - 1
        self._remainder += 1
        last_internal: Optional[_Node] = None
        while self._remainder > 0:
            if self._active_len == 0:
                self._active_edge = pos
            child = self._active_node.children.get(self.text[self._active_edge])
            if child is None:
                # Rule 2: new leaf from active node
                leaf = _Node(pos, _INF)
                leaf.parent = self._active_node
                self._leaf_at[pos - self._remainder + 1] = leaf
                self._active_node.children[self.text[self._active_edge]] = leaf
                if last_internal is not None:
                    last_internal.link = self._active_node
                    last_internal = None
            else:
                if self._walk_down(child):
                    continue
                if self.text[child.start + self._active_len] == token:
                    # Rule 3: already present — stop (showstopper)
                    if last_internal is not None:
                        last_internal.link = self._active_node
                    self._active_len += 1
                    break
                # Rule 2 with split
                split = _Node(child.start, child.start + self._active_len)
                split.parent = self._active_node
                self._active_node.children[self.text[self._active_edge]] = split
                leaf = _Node(pos, _INF)
                leaf.parent = split
                self._leaf_at[pos - self._remainder + 1] = leaf
                split.children[token] = leaf
                child.start += self._active_len
                child.parent = split
                split.children[self.text[child.start]] = child
                if last_internal is not None:
                    last_internal.link = split
                last_internal = split
            self._remainder -= 1
            if self._active_node is self.root and self._active_len > 0:
                self._active_len -= 1
                self._active_edge = pos - self._remainder + 1
            else:
                self._active_node = (
                    self._active_node.link
                    if self._active_node.link is not None
                    else self.root
                )
        self._dirty = True
        self.version += 1

    def add_document(self, tokens: List[int], epoch: int = 0) -> int:
        """Insert one rollout; a unique separator prevents cross-doc
        matches. O(len(tokens)) amortized. Returns the document index
        (pass it to ``remove_document`` to retire the rollout later)."""
        if not tokens:
            return -1
        self._doc_start.append(len(self.text))
        self.doc_epoch.append(epoch)
        self.doc_alive.append(True)
        self.n_docs += 1
        self.current_epoch = max(self.current_epoch, epoch)
        for t in tokens:
            if t < 0:
                raise ValueError("tokens must be non-negative ints")
            self.extend(int(t))
        self.extend(self._sep)
        self._sep -= 1
        self._doc_end.append(len(self.text))
        self.n_live_tokens += len(self.text) - self._doc_start[-1]
        return len(self._doc_start) - 1

    def remove_document(self, d: int) -> None:
        """Retire one document online — the reverse of ``add_document``.

        Deletes the document's suffix leaves (via the leaf registry) and
        any ancestors left childless, in O(doc_len) dictionary
        operations: no rebuild. Correctness rests on three separator
        facts: (1) the Ukkonen active point is at the root between
        documents, so the builder state never references removed nodes;
        (2) no internal node's path spans a (unique) separator, so a
        surviving node's suffix-link target also survives; (3) every
        remaining node keeps >= 1 live leaf below it, so the pruned tree
        is *structurally* the suffix tree of the live documents —
        queries need no liveness filtering. Unary internal nodes left
        behind are tolerated (paths and counts are unaffected).
        """
        if self._remainder != 0:
            raise RuntimeError("cannot remove documents mid-extension")
        if d < 0 or d >= len(self._doc_start):
            raise IndexError(f"no document {d}")
        if not self.doc_alive[d]:
            raise ValueError(f"document {d} already removed")
        start, end = self._doc_start[d], self._doc_end[d]
        for i in range(start, end):
            node: Optional[_Node] = self._leaf_at.pop(i, None)
            while (
                node is not None
                and node is not self.root
                and not node.children
            ):
                parent = node.parent
                tok = self.text[node.start]
                if parent is not None and parent.children.get(tok) is node:
                    del parent.children[tok]
                node = parent
        self.doc_alive[d] = False
        self.n_docs -= 1
        self.n_live_tokens -= end - start
        self._dirty = True
        self.version += 1

    @property
    def n_tokens(self) -> int:
        return len(self.text)

    # ------------------------------------------------------------------
    # Lazy count refresh
    # ------------------------------------------------------------------
    def _doc_of(self, pos: int) -> int:
        """Document index owning corpus position `pos` (binary search)."""
        lo, hi = 0, len(self._doc_start) - 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if self._doc_start[mid] <= pos:
                lo = mid
            else:
                hi = mid - 1
        return lo

    def refresh_counts(self) -> None:
        """One iterative post-order DFS: leaf count 1 (weight by epoch
        age), internal = sum of children."""
        if not self._dirty:
            return
        n = len(self.text)
        decay = self.epoch_decay
        cur = self.current_epoch
        stack: List[Tuple[_Node, bool]] = [(self.root, False)]
        while stack:
            node, seen = stack.pop()
            if not seen:
                stack.append((node, True))
                for ch in node.children.values():
                    stack.append((ch, False))
            else:
                if not node.children:  # leaf
                    node.count = 1
                    if decay >= 1.0:
                        node.wcount = 1.0
                    else:
                        # Leaf start identifies the suffix; its document
                        # determines the epoch age.
                        d = self._doc_of(min(node.start, n - 1))
                        node.wcount = decay ** max(0, cur - self.doc_epoch[d])
                else:
                    # Sum children in sorted-token order: child dict order
                    # depends on construction history, and float rounding
                    # must not differ between an incrementally maintained
                    # tree and a fresh rebuild (corresponding branch nodes
                    # have the same child token sets — separators included,
                    # which sort newest-document-first in both — so sorted
                    # summation yields bit-identical weights).
                    node.count = 0
                    node.wcount = 0.0
                    for t in sorted(node.children):
                        c = node.children[t]
                        node.count += c.count
                        node.wcount += c.wcount
        self._dirty = False

    # ------------------------------------------------------------------
    # Flat export for the device kernel
    # ------------------------------------------------------------------
    def pack(self) -> PackedSuffixTree:
        """Export the tree as flat arrays (see ``PackedSuffixTree``).

        Version-gated: the packed form is cached and reused until the
        tree mutates (``version``) or the decay reference epoch moves
        (``current_epoch``), so between rollout observations every
        verify round hits the cache. Only document-complete trees pack
        (corpus ends with a separator) — this is what guarantees a
        matcher can never sit exactly on a leaf, which lets leaves skip
        real suffix links.
        """
        if self._remainder != 0:
            raise RuntimeError("cannot pack mid-extension")
        if self.text and self.text[-1] >= 0:
            raise RuntimeError(
                "pack() requires a document-complete tree (corpus must "
                "end with a separator); request-scoped trees stay host-side"
            )
        self.refresh_counts()
        key = (self.version, self.current_epoch)
        if self._packed is not None and self._packed_key == key:
            return self._packed
        n = len(self.text)
        text = self.text
        # DFS indexing, children in ascending-token order; parents come
        # before children so depths resolve in one pass. All per-node
        # fields accumulate in Python lists (per-element numpy stores
        # are ~5x slower) and convert to arrays once at the end.
        idx: Dict[int, int] = {id(self.root): 0}
        nodes: List[_Node] = [self.root]
        depth: List[int] = [0]
        stack: List[Tuple[_Node, int]] = [(self.root, 0)]
        while stack:
            nd, i = stack.pop()
            d = depth[i]
            for t in sorted(nd.children):
                ch = nd.children[t]
                ci = len(nodes)
                idx[id(ch)] = ci
                nodes.append(ch)
                depth.append(d + min(ch.end, n) - ch.start)
                stack.append((ch, ci))
        N = len(nodes)
        first_child = [-1] * N
        next_sibling = [-1] * N
        suffix_link = [0] * N
        edge_start = [0] * N
        edge_len = [0] * N
        first_tok = [-1] * N
        best_child = [-1] * N
        e_node: List[int] = []
        e_tok: List[int] = []
        e_child: List[int] = []
        for i, nd in enumerate(nodes):
            if i > 0:
                edge_start[i] = nd.start
                edge_len[i] = min(nd.end, n) - nd.start
                t0 = text[nd.start]
                first_tok[i] = t0 if t0 >= 0 else -1
            children = nd.children
            prev = -1
            best_t, best_c, best_w = None, None, -1.0
            for t in sorted(children):  # ascending token order
                c = children[t]
                ci = idx[id(c)]
                if prev < 0:
                    first_child[i] = ci
                else:
                    next_sibling[prev] = ci
                prev = ci
                if t >= 0:
                    # node index grows with `i` and tokens are visited
                    # sorted, so the edge table is lexicographic by
                    # construction
                    e_node.append(i)
                    e_tok.append(t)
                    e_child.append(ci)
                    # Greedy continuation child: exact replica of the
                    # host `_walk_continuation` arg-max (highest wcount,
                    # ties to the smallest token, separators excluded).
                    if c.wcount > best_w or (
                        c.wcount == best_w and t < best_t
                    ):
                        best_t, best_c, best_w = t, c, c.wcount
            if best_c is not None:
                best_child[i] = idx[id(best_c)]
            if i > 0 and children:
                ln = nd.link
                if ln is not None and id(ln) in idx:
                    suffix_link[i] = idx[id(ln)]
                else:
                    # Ukkonen can leave the last-created internal node
                    # of a document unlinked; its suffix is a branching
                    # string, hence an explicit node — recover it by
                    # skip/count descent of path[1:] from the root.
                    end = min(nd.end, n)
                    rem = depth[i] - 1
                    pos = end - rem
                    node = self.root
                    while rem > 0:
                        ch = node.children[text[pos]]
                        el = min(ch.end, n) - ch.start
                        assert rem >= el, "suffix-link target must be a node"
                        node, pos, rem = ch, pos + el, rem - el
                    suffix_link[i] = idx[id(node)]
        corpus = np.asarray(text, np.int64).clip(min=-1).astype(np.int32)
        self._packed = PackedSuffixTree(
            first_child=np.asarray(first_child, np.int32),
            next_sibling=np.asarray(next_sibling, np.int32),
            edge_node=np.asarray(e_node, np.int32),
            edge_tok=np.asarray(e_tok, np.int32),
            edge_child=np.asarray(e_child, np.int32),
            suffix_link=np.asarray(suffix_link, np.int32),
            edge_start=np.asarray(edge_start, np.int32),
            edge_len=np.asarray(edge_len, np.int32),
            first_tok=np.asarray(first_tok, np.int32),
            best_child=np.asarray(best_child, np.int32),
            corpus=corpus, n_nodes=N, version=self.version,
            epoch=self.current_epoch,
        )
        self._packed_key = key
        return self._packed

    # ------------------------------------------------------------------
    # Queries
    # ------------------------------------------------------------------
    def match_state(self, resync_cap: int = 64) -> "MatchState":
        return MatchState(self, resync_cap=resync_cap)

    def longest_suffix_match(self, context: List[int]) -> int:
        """Length of the longest suffix of `context` present in the tree.
        O(len(context)) total via streaming."""
        st = self.match_state()
        for t in context:
            st.feed(int(t))
        return st.match_len

    def propose(self, context: List[int], budget: int) -> List[int]:
        """One-shot: stream `context`, then propose up to `budget` tokens.
        Prefer `MatchState.propose` for incremental use."""
        st = self.match_state()
        for t in context:
            st.feed(int(t))
        return st.propose(budget)


class MatchState:
    """Streaming longest-suffix matcher + draft proposer.

    Maintains the invariant: the last `match_len` fed tokens label a path
    from the root ending at (node, edge_pos). `feed` is amortized O(1)
    while the tree is unmutated; after a mutation (version bump) the
    matcher resyncs by re-feeding a bounded buffer of recent tokens
    (Ukkonen extensions can split the edge a matcher stands on, so stale
    pointers must never be trusted across mutations).
    """

    __slots__ = (
        "tree", "node", "edge_child", "edge_pos", "match_len",
        "_ver", "_recent", "resync_cap",
    )

    def __init__(self, tree: SuffixTree, resync_cap: int = 64) -> None:
        self.tree = tree
        self.node: _Node = tree.root
        self.edge_child: Optional[_Node] = None  # child whose edge we're on
        self.edge_pos = 0  # tokens consumed on that edge
        self.match_len = 0
        self.resync_cap = resync_cap
        self._ver = tree.version
        import collections as _c

        self._recent = _c.deque(maxlen=resync_cap)

    def reset(self) -> None:
        self.node = self.tree.root
        self.edge_child = None
        self.edge_pos = 0
        self.match_len = 0

    def _resync(self) -> None:
        if self._ver == self.tree.version:
            return
        self.reset()
        self._ver = self.tree.version
        for t in self._recent:
            self._feed_raw(t)

    # -- internal ------------------------------------------------------
    def _try_step(self, token: int) -> bool:
        """Try to extend the current path by `token`."""
        text = self.tree.text
        n = len(text)
        if self.edge_child is not None:
            el = self.edge_child.edge_len(n)
            if self.edge_pos < el:
                if text[self.edge_child.start + self.edge_pos] == token:
                    self.edge_pos += 1
                    if self.edge_pos == self.edge_child.edge_len(n):
                        self.node = self.edge_child
                        self.edge_child = None
                        self.edge_pos = 0
                    return True
                return False
            # exactly at node boundary (shouldn't linger here, normalize)
            self.node = self.edge_child
            self.edge_child = None
            self.edge_pos = 0
        child = self.node.children.get(token)
        if child is None:
            return False
        self.edge_child = child
        self.edge_pos = 1
        if self.edge_pos == child.edge_len(n):
            self.node = child
            self.edge_child = None
            self.edge_pos = 0
        return True

    def _end_pos(self) -> int:
        """Corpus index just past the current match's label occurrence."""
        if self.edge_child is not None:
            return self.edge_child.start + self.edge_pos
        if self.node is self.tree.root:
            return 0
        return min(self.node.end, len(self.tree.text))

    def _descend(self, node: _Node, pos: int, rem: int) -> None:
        """Skip/count descent of text[pos:pos+rem] from `node` (the string
        is known to exist, so only first tokens of segments are probed)."""
        text = self.tree.text
        n = len(text)
        while rem > 0:
            child = node.children.get(text[pos])
            assert child is not None, "skip/count descent must succeed"
            el = child.edge_len(n)
            if rem >= el:
                node = child
                pos += el
                rem -= el
            else:
                self.node = node
                self.edge_child = child
                self.edge_pos = rem
                return
        self.node = node
        self.edge_child = None
        self.edge_pos = 0

    def _follow_suffix_link(self) -> None:
        """Drop the first token of the current match (suffix-link hop +
        re-canonicalization), keeping the rest matched."""
        tree = self.tree
        if self.match_len == 0:
            return
        new_len = self.match_len - 1
        if self.edge_child is not None and self.node is not tree.root:
            link = self.node.link
            if link is not None:
                # Fast path: hop the link, re-descend only the edge tail.
                self.match_len = new_len
                self._descend(link, self.edge_child.start, self.edge_pos)
                return
        elif self.edge_child is not None:  # at root, on an edge
            self.match_len = new_len
            self._descend(
                tree.root, self.edge_child.start + 1, self.edge_pos - 1
            )
            return
        elif self.node.link is not None and self.node is not tree.root:
            # Exactly at an internal node with a valid link.
            self.match_len = new_len
            self.node = self.node.link
            self.edge_child = None
            self.edge_pos = 0
            return
        # Fallback (leaf node, or link not yet set by Ukkonen): recompute
        # the matched string's location and re-descend from the root.
        end = self._end_pos()
        self.match_len = new_len
        self._descend(tree.root, end - new_len, new_len)

    # -- public --------------------------------------------------------
    def _feed_raw(self, token: int) -> int:
        if token < 0:
            self.reset()
            return 0
        while True:
            if self._try_step(token):
                self.match_len += 1
                return self.match_len
            if self.match_len == 0:
                return 0
            self._follow_suffix_link()

    def feed(self, token: int) -> int:
        """Consume the next context token; returns new match length."""
        self._resync()
        self._recent.append(int(token))
        return self._feed_raw(int(token))

    def feed_many(self, tokens) -> int:
        ml = self.match_len
        for t in tokens:
            ml = self.feed(int(t))
        return ml

    def _walk_continuation(self, budget: int) -> List[int]:
        """Greedy highest-weight walk below the current match position."""
        tree = self.tree
        text = tree.text
        n = len(text)
        out: List[int] = []
        node, child, pos = self.node, self.edge_child, self.edge_pos
        while len(out) < budget:
            if child is not None:
                el = child.edge_len(n)
                if pos < el:
                    t = text[child.start + pos]
                    if t < 0:
                        break
                    out.append(t)
                    pos += 1
                    continue
                node, child, pos = child, None, 0
                continue
            if not node.children:
                break
            # Deterministic arg-max: highest weight, ties to the smallest
            # token — child dict insertion order depends on construction
            # history, and an incrementally maintained tree must propose
            # identically to a fresh rebuild (history/incremental.py).
            best_t, best_c, best_w = None, None, -1.0
            for t, c in node.children.items():
                if t < 0:
                    continue
                if c.wcount > best_w or (c.wcount == best_w and t < best_t):
                    best_t, best_c, best_w = t, c, c.wcount
            if best_c is None:
                break
            out.append(best_t)
            child, pos = best_c, 1
        return out

    def propose(self, budget: int, min_match: int = 1) -> List[int]:
        """Highest-weight continuation for up to `budget` tokens.

        Falls back to progressively shorter suffixes (suffix-link hops)
        when the deepest match has no continuation — essential for
        request-scoped trees, where the stream always matches its own
        latest copy up to the corpus end. Does not mutate the streaming
        state. Returns [] if no match >= `min_match` yields tokens.
        """
        self._resync()
        if budget <= 0 or self.match_len < min_match:
            return []
        tree = self.tree
        tree.refresh_counts()
        snap = self.snapshot()
        try:
            while self.match_len >= max(min_match, 1):
                out = self._walk_continuation(budget)
                if out:
                    return out
                self._follow_suffix_link()
            return []
        finally:
            self.restore(snap)

    def snapshot(self) -> Tuple[_Node, Optional[_Node], int, int]:
        return (self.node, self.edge_child, self.edge_pos, self.match_len)

    def restore(self, snap: Tuple[_Node, Optional[_Node], int, int]) -> None:
        self.node, self.edge_child, self.edge_pos, self.match_len = snap
