"""Static suffix array baseline (Manber–Myers) for the Fig. 5 comparison.

The paper contrasts the online suffix tree against a suffix array + LCP:
SA search is O(m log n) by binary search, but *updates* require an O(n)
(re)build — impractical when fresh trajectories arrive every iteration.
We implement the prefix-doubling construction vectorized with numpy
(O(n log n)) and binary-search pattern lookup, exactly to reproduce that
trade-off in `benchmarks/fig05_tree_vs_array.py`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class SuffixArray:
    """Suffix array over a token corpus; rebuilt from scratch on update."""

    def __init__(self) -> None:
        self.text = np.zeros((0,), dtype=np.int64)
        self.sa = np.zeros((0,), dtype=np.int64)
        self._docs: List[np.ndarray] = []
        self._sep = -1

    # -- construction ---------------------------------------------------
    def add_document(self, tokens: List[int]) -> None:
        """O(n log n) full rebuild — this is the cost the paper measures."""
        arr = np.asarray(list(tokens) + [self._sep], dtype=np.int64)
        self._sep -= 1
        self._docs.append(arr)
        self.text = np.concatenate(self._docs)
        self._build()

    def _build(self) -> None:
        t = self.text
        n = len(t)
        if n == 0:
            self.sa = np.zeros((0,), dtype=np.int64)
            return
        # Prefix doubling with numpy lexsort.
        rank = np.unique(t, return_inverse=True)[1].astype(np.int64)
        sa = np.argsort(rank, kind="stable")
        k = 1
        idx = np.arange(n)
        while k < n:
            second = np.full(n, -1, dtype=np.int64)
            second[: n - k] = rank[k:]
            order = np.lexsort((second, rank))
            new_rank = np.zeros(n, dtype=np.int64)
            r_o = rank[order]
            s_o = second[order]
            changed = np.ones(n, dtype=np.int64)
            changed[1:] = (r_o[1:] != r_o[:-1]) | (s_o[1:] != s_o[:-1])
            new_rank[order] = np.cumsum(changed) - 1
            rank = new_rank
            sa = order
            if rank[sa[-1]] == n - 1:
                break
            k *= 2
        self.sa = sa.astype(np.int64)

    @property
    def n_tokens(self) -> int:
        return int(len(self.text))

    # -- queries ----------------------------------------------------------
    def _compare(self, pos: int, pat: np.ndarray) -> int:
        """Lexicographic compare of text[pos:] vs pat: -1, 0 (pat is a
        prefix), +1."""
        t = self.text
        m = min(len(t) - pos, len(pat))
        seg = t[pos : pos + m]
        neq = np.nonzero(seg != pat[:m])[0]
        if len(neq):
            i = neq[0]
            return -1 if seg[i] < pat[i] else 1
        if m == len(pat):
            return 0
        return -1  # text suffix shorter than pattern

    def find_range(self, pat: List[int]) -> Tuple[int, int]:
        """SA index range [lo, hi) of suffixes starting with `pat`.
        O(m log n)."""
        p = np.asarray(pat, dtype=np.int64)
        sa, n = self.sa, len(self.sa)
        lo, hi = 0, n
        while lo < hi:  # lower bound
            mid = (lo + hi) // 2
            if self._compare(int(sa[mid]), p) < 0:
                lo = mid + 1
            else:
                hi = mid
        start = lo
        hi = n
        while lo < hi:  # upper bound
            mid = (lo + hi) // 2
            if self._compare(int(sa[mid]), p) <= 0:
                lo = mid + 1
            else:
                hi = mid
        return start, lo

    def longest_suffix_match(self, context: List[int], cap: int = 64) -> int:
        """Longest suffix of context present as a substring.

        Occurrence is monotone in the suffix length (every substring of
        an occurring string occurs), so the match length is binary
        searched: O(log cap) range lookups, O(m log cap log n) overall —
        not the O(cap · m log n) descending scan the seed used. Still
        slower than the tree's O(m): that gap is the paper's Fig. 5
        point and is what `benchmarks/fig05_tree_vs_array.py` measures.
        """
        lo, hi = 0, min(cap, len(context))
        while lo < hi:
            mid = (lo + hi + 1) // 2
            a, b = self.find_range(context[-mid:])
            if b > a:
                lo = mid
            else:
                hi = mid - 1
        return lo

    def propose(self, context: List[int], budget: int, cap: int = 64) -> List[int]:
        """Draft via the most frequent continuation among matched suffixes."""
        if budget <= 0:
            return []
        L = self.longest_suffix_match(context, cap)
        if L == 0:
            return []
        out: List[int] = []
        pat = list(context[-L:])
        t = self.text
        for _ in range(budget):
            lo, hi = self.find_range(pat)
            if hi <= lo:
                break
            nxt = {}
            for i in range(lo, hi):
                p = int(self.sa[i]) + len(pat)
                if p < len(t) and t[p] >= 0:
                    nxt[int(t[p])] = nxt.get(int(t[p]), 0) + 1
            if not nxt:
                break
            tok = max(nxt.items(), key=lambda kv: kv[1])[0]
            out.append(tok)
            pat.append(tok)
        return out
