"""Suffix-match drafting: the port against the JAX package.

Same seeded trees through both packages' ``SuffixTree.pack()``,
``pack_forest`` and ``pack_forest_chunked`` (arrays must be equal), then
the port's plain propose against JAX ``suffix_match_propose`` with
``impl="ref"`` and with the Pallas kernels in interpret mode, for the flat
and the chunked layouts: bit-identical (integers only, no tolerance). The
CUDA kernels' edge search (a 33-way lower-bound search whose first two
rounds read staged splitters) is modelled here and held to the plain
version's binary search, on packed tables sorted as it needs. The CUDA
kernels are held against the plain versions in the ``gpu`` tests (and in
``chip_smoke.py``); those need only the port, so on a machine without JAX
they run alone: ``pytest --noconftest -m gpu`` on this file.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.suffix_tree import SuffixTree as JSuffixTree
from repro_torch.core.drafter import DrafterConfig, SuffixDrafter
from repro_torch.core.suffix_tree import SuffixTree
from repro_torch.kernels.suffix_match import ops as tops
from repro_torch.kernels.suffix_match.ref import (
    _find_child,
    suffix_match_propose_chunked_ref,
    suffix_match_propose_ref,
)

try:  # absent where only the port is installed: the gpu tests run there
    import jax.numpy as jnp

    from repro.core.drafter import DrafterConfig as JDrafterConfig
    from repro.core.drafter import SuffixDrafter as JSuffixDrafter
    from repro.kernels.suffix_match import ops as jops
    from repro.kernels.suffix_match.kernel import (
        suffix_match_propose_kernel_chunked,
    )
except ModuleNotFoundError:
    jnp = None

TAIL = 16
KMAX = 8
FIELDS = ("edge_node", "edge_tok", "edge_child", "suffix_link", "edge_start",
          "edge_len", "first_tok", "best_child", "corpus", "first_child",
          "next_sibling")


def _mk(cls, docs, decay=1.0, epochs=None, remove=(), current=None):
    tree = cls(epoch_decay=decay)
    for i, d in enumerate(docs):
        tree.add_document(list(d), epoch=epochs[i] if epochs else 0)
    for d in remove:
        tree.remove_document(d)
    if current is not None:
        tree.current_epoch = current
        tree._dirty = True
    return tree


def _seeded_docs(seed, n_docs, vocab, max_len):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, vocab, size=rng.integers(1, max_len))]
            for _ in range(n_docs)]


TREES = {
    "basic": dict(docs=[[1, 2, 3, 4, 5], [1, 2, 3, 9, 9], [7, 1, 2, 3, 9]]),
    "decay_removal": dict(
        docs=[[1, 2, 3, 4], [1, 2, 3, 8], [1, 2, 3, 8], [1, 2, 3, 4]],
        decay=0.5, epochs=[0, 1, 2, 3], remove=(1,), current=5,
    ),
    "seeded_stream": dict(
        docs=_seeded_docs(11, 10, 6, 30), decay=0.9,
        epochs=list(range(10)), remove=(2, 5), current=12,
    ),
    "seeded_wide": dict(docs=_seeded_docs(12, 6, 40, 60), decay=0.8,
                        epochs=[0, 0, 1, 1, 2, 2], remove=(0,), current=3),
}


def _pair(name):
    kw = TREES[name]
    return _mk(JSuffixTree, **kw), _mk(SuffixTree, **kw)


@pytest.mark.parametrize("name", sorted(TREES))
def test_pack_equals_jax(name):
    jt, tt = _pair(name)
    jp, tp = jt.pack(), tt.pack()
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(jp, f), getattr(tp, f), err_msg=f)
    assert (jp.n_nodes, jp.version, jp.epoch) == (tp.n_nodes, tp.version, tp.epoch)


def test_pack_forest_equals_jax():
    pairs = [_pair(n) for n in sorted(TREES)]
    jf, jr = jops.pack_forest([j.pack() for j, _ in pairs])
    tf, tr = tops.pack_forest([t.pack() for _, t in pairs], device="cpu")
    np.testing.assert_array_equal(jr, tr)
    for name, a, b in zip(tops.PackedForest._fields, jf, tf):
        assert b.dtype == torch.int32 and b.device.type == "cpu"
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)


# (tree ordinal in sorted(TREES) order, document) — the forests below
# pack the trees in that order
ALL_DOCS = [(i, d) for i, n in enumerate(sorted(TREES)) for d in TREES[n]["docs"]]


def _batch(seed, B, vocab, troots, p_inactive=0.25):
    """Seeded rows: half the tails are cut from the trees' documents (so
    they match deeply), half are random tokens."""
    rng = np.random.default_rng(seed)
    tails = np.full((B, TAIL), -1, np.int32)
    roots = troots[rng.integers(0, len(troots), size=B)].astype(np.int32)
    for b in range(B):
        n = int(rng.integers(0, TAIL + 1))
        if b % 2 == 0:
            ti, doc = ALL_DOCS[int(rng.integers(0, len(ALL_DOCS)))]
            roots[b] = troots[min(ti, len(troots) - 1)]
            cut = int(rng.integers(1, len(doc) + 1))
            src = np.asarray(doc[:cut][-n:], np.int32) if n else []
            n = len(src)
            tails[b, TAIL - n:] = src
        else:
            tails[b, TAIL - n:] = rng.integers(0, vocab, size=n)
        if n > 3 and rng.random() < 0.3:  # a reset (separator) mid-tail
            tails[b, TAIL - n + 1] = -1
    roots[rng.random(B) < p_inactive] = -1
    roots[0] = troots[0]
    budgets = rng.integers(0, KMAX + 3, size=B).astype(np.int32)
    return tails, roots, budgets


@pytest.mark.parametrize("min_match", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_propose_bit_identical_to_jax(seed, min_match):
    pairs = [_pair(n) for n in sorted(TREES)]
    jf, troots = jops.pack_forest([j.pack() for j, _ in pairs])
    tf, _ = tops.pack_forest([t.pack() for _, t in pairs], device="cpu")
    tails, roots, budgets = _batch(seed, 12, 8, troots)
    want = [np.asarray(x) for x in jops.suffix_match_propose(
        jf, tails, roots, budgets, n_prop_max=KMAX, min_match=min_match,
        impl="ref",
    )]
    got = [x.numpy() for x in tops.suffix_match_propose(
        tf, tails, roots, budgets, n_prop_max=KMAX, min_match=min_match,
    )]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    assert (got[1] > 0).any(), "the case must actually propose something"
    assert (got[0][roots < 0] == 0).all() and (got[2][roots < 0] == -1).all()


def test_plain_propose_bit_identical_to_pallas_interpret():
    jt, tt = _pair("seeded_stream")
    jf, troots = jops.pack_forest([jt.pack()])
    tf, _ = tops.pack_forest([tt.pack()], device="cpu")
    tails, roots, budgets = _batch(5, 4, 6, troots)
    want = [np.asarray(x) for x in jops.suffix_match_propose(
        jf, tails, roots, budgets, n_prop_max=KMAX, min_match=1,
        impl="pallas", interpret=True,
    )]
    got = [x.numpy() for x in tops.suffix_match_propose(
        tf, tails, roots, budgets, n_prop_max=KMAX, min_match=1,
    )]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)


def _chunked_pair():
    pairs = [_pair(n) for n in sorted(TREES)]
    jf, jr = jops.pack_forest_chunked([j.pack() for j, _ in pairs])
    tf, tr = tops.pack_forest_chunked([t.pack() for _, t in pairs],
                                      device="cpu")
    return pairs, jf, jr, tf, tr


def test_pack_forest_chunked_equals_jax():
    _, jf, jr, tf, tr = _chunked_pair()
    np.testing.assert_array_equal(jr, tr)
    for name, a, b in zip(tops.ChunkedForest._fields, jf, tf):
        assert b.dtype == torch.int32 and b.dim() == 2
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    # tree count and strides are bucketed: padded rows exist and self-link
    assert tf.corpus.shape[0] == 4 and len(tr) == len(TREES)


def _chunked_batch(seed, troots):
    tails, roots, budgets = _batch(seed, 12, 8, troots)
    budgets[1] = 0  # a zero budget on a (possibly) active row
    roots[2] = -1  # and an inactive one
    return tails, roots, budgets


@pytest.mark.parametrize("min_match", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1, 4])
def test_chunked_plain_propose_bit_identical(seed, min_match):
    """The port's chunked plain version against JAX ``_propose_chunked_ref``
    and against the port's flat plain version over the same trees."""
    pairs, jf, troots, tf, _ = _chunked_pair()
    tails, roots, budgets = _chunked_batch(seed, troots)
    kw = dict(n_prop_max=KMAX, min_match=min_match)
    want = [np.asarray(x) for x in jops._propose_chunked_ref(
        jf, jnp.asarray(tails), jnp.asarray(roots), jnp.asarray(budgets),
        **kw)]
    args = [torch.from_numpy(a) for a in (tails, roots, budgets)]
    got = [x.numpy() for x in suffix_match_propose_chunked_ref(
        *args, *tf, **kw)]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    assert (got[1] > 0).any(), "the case must actually propose something"
    assert (got[0][roots < 0] == 0).all() and (got[2][roots < 0] == -1).all()
    # the flat layout over the same trees proposes the same
    ff, froots = tops.pack_forest([t.pack() for _, t in pairs], device="cpu")
    flat_roots = np.where(roots >= 0, froots[np.maximum(roots, 0)], -1)
    flat = tops.suffix_match_propose(ff, tails, flat_roots.astype(np.int32),
                                     budgets, **kw)
    for f, g in zip(flat, got):
        np.testing.assert_array_equal(f.numpy(), g)


@pytest.mark.parametrize("seed", [5, 6])
def test_chunked_plain_propose_bit_identical_to_pallas_interpret(seed):
    _, jf, troots, tf, _ = _chunked_pair()
    tails, roots, budgets = _chunked_batch(seed, troots)
    tails, roots, budgets = tails[:6], roots[:6], budgets[:6]
    want = [np.asarray(x) for x in suffix_match_propose_kernel_chunked(
        jnp.asarray(tails), jnp.asarray(roots), jnp.asarray(budgets), *jf,
        n_prop_max=KMAX, min_match=1, interpret=True,
    )]
    got = [x.numpy() for x in tops.suffix_match_propose(
        tf, tails, roots, budgets, n_prop_max=KMAX, min_match=1,
    )]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)


def _drafters(cls_cfg, cls_drafter, docs, layout="auto"):
    d = cls_drafter(cls_cfg(scope="problem", min_match=1, window_size=3,
                            device_tail=TAIL, max_draft=KMAX,
                            forest_layout=layout))
    for e, (pid, toks) in enumerate(docs):
        d.observe_rollout(pid, toks, epoch=e)  # evicts beyond the window
        if e % 3 == 2:
            d.begin_iteration(e + 1)
    return d


@pytest.mark.parametrize("layout", ["flat", "chunked"])
def test_batched_sessions_equal_jax(layout):
    rng = np.random.default_rng(7)
    docs = [(f"p{i % 3}", [int(t) for t in rng.integers(0, 6, size=20)])
            for i in range(9)]
    jd = _drafters(JDrafterConfig, JSuffixDrafter, docs, layout)
    td = _drafters(DrafterConfig, SuffixDrafter, docs, layout)
    ctxs = [(f"p{b % 4}", [int(t) for t in rng.integers(0, 6, size=b + 2)])
            for b in range(6)]
    jb = jd.batched_sessions(len(ctxs))
    tb = td.batched_sessions(len(ctxs), tensor_device="cpu")
    assert jb.device and tb.device
    for row, (pid, ctx) in enumerate(ctxs):
        jb.open(row, pid, ctx)
        tb.open(row, pid, ctx)
    budgets = [4, 8, 2, 0, 6, 8]
    want = jb.propose_batch(budgets)
    assert tb.propose_batch(budgets) == want
    assert any(want)
    jb.feed(0, [3, 4])
    tb.feed(0, [3, 4])
    jb.close(1)
    tb.close(1)
    assert tb.propose_batch(budgets) == jb.propose_batch(budgets)
    np.testing.assert_array_equal(tb.roots_array(), jb.roots_array())
    want_type = tops.ChunkedForest if layout == "chunked" else tops.PackedForest
    assert isinstance(tb.forest_arrays(), want_type)


# ---- the CUDA kernels' edge search, modelled on the CPU ----------------
# csrc/suffix_match.cu finds a child with a 33-way lower-bound search: each
# round probes 32 evenly spaced entries of the live range as 64-bit
# (node, token) keys and keeps the sub-range the count of "key < query"
# picks; once at most 31 entries are left it probes them all. Rounds 1 and
# 2 read splitters staged once per table. The model below mirrors
# probe/narrow/stage_splitters/find_child statement for statement; it must
# return the child the plain version's binary search returns, which rests
# on the packed tables being non-decreasing in (node, token).

_INT_MAX = int(np.iinfo(np.int32).max)
_NSPLIT = 32 + 33 * 32


def _edge_key(node, tok):
    """The kernel's edge_key: (node, tok) as one signed 64-bit key."""
    v = ((int(node) & 0xFFFFFFFF) << 32) | ((int(tok) & 0xFFFFFFFF)
                                            ^ 0x80000000)
    return v - (1 << 64) if v >= 1 << 63 else v


def _probe(lo, hi, lane):
    s = hi - lo
    return lo + lane if s <= 31 else lo + (lane + 1) * s // 33


def _narrow(lo, hi, c):
    s = hi - lo
    return (lo + c * s // 33 + 1 if c > 0 else lo,
            lo + (c + 1) * s // 33 if c < 32 else hi)


def _table_entry(en, et, ec, p, lo, hi, with_child):
    if p <= hi and p < len(en):
        return (_edge_key(en[p], et[p]),
                int(ec[p]) if with_child else -1)
    return _edge_key(_INT_MAX, _INT_MAX), -1


def _splitters(en, et, ec):
    """The staged table, built as stage_splitters builds it: entry j of
    round 1, then entry 32 + 32 c + j of round 2 after c less-than probes
    in round 1; children only for entries of a last round."""
    table = []
    for e in range(_NSPLIT):
        lo, hi, lane = 0, len(en), e
        if e >= 32:
            lo, hi = _narrow(lo, hi, (e - 32) >> 5)
            lane = (e - 32) & 31
        table.append(_table_entry(en, et, ec, _probe(lo, hi, lane), lo, hi,
                                  hi - lo <= 31))
    return table


def _find_child_33(en, et, ec, table, node, tok):
    """find_child: (child or -1, rounds taken)."""
    q = _edge_key(node, tok)
    lo, hi = 0, len(en)
    for r in range(64):
        last = hi - lo <= 31
        if r < 2:  # staged: round 1's 32 entries, round 2's for outcome c
            base = 0 if r == 0 else 32 + 32 * c
            probes = table[base:base + 32]
        else:
            probes = [_table_entry(en, et, ec, _probe(lo, hi, lane), lo, hi,
                                   last) for lane in range(32)]
        c = sum(key < q for key, _ in probes)
        if last:  # the lower bound is lo + c, probed by lane c
            key, child = probes[c]
            return (child if key == q else -1), r + 1
        lo, hi = _narrow(lo, hi, c)
    raise AssertionError("the search did not end")


def _search_trees():
    """The TREES plus a larger seeded tree (thousands of edges)."""
    trees = [_mk(SuffixTree, **TREES[n]) for n in sorted(TREES)]
    trees.append(_mk(SuffixTree, _seeded_docs(13, 20, 50, 300), decay=0.9,
                     epochs=list(range(20))))
    return trees


# (layout, which trees, packing options): default sizes (three rounds),
# tables padded to 2^15 and 2^17 edges (sentinel pads; three and four
# rounds), small per-tree strides (round 2 is the last), a table of 16
# edges (round 1 is the last), a one-tree forest
SEARCH_CASES = {
    "flat": ("flat", "all", {}),
    "flat_32k": ("flat", "all", dict(min_edges=1 << 15)),
    "flat_128k": ("flat", "all", dict(min_edges=1 << 17)),
    "chunked": ("chunked", "all", {}),
    "chunked_small": ("chunked", "small", dict(min_stride_edges=16)),
    "chunked_tiny": ("chunked", "tiny", dict(min_stride_edges=16)),
    "one_tree": ("flat", "basic", {}),
}


def _search_tables(case):
    """Each edge table of the case's forest (one per tree row when
    chunked) as (edge_node, edge_tok, edge_child, node count)."""
    layout, which, kw = SEARCH_CASES[case]
    trees = _search_trees()
    if which == "small":
        trees = trees[:len(TREES)]
    elif which == "basic":
        trees = [trees[sorted(TREES).index("basic")]]
    elif which == "tiny":
        trees = [_mk(SuffixTree, [[1, 2, 1]])]
    packs = [t.pack() for t in trees]
    if layout == "flat":
        f, _ = tops.pack_forest(packs, device="cpu", **kw)
        rows = [(f.edge_node, f.edge_tok, f.edge_child, f.suffix_link)]
    else:
        f, _ = tops.pack_forest_chunked(packs, device="cpu", **kw)
        rows = list(zip(f.edge_node, f.edge_tok, f.edge_child,
                        f.suffix_link))
    return [(en.numpy(), et.numpy(), ec.numpy(), len(sl))
            for en, et, ec, sl in rows]


def _search_queries(en, et, n_nodes, rng):
    """Present keys, absent keys (a token past or before a present one,
    tok = -1), the first and last node ids and one past them, random
    nodes with random tokens."""
    real = np.flatnonzero(en != _INT_MAX)
    pick = rng.choice(real, size=min(len(real), 300), replace=False) \
        if len(real) else real
    q = [(en[j], et[j]) for j in pick]
    q += [(en[j], et[j] + 1) for j in pick[:100]]
    q += [(en[j], et[j] - 1) for j in pick[:100]]
    q += [(en[j], -1) for j in pick[:50]]
    top = int(en[real].max()) if len(real) else 0
    for node in (0, 1, top, top + 1, n_nodes - 1, n_nodes):
        q += [(node, -1), (node, 0)] + [(node, int(t)) for t in
                                       rng.integers(0, 60, size=8)]
    q += [(int(n), int(t)) for n, t in zip(rng.integers(0, n_nodes, 100),
                                           rng.integers(-1, 60, 100))]
    return q


@pytest.mark.parametrize("case", sorted(SEARCH_CASES))
def test_kernel_search_model_equals_plain_find_child(case):
    """The 33-way search with staged splitters returns the plain binary
    search's child for every query, within ceil(log33 E) + 1 rounds."""
    rng = np.random.default_rng(17)
    tables = _search_tables(case)
    found = 0
    for en, et, ec, n_nodes in tables:
        E = len(en)
        most = next(k for k in range(1, 64) if 33 ** k >= E) + 1
        table = _splitters(en, et, ec)
        queries = _search_queries(en, et, n_nodes, rng)
        node = torch.tensor([n for n, _ in queries], dtype=torch.int32)
        tok = torch.tensor([t for _, t in queries], dtype=torch.int32)
        want = _find_child(torch.from_numpy(en)[None],
                           torch.from_numpy(et)[None],
                           torch.from_numpy(ec)[None],
                           torch.zeros(len(queries), dtype=torch.long),
                           node, tok).tolist()
        for (n, t), w in zip(queries, want):
            got, rounds = _find_child_33(en, et, ec, table, n, t)
            assert got == w, (case, E, n, t)
            assert rounds <= most, (case, E, rounds)
            found += got >= 0
    assert found > 0  # the queries include present keys
    if case == "flat_128k":
        assert math.ceil(math.log(len(tables[0][0]), 33)) + 1 == 5


def _probe32(lo, hi, lane):
    """probe with its product in 32 bits (the kernels' search below
    WIDE_EDGES entries)."""
    s = hi - lo
    return lo + lane if s <= 31 else lo + ((lane + 1) * s & 0xFFFFFFFF) // 33


def _narrow32(lo, hi, c):
    s = hi - lo
    return (lo + (c * s & 0xFFFFFFFF) // 33 + 1 if c > 0 else lo,
            lo + ((c + 1) * s & 0xFFFFFFFF) // 33 if c < 32 else hi)


def _wide_edges():
    """WIDE_EDGES of csrc/suffix_match.cu: tables from this size on take
    the search with 64-bit index products."""
    src = (Path(tops.__file__).resolve().parents[2] / "csrc"
           / "suffix_match.cu").read_text()
    return 1 << int(re.search(r"WIDE_EDGES = 1 << (\d+);", src).group(1))


def _lower_bound_33(E, q, probe=_probe, narrow=_narrow):
    """The kernels' search over a virtual table whose entry j has key j
    (entries past hi or past the table key past every query): the index
    of the first key >= q, or None if the search does not end. A probe
    of the 64-bit search is an index below 2^32."""
    lo, hi = 0, E
    for _ in range(64):
        last = hi - lo <= 31
        ps = [probe(lo, hi, lane) for lane in range(32)]
        if probe is _probe:
            assert all(0 <= p < 1 << 32 for p in ps)
        c = sum((p if p <= hi and p < E else 1 << 40) < q for p in ps)
        if last:
            return lo + c
        lo, hi = narrow(lo, hi, c)
    return None


@pytest.mark.parametrize("E", [(1 << 26) - 1, 1 << 26, (1 << 26) + 33,
                               1 << 30, (1 << 31) - 1])
def test_kernel_search_arithmetic_at_int32_sizes(E):
    """The search with 64-bit index products (the kernels' instance for
    tables of WIDE_EDGES = 2^26 entries and more) finds the lower bound
    over live ranges up to 2^31 - 1 (index arithmetic only, no table).
    The 32-bit products of the other instance are exact below 2^26 and
    miss past 2^27."""
    assert _wide_edges() == 1 << 26
    rng = np.random.default_rng(E % 1000)
    queries = [0, 1, 31, 32, 33, E // 33, E // 2, E - 32, E - 31, E - 1, E]
    queries += [int(q) for q in rng.integers(0, E + 1, size=60)]
    for q in queries:
        assert _lower_bound_33(E, q) == q, (E, q)
    narrow32 = [_lower_bound_33(E, q, _probe32, _narrow32) for q in queries]
    if E < _wide_edges():
        assert narrow32 == queries
    if E >= 1 << 27:
        assert narrow32 != queries


@pytest.mark.parametrize("layout", ["flat", "chunked"])
@pytest.mark.parametrize("E", [1 << 26, (1 << 31) - 1])
def test_wrappers_take_edge_tables_of_any_int32_size(layout, E):
    """The CUDA wrappers' checks take edge tables of 2^26 entries and more
    (tensors on the meta device: no memory; the kernels search them with
    64-bit products), so the drafter's ``auto`` layout, flat in the
    port, has no size it must fall back from."""
    def t(*shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")

    if layout == "flat":
        forest = tops.PackedForest(t(E), t(E), t(E), *(t(1024),) * 5, t(2048))
    else:
        forest = tops.ChunkedForest(t(2, E), t(2, E), t(2, E),
                                    *(t(2, 1024),) * 5, t(2, 2048))
    tails, roots, budgets = t(8, 64), t(8), t(8)
    tops._check(forest, tails, roots, budgets, 16)
    d = SuffixDrafter(DrafterConfig(scope="problem"))
    assert d.cfg.forest_layout == "auto"
    assert d.batched_sessions(2, tensor_device="cpu")._pick_layout([]) == "flat"


@pytest.mark.parametrize("layout", ["flat", "chunked"])
@pytest.mark.parametrize("pad", [{}, "large"])
def test_packed_edge_tables_are_sorted(layout, pad):
    """pack_forest / pack_forest_chunked give edge tables non-decreasing in
    (node, token), sentinel pads included (row by row when chunked): the
    precondition for the kernels' search and the binary search to find
    the same lower bound."""
    packs = [t.pack() for t in _search_trees()]
    if layout == "flat":
        kw = dict(min_edges=1 << 15) if pad else {}
        f, _ = tops.pack_forest(packs, device="cpu", **kw)
        rows = [(f.edge_node.numpy(), f.edge_tok.numpy())]
    else:
        kw = dict(min_stride_edges=1 << 14, min_trees=8) if pad else {}
        f, _ = tops.pack_forest_chunked(packs, device="cpu", **kw)
        rows = list(zip(f.edge_node.numpy(), f.edge_tok.numpy()))
    for en, et in rows:
        key = en.astype(np.int64) * (1 << 32) + (et.astype(np.int64)
                                                 + (1 << 31))
        assert (np.diff(key) >= 0).all()
        assert (en[-1], et[-1]) == (_INT_MAX, _INT_MAX)  # a sentinel pad
        # the 64-bit key of the kernel orders as (node, token) does
        sample = np.linspace(0, len(en) - 1, 64).astype(int)
        k64 = [_edge_key(en[j], et[j]) for j in sample]
        assert k64 == sorted(k64)


def test_batched_sessions_default_to_the_card(monkeypatch):
    """Without a device the drafter's forest asks for CUDA, and raises
    without a card: nothing quietly runs the plain version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = SuffixDrafter(DrafterConfig(scope="problem"))
    d.observe_rollout("p", [1, 2, 3, 4], 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        d.batched_sessions(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tops.pack_forest([d.pack_for("p")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tops.pack_forest_chunked([d.pack_for("p")])


@pytest.mark.gpu
def test_cuda_kernel_bit_identical_to_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    pairs = [_pair(n) for n in sorted(TREES)]
    tf, troots = tops.pack_forest([t.pack() for _, t in pairs], device="cuda")
    tails, roots, budgets = _batch(3, 64, 8, troots)
    up = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    args = (up(tails), up(roots), up(budgets))
    got = tops.suffix_match_propose_cuda(tf, *args, n_prop_max=KMAX, min_match=1)
    want = suffix_match_propose_ref(*args, *tf, n_prop_max=KMAX, min_match=1)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_cuda_chunked_kernel_bit_identical_to_plain_and_flat():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    pairs = [_pair(n) for n in sorted(TREES)]
    packs = [t.pack() for _, t in pairs]
    cf, troots = tops.pack_forest_chunked(packs, device="cuda")
    ff, froots = tops.pack_forest(packs, device="cuda")
    tails, roots, budgets = _batch(3, 64, 8, troots)
    up = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    args = (up(tails), up(roots), up(budgets))
    got = tops.suffix_match_propose_chunked_cuda(cf, *args, n_prop_max=KMAX,
                                                 min_match=1)
    want = suffix_match_propose_chunked_ref(*args, *cf, n_prop_max=KMAX,
                                            min_match=1)
    flat_roots = np.where(roots >= 0, froots[np.maximum(roots, 0)], -1)
    flat = tops.suffix_match_propose_cuda(
        ff, args[0], up(flat_roots.astype(np.int32)), args[2],
        n_prop_max=KMAX, min_match=1)
    torch.cuda.synchronize()
    for g, w, f in zip(got, want, flat):
        assert torch.equal(g, w) and torch.equal(g, f)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["flat", "chunked"])
def test_cuda_kernels_at_odd_shapes(layout):
    """Rows that fill no whole CTA of the flat kernel (B = 13), a CTA with
    no active row, a tail of 37 tokens, proposals past 32 (a lane-wide run
    and then some): bit-identical to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    packs = [t.pack() for t in _search_trees()]
    docs = _seeded_docs(13, 20, 50, 300)  # the last tree's documents
    B, m, K = 13, 37, 40
    rng = np.random.default_rng(21)
    tails = np.full((B, m), -1, np.int32)
    for b in range(B):
        doc = docs[b % len(docs)]
        cut = int(rng.integers(1, len(doc) + 1))
        tail = doc[max(0, cut - m):cut]
        tails[b, m - len(tail):] = tail
    budgets = np.full(B, K, np.int32)
    budgets[5] = 33
    if layout == "flat":
        forest, roots = tops.pack_forest(packs, device="cuda")
        run, ref = tops.suffix_match_propose_cuda, suffix_match_propose_ref
    else:
        forest, roots = tops.pack_forest_chunked(packs, device="cuda")
        run = tops.suffix_match_propose_chunked_cuda
        ref = suffix_match_propose_chunked_ref
    rts = np.full(B, roots[-1], np.int32)
    rts[:4] = -1  # the flat kernel's first CTA has no active row
    args = [torch.from_numpy(a).cuda() for a in (tails, rts, budgets)]
    for min_match in (1, 4):
        got = run(forest, *args, n_prop_max=K, min_match=min_match)
        want = ref(*args, *forest, n_prop_max=K, min_match=min_match)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert int(got[1].max()) > 32
