"""Plain PyTorch version of the suffix-match drafting kernels (the port's
twin of ``repro.kernels.suffix_match.ref`` and of the chunked-layout
reference ``repro.kernels.suffix_match.ops._propose_chunked_ref``).

The reference vmaps its scalar core (``match_propose_row``) over rows;
this is the same core written batched: every row steps together through
the two flat loops (feed, then propose), each step a ``torch.where`` over
the rows, and rows whose loop has ended keep their state — exactly what
a vmapped ``while_loop`` does. Same state machine, same clamps, so the
results are bit-identical to the reference and to
``csrc/suffix_match.cu``.

One core serves both forest layouts: it reads every forest array as
``(T, X)`` through a per-row tree index. The flat layout is the case
``T = 1`` (every row reads tree 0, roots are node ids); the chunked layout
gives each row its own tree (tree-local indices, root 0), as the TPU's
chunked kernel streams one tree per row.

The CPU tests and the engine on the CPU run this; ``chip_smoke.py``
holds the kernels against it. Nothing on the card path calls it.
"""

from __future__ import annotations

import torch

_FEED = 0  # consume the next tail token / walk the continuation
_DESC = 1  # mid suffix-link re-descent (one segment a step)


def n_search_steps(E: int) -> int:
    """Unrolled binary-search depth over an E-entry edge table."""
    return max(int(E - 1).bit_length(), 1) + 1


def _find_child(en, et, ec, tree, node, tok):
    """Child of ``node`` whose edge starts with ``tok`` (-1 if none):
    lower-bound binary search on row ``tree`` of the sorted (node, token)
    edge tables ``(T, E)``."""
    E = en.shape[1]
    lo = torch.zeros_like(node)
    hi = torch.full_like(node, E)
    for _ in range(n_search_steps(E)):
        mid = (lo + hi) // 2
        mid_c = mid.clamp(max=E - 1).long()
        e_n, e_t = en[tree, mid_c], et[tree, mid_c]
        less = (e_n < node) | ((e_n == node) & (e_t < tok))
        upd = lo < hi
        lo, hi = (torch.where(upd & less, mid + 1, lo),
                  torch.where(upd & ~less, mid, hi))
    lo_c = lo.clamp(max=E - 1).long()
    found = (lo < E) & (en[tree, lo_c] == node) & (et[tree, lo_c] == tok)
    return torch.where(found, ec[tree, lo_c], -1)


def suffix_match_propose_ref(
    tails: torch.Tensor,  # (B, m) int32, -1 = padding/reset
    roots: torch.Tensor,  # (B,) int32 root node, < 0 = inactive row
    budgets: torch.Tensor,  # (B,) int32
    edge_node, edge_tok, edge_child,  # (E,) sorted (node, token) -> child
    suffix_link, edge_start, edge_len, first_tok, best_child,  # (N,)
    corpus,  # (C,) packed tokens, separators = -1
    *,
    n_prop_max: int,
    min_match: int,
):
    """Flat layout: every row walks the one concatenated forest.
    Returns (match_len (B,), n_prop (B,), props (B, n_prop_max)), all
    int32."""
    forest = tuple(a[None] for a in (
        edge_node, edge_tok, edge_child, suffix_link, edge_start, edge_len,
        first_tok, best_child, corpus))
    tree = torch.zeros(tails.shape[0], dtype=torch.long, device=tails.device)
    return _propose_rows(tails, tree, roots, budgets, forest,
                         n_prop_max=n_prop_max, min_match=min_match)


def suffix_match_propose_chunked_ref(
    tails: torch.Tensor,  # (B, m) int32, -1 = padding/reset
    roots: torch.Tensor,  # (B,) int32 tree ordinal, < 0 = inactive row
    budgets: torch.Tensor,  # (B,) int32
    edge_node, edge_tok, edge_child,  # (T, Es) per-tree edge tables
    suffix_link, edge_start, edge_len, first_tok, best_child,  # (T, Ns)
    corpus,  # (T, Cs)
    *,
    n_prop_max: int,
    min_match: int,
):
    """Chunked layout: row b walks tree ``roots[b]`` with tree-local
    indices from root 0; inactive rows clamp to tree 0 with root -1 (as
    ``_propose_chunked_ref`` does). The binary search runs
    ``n_search_steps(Es)`` steps over the row's own edge table."""
    T = edge_node.shape[0]
    roots = roots.to(torch.int32)
    tree = roots.clamp(0, T - 1).long()
    root_local = torch.where(roots >= 0, 0, -1).to(torch.int32)
    forest = (edge_node, edge_tok, edge_child, suffix_link, edge_start,
              edge_len, first_tok, best_child, corpus)
    return _propose_rows(tails, tree, root_local, budgets, forest,
                         n_prop_max=n_prop_max, min_match=min_match)


def _propose_rows(tails, tree, roots, budgets, forest, *, n_prop_max,
                  min_match):
    """The batched row core over ``(T, X)`` forest arrays; row b reads
    row ``tree[b]`` of each array, from root node ``roots[b]``."""
    en, et, ec, sl, es, el, ft, bc, corpus = forest
    B, m = tails.shape
    C = corpus.shape[1]
    dev = tails.device
    i32 = torch.int32
    rows = torch.arange(B, device=dev)
    roots = roots.to(i32)
    active = roots >= 0
    root_s = roots.clamp(min=0)
    budget = budgets.to(i32).clamp(max=n_prop_max)

    def g(arr, idx):
        return arr[tree, idx.long()]

    def z():
        return torch.zeros(B, dtype=i32, device=dev)

    # ---- streaming longest-suffix match (matching statistics) --------
    i = torch.where(active, 0, m).to(i32)
    node, child, epos, mlen = root_s.clone(), z() - 1, z(), z()
    mode, dnode, dpos, drem = z() + _FEED, root_s.clone(), z(), z()
    while True:
        run = (i < m) | (mode == _DESC)
        if not bool(run.any()):
            break
        in_desc = mode == _DESC
        t = tails[rows, i.clamp(max=m - 1).long()].to(i32)
        q_node = torch.where(in_desc, dnode, node)
        q_tok = torch.where(in_desc, g(corpus, dpos.clamp(max=C - 1)), t)
        c_found = _find_child(en, et, ec, tree, q_node, q_tok)
        c_s = c_found.clamp(min=0)
        # -- descent micro-step
        d_end = drem == 0
        ell = g(el, c_s)
        d_full = ~d_end & (drem >= ell)
        desc_node = torch.where(d_end, dnode, torch.where(d_full, node, dnode))
        desc_child = torch.where(d_end | d_full, -1, c_s)
        desc_epos = torch.where(d_end | d_full, 0, drem)
        desc_mode = torch.where(d_full, _DESC, _FEED)
        desc_dnode = torch.where(d_full, c_s, dnode)
        desc_dpos = dpos + torch.where(d_full, ell, 0)
        desc_drem = drem - torch.where(d_full, ell, 0)
        # -- feed micro-step
        is_reset = t < 0
        on_edge = child >= 0
        ch_s = child.clamp(min=0)
        es_ch = g(es, ch_s)
        tok_edge = g(corpus, (es_ch + epos).clamp(max=C - 1))
        step_ok = torch.where(on_edge, tok_edge == t, c_found >= 0)
        new_child = torch.where(on_edge, child, c_found)
        new_epos = torch.where(on_edge, epos + 1, 1)
        full = new_epos == g(el, new_child.clamp(min=0))
        s_node = torch.where(full, new_child.clamp(min=0), node)
        s_child = torch.where(full, -1, new_child)
        s_epos = torch.where(full, 0, new_epos)
        dead = mlen == 0
        hop = ~is_reset & ~step_ok & ~dead
        shift = (on_edge & (node == root_s)).to(i32)
        feed_node = torch.where(is_reset, root_s, torch.where(step_ok, s_node, node))
        feed_child = torch.where(is_reset, -1, torch.where(step_ok, s_child, child))
        feed_epos = torch.where(is_reset, 0, torch.where(step_ok, s_epos, epos))
        feed_mlen = torch.where(
            is_reset, 0,
            torch.where(step_ok, mlen + 1, torch.where(dead, mlen, mlen - 1)),
        )
        feed_i = i + (is_reset | step_ok | dead).to(i32)
        feed_mode = torch.where(hop, _DESC, _FEED)
        feed_dnode = g(sl, node)
        feed_dpos = es_ch + shift
        feed_drem = torch.where(on_edge, epos - shift, 0)
        # -- merge (rows whose loop ended keep their state)
        new = (
            torch.where(in_desc, i, feed_i),
            torch.where(in_desc, desc_node, feed_node),
            torch.where(in_desc, desc_child, feed_child),
            torch.where(in_desc, desc_epos, feed_epos),
            torch.where(in_desc, mlen, feed_mlen),
            torch.where(in_desc, desc_mode, feed_mode),
            torch.where(in_desc, desc_dnode, feed_dnode),
            torch.where(in_desc, desc_dpos, feed_dpos),
            torch.where(in_desc, desc_drem, feed_drem),
        )
        old = (i, node, child, epos, mlen, mode, dnode, dpos, drem)
        i, node, child, epos, mlen, mode, dnode, dpos, drem = (
            torch.where(run, n, o).to(i32) for n, o in zip(new, old)
        )

    # ---- greedy continuation walk with shorter-suffix fallback -------
    minm = max(int(min_match), 1)
    props = torch.full((B, n_prop_max), -1, dtype=i32, device=dev)
    done = ~active | (budget <= 0) | (mlen < minm)
    wn, wc, we, k, pmlen = node, child, epos, z(), mlen
    mode, dnode, dpos, drem = z() + _FEED, root_s.clone(), z(), z()
    while True:
        run = ~done
        if not bool(run.any()):
            break
        in_desc = mode == _DESC
        c_found = _find_child(
            en, et, ec, tree, torch.where(in_desc, dnode, 0),
            g(corpus, dpos.clamp(max=C - 1)),
        )
        c_s = c_found.clamp(min=0)
        # -- descent micro-step
        d_end = drem == 0
        ell = g(el, c_s)
        d_full = ~d_end & (drem >= ell)
        desc_wn = torch.where(d_end, dnode, torch.where(d_full, wn, dnode))
        desc_wc = torch.where(d_end | d_full, -1, c_s)
        desc_we = torch.where(d_end | d_full, 0, drem)
        desc_mode = torch.where(d_full, _DESC, _FEED)
        desc_dnode = torch.where(d_full, c_s, dnode)
        desc_dpos = dpos + torch.where(d_full, ell, 0)
        desc_drem = drem - torch.where(d_full, ell, 0)
        # -- walk micro-step
        hit = k >= budget
        on_edge = wc >= 0
        wc_s = wc.clamp(min=0)
        at_end = on_edge & (we == g(el, wc_s))
        es_wc = g(es, wc_s)
        tok_e = g(corpus, (es_wc + we).clamp(max=C - 1))
        bcx = g(bc, wn)
        tok = torch.where(on_edge, tok_e, g(ft, bcx.clamp(min=0)))
        brk = (on_edge & ~at_end & (tok_e < 0)) | (~on_edge & (bcx < 0))
        stop = hit | brk
        succeed = stop & (k > 0)
        pml2 = pmlen - 1
        give_up = stop & (k == 0) & (pml2 < minm)
        hop = stop & (k == 0) & ~give_up
        norm = ~stop & at_end
        emit = ~stop & ~norm
        shift = (on_edge & (wn == root_s)).to(i32)
        k_c = k.clamp(max=n_prop_max - 1).long()[:, None]
        cur = props.gather(1, k_c)[:, 0]
        props2 = props.scatter(1, k_c, torch.where(emit, tok, cur)[:, None])
        walk_wn = torch.where(norm, wc_s, wn)
        walk_wc = torch.where(
            norm, -1, torch.where(emit & ~on_edge, bcx.clamp(min=0), wc)
        )
        walk_we = torch.where(
            norm, 0, torch.where(emit, torch.where(on_edge, we + 1, 1), we)
        )
        walk_mode = torch.where(hop, _DESC, _FEED)
        walk_dnode = torch.where(hop, g(sl, wn), dnode)
        walk_dpos = torch.where(hop, es_wc + shift, dpos)
        walk_drem = torch.where(hop, torch.where(on_edge, we - shift, 0), drem)
        walk_pmlen = torch.where(hop | give_up, pml2, pmlen)
        walk_done = succeed | give_up
        # -- merge (rows whose loop ended keep their state)
        new = (
            torch.where(in_desc, desc_wn, walk_wn),
            torch.where(in_desc, desc_wc, walk_wc),
            torch.where(in_desc, desc_we, walk_we),
            k + (~in_desc & emit).to(i32),
            torch.where(in_desc, pmlen, walk_pmlen),
            torch.where(in_desc, desc_mode, walk_mode),
            torch.where(in_desc, desc_dnode, walk_dnode),
            torch.where(in_desc, desc_dpos, walk_dpos),
            torch.where(in_desc, desc_drem, walk_drem),
        )
        old = (wn, wc, we, k, pmlen, mode, dnode, dpos, drem)
        wn, wc, we, k, pmlen, mode, dnode, dpos, drem = (
            torch.where(run, n, o).to(i32) for n, o in zip(new, old)
        )
        props = torch.where((run & ~in_desc)[:, None], props2, props)
        done = torch.where(run, ~in_desc & walk_done, done)

    match_len = torch.where(active, mlen, 0).to(i32)
    n_prop = torch.where(active, k, 0).to(i32)
    props = torch.where(active[:, None], props, -1).to(i32)
    return match_len, n_prop, props
