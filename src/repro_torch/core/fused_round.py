"""Fused device-resident verify rounds (draft → verify → accept in one
round function over device tensors) — the port's counterpart of
``repro.core.fused_round``, with its R-round micro-loop (``fused_micro``).

One round:

    propose (a suffix_match kernel over the packed forest, flat or chunked)
      → build the (B, K+1) verify block on the device
      → model forward (spec_verify kernel per layer) + ``verify_block``
      → cache commit (ring-slot overwrite; staged recurrent gather; in
        place)
      → EOS/limit emit scan
      → next-round session state (head, context tails, emitted, active)

The per-row session state (``RoundState``) stays on the device between
rounds. The host uploads one (B,) budget vector per round and downloads
one packed (B, K+5) result: ``[cand tokens | accepted | n_take | alive |
n_prop]``. Where the reference donates the cache and state buffers to its
jitted round, the port updates them in place.

The micro-loop (``fused_micro``, R > 1; lock-step ``generate``) enqueues
R rounds per dispatch with no host read between them. PyTorch eager has
no device-side ``while``, so the reference's early exit becomes a device
flag: round i acts only while ``go`` holds (some row active, no row's
``active`` changed since the dispatch began, i < R), and a round past the
exit runs its kernels over no row and changes nothing. The host downloads
the (R, B, K+5) rounds and the live count ``n_done`` in one transfer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.verify import VerifyResult, verify_block
from repro_torch.kernels.suffix_match import ops as sm_ops
from repro_torch.models import model as M


@dataclass
class RoundState:
    """Device-resident per-slot session state carried across rounds."""

    head: torch.Tensor  # (B,) i32 last emitted-but-unverified token
    tails: torch.Tensor  # (B, m) i32 context tails, -1 = left pad/reset
    active: torch.Tensor  # (B,) bool
    emitted: torch.Tensor  # (B,) i32 tokens emitted so far
    max_new: torch.Tensor  # (B,) i32 per-row token limit


def make_state(head, tails, active, emitted, max_new, device) -> RoundState:
    """Build a device ``RoundState`` from host arrays (one-time upload;
    afterwards the state only lives on the device)."""
    def up(a, dt):  # always a copy: on the CPU `.to` would alias the host array
        return torch.tensor(np.asarray(a, dt), device=device)

    return RoundState(
        head=up(head, np.int32), tails=up(tails, np.int32),
        active=up(active, bool), emitted=up(emitted, np.int32),
        max_new=up(max_new, np.int32),
    )


def verify_step(
    params, cfg, cache: M.Cache, block, budgets, active, *,
    temperature: float, generator: Optional[torch.Generator] = None,
) -> Tuple[VerifyResult, M.Cache]:
    """One verify forward + acceptance + cache commit, shared by the
    unfused loop and the fused round. The attention caches commit by the
    ring-slot overwrite inside the forward; recurrent layers (a model
    with RG-LRU blocks) emit staged per-step states in the same single
    pass, gathered at ``n_commit`` into ``cache`` afterwards.
    ``cache.lengths`` advances in place by ``1 + accepted`` on active
    rows. Every update lands in the tensors of ``cache``, which is
    returned."""
    recurrent = M.has_recurrent(cfg)
    valid = active[:, None].expand(block.shape)
    logits, staged = M.forward(params, cfg, block, cache=cache, valid=valid,
                               collect_states=recurrent)
    logits = logits[:, :, : cfg.vocab_size]
    res = verify_block(
        logits, block, budgets, temperature=temperature, active=active,
        generator=generator,
    )
    n_commit = torch.where(active, 1 + res.accepted, 0)
    if recurrent:
        M.commit_staged_cache(cfg, cache, staged, n_commit)
    cache.lengths += n_commit.to(torch.int32)
    return res, cache


def emit_scan_device(
    cand: torch.Tensor,  # (B, K+1) candidate emissions per row
    n_new: torch.Tensor,  # (B,) accepted + 1
    remaining: torch.Tensor,  # (B,) max_new - emitted before this round
    eos: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Append-then-check EOS/limit scan on the device (twin of
    ``spec_engine._emit_scan``). Returns (n_take int32, alive bool)."""
    B, K1 = cand.shape
    idx = torch.arange(K1, device=cand.device)[None, :]
    valid = idx < n_new[:, None]
    eos_hit = (cand == eos) & valid
    has_eos = eos_hit.any(dim=1)
    first_eos = torch.where(has_eos, eos_hit.to(torch.int32).argmax(dim=1), K1)
    cap = remaining.clamp(min=1)  # append-then-check: >=1 lands
    n_take = torch.minimum(torch.minimum(n_new, cap),
                           torch.where(has_eos, first_eos + 1, K1 + 1))
    last = cand.gather(1, (n_take - 1).clamp(min=0)[:, None].long())[:, 0]
    alive = (n_take == n_new) & (last != eos) & (n_take < remaining)
    return n_take.to(torch.int32), alive


def fused_round(
    params, cfg, forest, cache: M.Cache,
    state: RoundState, roots: torch.Tensor, budgets: torch.Tensor, *,
    K: int, temperature: float, eos_token: int, min_match: int,
    generator: Optional[torch.Generator] = None,
    go: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One fused round over device tensors: propose → verify → commit →
    state. ``forest`` is a ``PackedForest`` (roots are node ids) or a
    ``ChunkedForest`` (roots are tree ordinals); ``propose_device``
    routes on its type. ``cache`` and ``state`` are updated in place. Returns ``out``
    (B, K+5) int32 = ``[cand (K+1) | accepted | n_take | alive | n_prop]``;
    the round acts on the rows of ``state.active`` (ANDed with the 0-d
    bool ``go`` when given): the others carry zeros in the bookkeeping
    columns and leave cache and state untouched (the attention ring's
    trash slot, which nothing reads, takes their block's K/V)."""
    B, m = state.tails.shape
    dev = state.tails.device
    i32 = torch.int32
    active = state.active.clone() if go is None else state.active & go
    if K > 0:
        # Rows without a packed tree (root < 0) or without budget propose
        # nothing and take a plain AR step — as in the unfused path.
        proots = torch.where(active & (budgets > 0), roots, -1).to(i32)
        _, n_prop, props = sm_ops.propose_device(
            forest, state.tails, proots, budgets,
            n_prop_max=K, min_match=min_match,
        )
        drafts = torch.where(
            torch.arange(K, device=dev)[None, :] < n_prop[:, None], props, 0
        ).to(i32)
    else:
        n_prop = torch.zeros(B, dtype=i32, device=dev)
        drafts = torch.zeros((B, 0), dtype=i32, device=dev)
    block = torch.cat([state.head[:, None], drafts], dim=1)
    res, cache = verify_step(
        params, cfg, cache, block, n_prop, active,
        temperature=temperature, generator=generator,
    )
    accepted = res.accepted
    next_tok = res.next_token
    cand = torch.cat([block[:, 1:], torch.zeros((B, 1), dtype=i32, device=dev)],
                     dim=1)
    cand[torch.arange(B, device=dev), accepted.long()] = next_tok
    n_take, alive = emit_scan_device(
        cand, accepted + 1, state.max_new - state.emitted, eos_token
    )
    alive = alive & active
    n_take_eff = torch.where(active, n_take, 0).to(i32)
    # Context-tail shift register: the last m of (tail ++ taken tokens).
    comb = torch.cat([state.tails, cand], dim=1)
    idx = n_take_eff[:, None] + torch.arange(m, device=dev)[None, :]
    fed_tails = comb.gather(1, idx.long())
    state.head.copy_(torch.where(alive, next_tok, state.head))
    state.tails.copy_(torch.where(alive[:, None], fed_tails, state.tails))
    state.active.copy_(torch.where(active, alive, state.active))
    state.emitted += n_take_eff
    return torch.cat(
        [
            cand,
            accepted[:, None],
            n_take_eff[:, None],
            alive.to(i32)[:, None],
            torch.where(active, n_prop, 0).to(i32)[:, None],
        ],
        dim=1,
    )


def fused_micro(
    params, cfg, forest, cache: M.Cache,
    state: RoundState, roots: torch.Tensor, budgets: torch.Tensor, *,
    R: int, K: int, temperature: float, eos_token: int, min_match: int,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Up to R fused rounds in one dispatch, the counterpart of the
    reference's ``fused_micro`` (``lax.while_loop``): round i runs while
    some row is active, no row's ``active`` changed since the dispatch
    began, and i < R; each round re-clamps the host's budgets to the
    rows' remaining tokens, ``min(budgets, max(max_new - emitted - 1,
    0))``. All R rounds are enqueued with no host read between them: a
    device flag ``go`` gates the rows each round acts on, so a round past
    the exit launches its kernels over no row and changes nothing.

    Returns one int32 tensor on the device: the R rounds' (B, K+5)
    results, flattened, then ``n_done``, the rounds that ran (rows past
    ``n_done`` are the dead rounds' and carry zeros in the bookkeeping
    columns) — the host reads both in one transfer (``unpack_micro_out``).

    At T > 0 every round draws from ``generator`` what an R = 1 round of
    the same K draws, in the same order (``verify_block``'s (B, K)
    uniforms, then its (B, V) Gumbel noise), live or not: a dispatch
    draws R rounds' worth, so the same seed gives the same tokens from
    run to run, but not the R = 1 stream (the reference folds the round
    index into its key instead)."""
    kw = dict(K=K, temperature=temperature, eos_token=eos_token,
              min_match=min_match, generator=generator)
    if R == 1:
        out = fused_round(params, cfg, forest, cache, state, roots, budgets,
                          **kw)
        one = torch.ones(1, dtype=torch.int32, device=out.device)
        return torch.cat([out.reshape(-1), one])
    active0 = state.active.clone()
    go = active0.any()
    n_done = torch.zeros((), dtype=torch.int32, device=active0.device)
    outs = []
    for _ in range(R):
        b_i = torch.minimum(
            budgets, (state.max_new - state.emitted - 1).clamp(min=0))
        outs.append(fused_round(params, cfg, forest, cache, state, roots,
                                b_i, go=go, **kw))
        n_done += go.to(torch.int32)
        go = go & state.active.any() & (state.active == active0).all()
    return torch.cat([torch.stack(outs).reshape(-1), n_done.reshape(1)])


def unpack_micro_out(flat: np.ndarray, R: int, B: int, K: int):
    """(outs (R, B, K+5), n_done) from ``fused_micro``'s download."""
    return flat[:-1].reshape(R, B, K + 5), int(flat[-1])


def unpack_round_out(out_row: np.ndarray, K: int):
    """Split one (B, K+5) host round row into its columns:
    (cand, accepted, n_take, alive, n_prop)."""
    K1 = K + 1
    return (
        out_row[:, :K1],
        out_row[:, K1].astype(np.int64),
        out_row[:, K1 + 1].astype(np.int64),
        out_row[:, K1 + 2].astype(bool),
        out_row[:, K1 + 3].astype(np.int64),
    )
