"""Fused device-resident verify rounds (draft → verify → accept in one
round function over device tensors) — the port's counterpart of
``repro.core.fused_round`` (R = 1; the R-round micro-loop is not ported
yet).

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
) -> torch.Tensor:
    """One fused round over device tensors: propose → verify → commit →
    state. ``forest`` is a ``PackedForest`` (roots are node ids) or a
    ``ChunkedForest`` (roots are tree ordinals); ``propose_device``
    routes on its type. ``cache`` and ``state`` are updated in place. Returns ``out``
    (B, K+5) int32 = ``[cand (K+1) | accepted | n_take | alive | n_prop]``;
    rows outside ``state.active`` carry zeros in the bookkeeping columns
    and leave cache/state untouched."""
    B, m = state.tails.shape
    dev = state.tails.device
    i32 = torch.int32
    active = state.active.clone()
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
    state.active.copy_(alive)
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
