"""Speculative-decoding rollout engine (paper Fig. 3), lock-step mode —
the port's counterpart of ``repro.core.spec_engine``.

Host side: the length-aware budget policy (length_policy.py + budget.py),
per-request output assembly and rollout statistics. Device side, in the
default **fused** mode (``EngineConfig.fuse_rounds``,
core/fused_round.py), the whole steady-state round: suffix-match propose
over the packed forest, verify-block assembly, model forward +
acceptance, cache commit, EOS/limit emit scan and the next round's
session state. The host uploads one (B,) budget vector per round and
downloads one packed per-row result. The unfused loop
(``fuse_rounds="off"``, or host per-row sessions for the
``problem+request`` scope / ``device_draft="off"``) keeps the split
steps: one batched draft-proposal call, host block assembly, one verify
call, host emit scan.

The verify block is padded to a bucketed size (``block_buckets``); per-row
budgets stay ragged (positions past a row's budget are auto-rejected).
Greedy (T=0) verification is lossless: outputs are token-identical to
plain autoregressive decoding.

Not ported yet: continuous batching (``serve``/``generate_continuous``),
the R-round micro-loop, telemetry, the flight recorder, the journal and
the watchdog.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.budget import LatencyModel, solve_budgets
from repro_torch.core.drafter import DrafterConfig, SuffixDrafter
from repro_torch.core.fused_round import (
    fused_round,
    make_state,
    unpack_round_out,
    verify_step,
)
from repro_torch.core.length_policy import LengthPolicy
from repro_torch.core.verify import sample_token
from repro_torch.models import model as M


@dataclass
class EngineConfig:
    max_draft: int = 16  # hard cap K on draft tokens per round
    block_buckets: Tuple[int, ...] = (0, 4, 8, 16)  # draft block sizes
    temperature: float = 0.0
    max_new_tokens: int = 256
    eos_token: int = 1
    use_budget_solver: bool = True  # Eq. 7/9 budgets (vs class-only)
    spec_enabled: bool = True  # False = plain AR decode (baseline)
    unlimited_budget: bool = False  # ablation: always max_draft
    cache_headroom: int = 64
    # Batched device drafting (kernels/suffix_match): "auto" uses it
    # whenever the drafter scope supports it (problem / global);
    # "on"/"off" force it.
    device_draft: str = "auto"
    # Fused device-resident rounds (core/fused_round.py): "auto" fuses
    # whenever the batched device drafter is active; "off" keeps the
    # unfused loop; "on" forces fusion where the drafter supports it.
    fuse_rounds: str = "auto"
    # R-round device micro-loop: only R = 1 is ported.
    micro_rounds: int = 1

    def __post_init__(self) -> None:
        if self.device_draft not in ("auto", "on", "off"):
            raise ValueError(
                f"device_draft must be 'auto'|'on'|'off', "
                f"got {self.device_draft!r}"
            )
        if self.fuse_rounds not in ("auto", "on", "off"):
            raise ValueError(
                f"fuse_rounds must be 'auto'|'on'|'off', "
                f"got {self.fuse_rounds!r}"
            )
        if self.micro_rounds < 1:
            raise ValueError(
                f"micro_rounds must be >= 1, got {self.micro_rounds}"
            )
        if self.micro_rounds > 1:
            raise NotImplementedError(
                "micro_rounds > 1 (the R-round device micro-loop) is not "
                "ported yet"
            )


@dataclass
class RolloutStats:
    n_rounds: int = 0  # verify rounds
    n_fwd: int = 0  # forward passes (prefill + verify rounds)
    n_toks_proposed: int = 0  # Σ block tokens over active rows (ragged)
    n_toks_emitted: int = 0
    n_drafted: int = 0
    n_accepted: int = 0
    wall_time_s: float = 0.0
    # host milliseconds on per-round bookkeeping (device waits excluded)
    # and host<->device array crossings
    host_time_s: float = 0.0
    n_h2d: int = 0
    n_d2h: int = 0
    per_row_rounds: Optional[np.ndarray] = None
    per_row_emitted: Optional[np.ndarray] = None
    effective_batch: List[int] = field(default_factory=list)
    round_accepts: List[float] = field(default_factory=list)

    @property
    def acceptance_per_round(self) -> float:
        return self.n_accepted / max(self.n_rounds, 1)


def _emit_scan(
    cand: np.ndarray,  # (B, K+1) candidate emissions per row
    n_new: np.ndarray,  # (B,) accepted + 1
    remaining: np.ndarray,  # (B,) max_new - emitted before this round
    eos: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized EOS/token-limit scan (append-then-check semantics):
    each row appends its candidates in order, stopping after the first
    EOS or once the emitted count reaches the row's limit (the token that
    trips either condition is still appended). Returns (n_take, alive);
    rows outside the caller's active mask produce garbage."""
    B, K1 = cand.shape
    idx = np.arange(K1)[None, :]
    valid = idx < n_new[:, None]
    eos_hit = (cand == eos) & valid
    has_eos = eos_hit.any(axis=1)
    first_eos = np.where(has_eos, eos_hit.argmax(axis=1), K1)
    cap = np.maximum(remaining, 1)
    n_take = np.minimum(np.minimum(n_new, cap),
                        np.where(has_eos, first_eos + 1, K1 + 1))
    last = cand[np.arange(B), np.maximum(n_take - 1, 0)]
    alive = (n_take == n_new) & (last != eos) & (n_take < remaining)
    return n_take.astype(np.int64), alive


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _prompt_bucket(n: int) -> int:
    """Prompt pad width (16-multiples), as in the reference."""
    return max(16, _round_up(n, 16))


def _cache_bucket(n: int) -> int:
    """Cache length rounding (64-multiples), as in the reference."""
    return _round_up(n, 64)


def _as_max_new_array(mn, B: int) -> np.ndarray:
    if isinstance(mn, (list, tuple, np.ndarray)):
        arr = np.asarray(mn, np.int64)
        if arr.shape != (B,):
            raise ValueError(f"max_new_tokens shape {arr.shape} != ({B},)")
        return arr
    return np.full(B, int(mn), np.int64)


class SpecEngine:
    """Speculative rollout engine: draft → verify on ``device`` (CUDA
    unless the caller asks for the CPU)."""

    def __init__(
        self,
        params: M.Transformer,
        cfg: ModelConfig,
        engine: Optional[EngineConfig] = None,
        drafter: Optional[SuffixDrafter] = None,
        length_policy: Optional[LengthPolicy] = None,
        latency: Optional[LatencyModel] = None,
        device=None,
    ) -> None:
        self.device = resolve_device(device)
        if params.device != self.device:
            raise ValueError(
                f"params live on {params.device}, engine device is "
                f"{self.device}"
            )
        self.params = params
        self.cfg = cfg
        self.engine = engine or EngineConfig()
        self.drafter = drafter or SuffixDrafter(DrafterConfig())
        self.length_policy = length_policy or LengthPolicy()
        self.latency = latency or LatencyModel(c_base=1.0, c_tok=0.002)
        # Per-(problem, partial-length) budget memo keyed on the history
        # version (G samples per problem repeat the same posteriors).
        self._budget_memo: Dict[Tuple[Any, int], int] = {}
        self._pred_memo: Dict[Any, float] = {}
        self._memo_version = -1
        self.epoch = 0

    def _bucket(self, k: int) -> int:
        for b in self.engine.block_buckets:
            if k <= b:
                return b
        return self.engine.max_draft

    def _batched_sessions(self, n_rows: int):
        e = self.engine
        device = None if e.device_draft == "auto" else e.device_draft == "on"
        return self.drafter.batched_sessions(
            n_rows, device=device, tensor_device=self.device
        )

    def _fuse_enabled(self, bds) -> bool:
        """Fused rounds need the batched device drafter."""
        return bds.device and self.engine.fuse_rounds != "off"

    def _upload(self, arr, dtype) -> torch.Tensor:
        """Host array → new tensor on the engine's device (always a copy,
        so the host bookkeeping never aliases device state)."""
        return torch.tensor(np.asarray(arr, dtype), device=self.device)

    # -- budgets --------------------------------------------------------------
    def _round_budgets(
        self, problem_ids, emitted_lens, active, remaining
    ) -> np.ndarray:
        """Per-row draft budgets for one verify round: length-class budget
        per active row, refined by the Eq. 7/9 solver over the active rows
        once enough history exists; memoized on (problem, partial length)
        per history version."""
        e = self.engine
        B = len(problem_ids)
        budgets = np.zeros(B, np.int64)
        if not e.spec_enabled:
            return budgets
        active = np.asarray(active, bool)
        if e.unlimited_budget:
            return np.where(active, e.max_draft, 0)
        idx = np.nonzero(active)[0]
        if idx.size == 0:
            return budgets
        ver = self.length_policy.history_size()
        if ver != self._memo_version:
            self._memo_version = ver
            self._budget_memo.clear()
            self._pred_memo.clear()
        bm = self._budget_memo
        cls_budget = np.empty(idx.size, np.int64)
        for j, i in enumerate(idx):
            k = (problem_ids[i], int(emitted_lens[i]))
            v = bm.get(k)
            if v is None:
                v = bm[k] = int(self.length_policy.budget(k[0], k[1]))
            cls_budget[j] = v
        if e.use_budget_solver and ver >= 8:
            pm = self._pred_memo
            pred_rem = np.empty(idx.size, np.float64)
            for j, i in enumerate(idx):
                pid = problem_ids[i]
                el = pm.get(pid)
                if el is None:
                    el = pm[pid] = float(self.length_policy.expected_length(pid))
                pred_rem[j] = max(8.0, el - float(emitted_lens[i]))
            p_star, _ = solve_budgets(pred_rem, self.latency)
            per_round = np.ceil(
                p_star / np.maximum(pred_rem, 1.0) * e.max_draft
            ).astype(np.int64)
            solver_budget = np.where(p_star > 0, np.maximum(per_round, 1), 0)
            cls_budget = np.where(
                cls_budget > 0,
                np.minimum(cls_budget, np.maximum(solver_budget, 1)),
                0,
            )
        b = np.clip(cls_budget, 0, e.max_draft)
        b = np.minimum(b, np.maximum(np.asarray(remaining)[idx] - 1, 0))
        budgets[idx] = b
        return budgets

    # -- lock-step mode -------------------------------------------------------
    def generate(
        self,
        prompts: Sequence[Sequence[int]],
        problem_ids: Optional[Sequence] = None,
        *,
        max_new_tokens=None,
        generator: Optional[torch.Generator] = None,
        collect_effective_batch: bool = False,
    ) -> Tuple[List[List[int]], RolloutStats]:
        """Synchronous lock-step batched rollout with DAS speculation.

        ``max_new_tokens`` may be a scalar or a per-row sequence; at T > 0
        the draws come from ``generator`` (a ``torch.Generator`` on the
        engine's device; seed 0 when absent). Returns (generations per
        row, EOS-exclusive, stats)."""
        with torch.inference_mode():
            return self._generate(prompts, problem_ids, max_new_tokens,
                                  generator, collect_effective_batch)

    def _generate(self, prompts, problem_ids, max_new_tokens, generator,
                  collect_effective_batch):
        e = self.engine
        t0 = time.perf_counter()
        B = len(prompts)
        mn = max_new_tokens if max_new_tokens is not None else e.max_new_tokens
        max_new_arr = _as_max_new_array(mn, B)
        if problem_ids is None:
            problem_ids = list(range(B))
        if generator is None and e.temperature > 0:
            generator = torch.Generator(device=self.device).manual_seed(0)
        # ---- prefill (left-pad to a bucketed common length) ----
        Tp = _prompt_bucket(max(len(p) for p in prompts))
        toks = np.zeros((B, Tp), np.int32)
        mask = np.zeros((B, Tp), bool)
        for b, p in enumerate(prompts):
            toks[b, Tp - len(p):] = p
            mask[b, Tp - len(p):] = True
        max_len = _cache_bucket(
            Tp + int(max_new_arr.max(initial=0)) + e.max_draft + 2
        )
        last_logits, cache = M.prefill(
            self.params, self.cfg, self._upload(toks, np.int32),
            self._upload(mask, bool), max_len=max_len,
            headroom=e.cache_headroom,
        )
        head = sample_token(
            last_logits[:, : self.cfg.vocab_size],
            temperature=e.temperature, generator=generator,
        ).cpu().numpy().astype(np.int32)
        # ---- draft sessions (batched: one device propose per round) ----
        bds = self._batched_sessions(B)
        for b in range(B):
            bds.open(b, problem_ids[b], list(prompts[b]))
        outputs: List[List[int]] = [[] for _ in range(B)]
        active = np.ones(B, bool)
        emitted = np.zeros(B, np.int64)
        rounds_per_row = np.zeros(B, np.int64)
        stats = RolloutStats()
        # first sampled token counts as emitted output
        for b in range(B):
            tok = int(head[b])
            if tok == e.eos_token or max_new_arr[b] == 0:
                active[b] = False
                if max_new_arr[b] > 0:
                    outputs[b].append(tok)
            else:
                outputs[b].append(tok)
                emitted[b] = 1
                if max_new_arr[b] <= 1:  # head token already fills the limit
                    active[b] = False
                else:
                    bds.feed(b, [tok])
        stats.n_fwd += 1
        stats.n_toks_proposed += int(mask.sum())

        if self._fuse_enabled(bds):
            self._fused_generate_rounds(
                bds, cache, generator, problem_ids, outputs, active, emitted,
                max_new_arr, head, rounds_per_row, stats,
                collect_effective_batch,
            )
        else:
            self._unfused_generate_rounds(
                bds, cache, generator, problem_ids, outputs, active, emitted,
                max_new_arr, head, rounds_per_row, stats,
                collect_effective_batch,
            )
        stats.n_h2d += bds.xfers.pop("h2d", 0)
        stats.n_d2h += bds.xfers.pop("d2h", 0)
        # strip EOS and observe history
        for b in range(B):
            if outputs[b] and outputs[b][-1] == e.eos_token:
                outputs[b] = outputs[b][:-1]
            self.drafter.observe_rollout(
                problem_ids[b], list(prompts[b]) + outputs[b], self.epoch,
                response_len=len(outputs[b]),
            )
            self.length_policy.observe(problem_ids[b], len(outputs[b]))
        stats.n_toks_emitted = int(sum(len(o) for o in outputs))
        stats.per_row_rounds = rounds_per_row
        stats.per_row_emitted = np.array([len(o) for o in outputs])
        stats.wall_time_s = time.perf_counter() - t0
        return outputs, stats

    def _unfused_generate_rounds(
        self, bds, cache, generator, problem_ids, outputs, active, emitted,
        max_new_arr, head, rounds_per_row, stats, collect_effective_batch,
    ) -> None:
        """Round loop with split steps: batched propose, host block
        assembly, one verify dispatch, host emit scan."""
        e = self.engine
        B = len(outputs)
        while active.any():
            t_h = time.perf_counter()
            remaining = max_new_arr - emitted
            budgets_np = self._round_budgets(
                problem_ids, emitted, active, remaining
            )
            K = self._bucket(int(budgets_np.max()) if active.any() else 0)
            prop_handle = bds.dispatch(budgets_np)
            block = np.zeros((B, K + 1), np.int32)
            block[:, 0] = head
            props = bds.consume(prop_handle)
            for b in np.nonzero(active)[0]:
                prop = props[b]
                budgets_np[b] = len(prop)
                if prop:
                    block[b, 1: 1 + len(prop)] = prop
            block_dev = self._upload(block, np.int32)
            budgets_dev = self._upload(budgets_np, np.int32)
            active_dev = self._upload(active, bool)
            stats.host_time_s += time.perf_counter() - t_h
            stats.n_h2d += 3  # block + budgets + active uploads
            res, cache = verify_step(
                self.params, self.cfg, cache, block_dev, budgets_dev,
                active_dev, temperature=e.temperature, generator=generator,
            )
            accepted = res.accepted.cpu().numpy().astype(np.int64)
            next_tok = res.next_token.cpu().numpy().astype(np.int32)
            stats.n_d2h += 2
            # ---- host bookkeeping (vectorized EOS/emit scan) ----
            t_h = time.perf_counter()
            stats.n_rounds += 1
            stats.n_fwd += 1
            stats.n_toks_proposed += int((1 + budgets_np[active]).sum())
            stats.n_drafted += int(budgets_np[active].sum())
            stats.n_accepted += int(accepted[active].sum())
            stats.round_accepts.append(
                float(accepted[active].mean()) if active.any() else 0.0
            )
            if collect_effective_batch:
                stats.effective_batch.append(int(active.sum()))
            cand = np.zeros((B, K + 1), np.int32)
            cand[:, :K] = block[:, 1:]
            cand[np.arange(B), accepted] = next_tok
            n_take, alive = _emit_scan(
                cand, accepted + 1, max_new_arr - emitted, e.eos_token,
            )
            alive &= active
            for b in np.nonzero(active)[0]:
                rounds_per_row[b] += 1
                if budgets_np[b] > 0:  # per-prompt telemetry
                    self.drafter.note_draft(
                        problem_ids[b], int(budgets_np[b]), int(accepted[b]),
                    )
                take = cand[b, : n_take[b]].tolist()
                outputs[b].extend(take)
                if alive[b]:
                    bds.feed(b, take)
                else:
                    bds.close(b)
            emitted[active] += n_take[active]
            head[:] = np.where(alive, next_tok, head)
            active[:] = alive
            stats.host_time_s += time.perf_counter() - t_h

    def _fused_generate_rounds(
        self, bds, cache, generator, problem_ids, outputs, active, emitted,
        max_new_arr, head, rounds_per_row, stats, collect_effective_batch,
    ) -> None:
        """Lock-step round loop on the fused device-resident round: per
        round the host solves budgets, uploads ONE (B,) vector and
        downloads ONE packed per-row result; head/tails/emitted live on
        the device between rounds (``RoundState``)."""
        e = self.engine
        bds.prewarm()  # pack every open row's tree before round one
        state = make_state(
            head, bds.tails_matrix(), active, emitted, max_new_arr,
            self.device,
        )
        stats.n_h2d += 5
        forest = bds.forest_arrays()
        roots_dev = self._upload(bds.roots_array(), np.int32)
        stats.n_h2d += 1
        last_ver = bds.repack_version
        while active.any():
            t_h = time.perf_counter()
            remaining = max_new_arr - emitted
            budgets_np = self._round_budgets(
                problem_ids, emitted, active, remaining
            )
            K = self._bucket(int(budgets_np.max()))
            rows = np.nonzero(active & (budgets_np > 0))[0]
            bds.refresh_for(rows)
            if bds.repack_version != last_ver:
                last_ver = bds.repack_version
                forest = bds.forest_arrays()
                roots_dev = self._upload(bds.roots_array(), np.int32)
                stats.n_h2d += 1
            budgets_dev = self._upload(budgets_np, np.int32)
            stats.host_time_s += time.perf_counter() - t_h
            stats.n_h2d += 1  # the (B,) budget vector
            out = fused_round(
                self.params, self.cfg, forest, cache, state, roots_dev,
                budgets_dev, K=K, temperature=e.temperature,
                eos_token=e.eos_token, min_match=self.drafter.cfg.min_match,
                generator=generator,
            ).cpu().numpy()
            stats.n_d2h += 2
            if K > 0 and len(rows) > 0:
                self.drafter.stats["batched_proposes"] += 1
            t_h = time.perf_counter()
            cand, acc, n_take, alive, n_prop = unpack_round_out(out, K)
            mask = active.copy()
            stats.n_rounds += 1
            stats.n_fwd += 1
            stats.n_toks_proposed += int((1 + n_prop[mask]).sum())
            stats.n_drafted += int(n_prop[mask].sum())
            stats.n_accepted += int(acc[mask].sum())
            stats.round_accepts.append(
                float(acc[mask].mean()) if mask.any() else 0.0
            )
            if collect_effective_batch:
                stats.effective_batch.append(int(mask.sum()))
            rounds_per_row[mask] += 1
            tel = np.nonzero(mask & (n_prop > 0))[0]
            if tel.size:  # per-prompt accept telemetry
                self.drafter.note_draft_rows(
                    [problem_ids[b] for b in tel], n_prop[tel], acc[tel],
                )
            for b in np.nonzero(mask & (n_take > 0))[0]:
                outputs[b].extend(cand[b, : n_take[b]].tolist())
            emitted[mask] += n_take[mask]
            active &= alive
            stats.host_time_s += time.perf_counter() - t_h

    def begin_iteration(self, epoch: int, update_norm: float = 0.0) -> None:
        self.epoch = epoch
        self.drafter.begin_iteration(epoch, update_norm)

    def set_params(self, params: M.Transformer) -> None:
        """Policy updated by the learner — the drafter adapts via its
        sliding window; nothing to retrain (the paper's Insight-3)."""
        self.params = params
