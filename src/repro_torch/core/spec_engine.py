"""Speculative-decoding rollout engine (paper Fig. 3), lock-step and
continuous-batching modes — the port's counterpart of
``repro.core.spec_engine``.

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

Two serving modes share the round primitives:

* ``generate`` — lock-step: one fixed batch, every row steps together;
  finished rows ride along as dead slots until the stragglers drain.
* ``serve`` / ``generate_continuous`` — continuous batching: a fixed pool
  of device slots fed from an admission queue ordered
  longest-predicted-first (``core/scheduler.py``). A finished row's slot
  is re-prefilled with the next pending request at once, and rounds are
  double-buffered: while round *t* runs on the device, the host observes
  finished rollouts and pre-solves round *t+1* budgets; the round's
  result is downloaded only when the next dispatch needs it.

Lock-step ``generate`` can run up to R fused rounds a dispatch
(``EngineConfig.micro_rounds``; ``fused_round.fused_micro``), syncing
host bookkeeping once per dispatch instead of once per round.

Telemetry (``obs.Telemetry``: round counters, phase spans, the flight
recorder) reads only the host arrays of a round's one download, and the
write-ahead journal commits once per consumed dispatch from the host
window after it, so neither adds a host/device crossing. Spans time the
host's enqueue; the wait for the device lands in the span that
downloads (``accept_emit``/``fused_dispatch``/``consume``).
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.budget import LatencyModel, solve_budgets
from repro_torch.core.drafter import DrafterConfig, SuffixDrafter
from repro_torch.core.fused_round import (
    RoundState,
    fused_micro,
    fused_round,
    make_state,
    unpack_micro_out,
    unpack_round_out,
    verify_step,
)
from repro_torch.core.length_policy import CLASS_NAMES, LengthPolicy
from repro_torch.core.scheduler import CANCELLED, EXPIRED, Request, SlotScheduler
from repro_torch.core.verify import sample_token, sample_token_rows
from repro_torch.models import model as M
from repro_torch.obs.flight import NULL_FLIGHT


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
    # R-round device micro-loop (lock-step ``generate``, fused rounds):
    # up to R rounds a dispatch, leaving early once any row finishes.
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
    # fused lock-step dispatches (one result download each), and the
    # micro-rounds they enqueued past the loop's exit (``micro_rounds``
    # > 1: such a round launches every kernel and changes nothing)
    n_dispatches: int = 0
    n_idle_rounds: int = 0
    per_row_rounds: Optional[np.ndarray] = None
    per_row_emitted: Optional[np.ndarray] = None
    effective_batch: List[int] = field(default_factory=list)
    round_accepts: List[float] = field(default_factory=list)

    @property
    def acceptance_per_round(self) -> float:
        return self.n_accepted / max(self.n_rounds, 1)

    @property
    def mean_accepted_per_fwd(self) -> float:
        return self.n_toks_emitted / max(self.n_fwd, 1)

    def modeled_latency(self, lat: LatencyModel) -> float:
        """The paper's latency model J over this rollout's counts."""
        return lat.t_total(self.n_fwd, self.n_toks_proposed)


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


def _in_pool(slots, n_slots: int) -> np.ndarray:
    """Positions of ``slots`` that name a pool slot. The reference pads
    slot lists with ``n_slots`` and lets XLA drop those writes; PyTorch
    would raise (CPU) or assert (CUDA), so the padding is left out."""
    return np.nonzero(np.asarray(slots, np.int64) < n_slots)[0]


def admit_state_rows(state: RoundState, slots, heads, tails, max_new,
                     emitted) -> None:
    """Write newly admitted rows into the device ``RoundState``, in place
    (``emitted`` is 1 for a fresh admission, the salvaged length for a
    resumed one). Uploads copy, so no host array aliases the state."""
    keep = _in_pool(slots, state.active.shape[0])
    dev = state.head.device

    def up(a, dt):
        return torch.tensor(np.asarray(a, dt)[keep], device=dev)

    idx = up(slots, np.int64)
    state.head[idx] = up(heads, np.int32)
    state.tails[idx] = up(tails, np.int32)
    state.active[idx] = True
    state.emitted[idx] = up(emitted, np.int32)
    state.max_new[idx] = up(max_new, np.int32)


def evict_state_rows(state: RoundState, slots) -> None:
    """Clear the device ``active`` bit of evicted rows, in place (the
    other columns are dead once inactive; the next admission into the
    slot overwrites them)."""
    keep = _in_pool(slots, state.active.shape[0])
    idx = torch.tensor(np.asarray(slots, np.int64)[keep],
                       device=state.active.device)
    state.active[idx] = False


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
        telemetry=None,
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
        if self.drafter.remote is not None:
            # Remote-backed drafter: pooled cross-worker response-length
            # telemetry merges into this engine's length policy on every
            # sync.
            self.drafter.remote.attach(length_policy=self.length_policy)
        self.latency = latency or LatencyModel(c_base=1.0, c_tok=0.002)
        # Per-(problem, partial-length) budget memo keyed on the history
        # version (G samples per problem repeat the same posteriors).
        self._budget_memo: Dict[Tuple[Any, int], int] = {}
        self._pred_memo: Dict[Any, float] = {}
        self._memo_version = -1
        self.epoch = 0
        # Telemetry: NULL by default, so the instrumented paths cost a
        # handful of no-op calls a round unless a real one is given.
        self.telemetry = (
            telemetry if telemetry is not None else obs.get_telemetry()
        )
        self._init_obs()

    def _init_obs(self) -> None:
        """Resolve registry handles once; hot paths touch handles only.
        The drafter (and through it the remote history client) adopts this
        engine's telemetry, so one worker's registry aggregates engine,
        drafter, client and fault gauges."""
        tel = self.telemetry
        self.drafter.attach_telemetry(tel)
        c, h = tel.counter, tel.histogram
        self._mx = {
            "rounds": c("das_rounds_total", "Verify rounds dispatched"),
            "fwd": c("das_fwd_total", "Forward passes (prefill + verify)"),
            "proposed": c("das_tokens_proposed_total",
                          "Block tokens proposed over active rows"),
            "drafted": c("das_tokens_drafted_total",
                         "Draft tokens offered for verification"),
            "accepted": c("das_tokens_accepted_total",
                          "Draft tokens accepted by verification"),
            "emitted": c("das_tokens_emitted_total",
                         "Tokens emitted into finished outputs"),
            "h2d": c("das_h2d_transfers_total",
                     "Host-to-device array crossings"),
            "d2h": c("das_d2h_transfers_total",
                     "Device-to-host array crossings"),
            "round_host": h("das_round_host_seconds",
                            "Host bookkeeping time per round dispatch"),
            "resumed": c("das_resumed_tokens_total",
                         "Tokens salvaged into resumed rollouts (journal "
                         "recovery / preemption re-admission)"),
        }
        self._preempt_fam = tel.registry.counter_family(
            "das_preemptions_total",
            "Resident rollouts evicted from their slot, by reason",
            ("reason",),
        )
        fam = tel.registry.histogram_family(
            "das_accepted_tokens",
            "Accepted tokens per active row per round, by the row's "
            "current LengthPolicy class",
            ("length_class",), buckets=obs.TOKEN_BUCKETS,
        )
        self._accept_class_hist = tuple(
            fam.labels(name) for name in CLASS_NAMES
        )
        self._active_gauge = tel.gauge(
            "das_active_slots", "Rows active in the current round"
        )
        tel.registry.callback_gauge(
            "das_problem_acceptance",
            "Per-problem draft acceptance rate (accepted/drafted) from "
            "the drafter's history store",
            self._problem_acceptance_gauge,
        )
        tel.registry.callback_gauge(
            "das_compiled_programs",
            "compile_count(): CUDA kernel libraries built and loaded",
            lambda: float(self.compile_count()),
        )

    def _problem_acceptance_gauge(self):
        store = getattr(self.drafter, "store", None)
        if store is None:
            return {}
        try:
            keys = list(store.keys())
        except Exception:  # dascheck: disable=DAS303 -- scrape-time gauge: a store mid-mutation must not break /metrics
            return {}
        # Bounded cardinality: the first 64 problem keys.
        out = {}
        for k in keys[:64]:
            try:
                out[(("problem", str(k)),)] = float(store.acceptance(k))
            except Exception:  # dascheck: disable=DAS303 -- scrape-time gauge: one bad problem key must not break /metrics
                continue
        return out

    def _note_accepts(self, budgets, accepted, mask, emitted_before) -> None:
        """Token counters and the length-class acceptance histograms of
        one consumed round, from the host arrays the ``RolloutStats``
        bookkeeping just used (no recompute, no device read)."""
        mx = self._mx
        mx["proposed"].inc(float((1 + budgets[mask]).sum()))
        mx["drafted"].inc(float(budgets[mask].sum()))
        mx["accepted"].inc(float(accepted[mask].sum()))
        lp = self.length_policy
        by_cls: List[List[float]] = [[], [], []]
        for b in np.nonzero(mask)[0]:
            by_cls[lp.classify_length(float(emitted_before[b]))].append(
                float(accepted[b])
            )
        for cls_i, vals in enumerate(by_cls):
            if vals:
                self._accept_class_hist[cls_i].observe_many(vals)

    def _note_round_obs(self, budgets, accepted, mask, emitted_before) -> None:
        """Mirror one lock-step verify round into the registry (called
        only when telemetry is enabled)."""
        self._mx["rounds"].inc()
        self._mx["fwd"].inc()
        self._note_accepts(budgets, accepted, mask, emitted_before)

    def compile_count(self) -> int:
        """The port's counterpart of the reference's jit-program count:
        PyTorch traces nothing, so this counts the CUDA kernel libraries
        ``kernels/_build.py`` has built and loaded in this process."""
        from repro_torch.kernels import _build

        return len(_build._LIBS)

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
        watchdog=None,
        journal=None,
        journal_keys: Optional[Sequence[str]] = None,
    ) -> Tuple[List[List[int]], RolloutStats]:
        """Synchronous lock-step batched rollout with DAS speculation.

        ``max_new_tokens`` may be a scalar or a per-row sequence; at T > 0
        the draws come from ``generator`` (a ``torch.Generator`` on the
        engine's device; seed 0 when absent). Returns (generations per
        row, EOS-exclusive, stats).

        ``watchdog`` (a ``fault.RolloutWatchdog``) deadlines the round
        loop: every round checks in, every completed dispatch counts as
        progress, and an overrun raises ``StallError``. ``journal`` (a
        ``fault.RolloutJournal``) makes in-flight progress crash-durable:
        each row's accepted tokens buffer as one round record and
        group-commit once per dispatch, after its download.
        ``journal_keys`` names the sessions (default ``row{b}``).
        Lock-step mode journals but does not resume; salvaged sessions
        re-serve through ``serve``'s prefix re-prefill."""
        with torch.inference_mode():
            return self._generate(prompts, problem_ids, max_new_tokens,
                                  generator, collect_effective_batch,
                                  watchdog, journal, journal_keys)

    def _generate(self, prompts, problem_ids, max_new_tokens, generator,
                  collect_effective_batch, watchdog, journal, journal_keys):
        e = self.engine
        if watchdog is not None:
            watchdog.arm()
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

        # Flight recorder: lock-step rows are one trace each. Traces mint
        # whenever a journal needs them for continuity or a recorder is
        # attached; a round's capture is one batched append.
        flt = getattr(self.telemetry, "flight", None) or NULL_FLIGHT
        rec_flight = flt.enabled
        traces: Optional[List[str]] = None
        if rec_flight or journal is not None:
            traces = [flt.new_trace() for _ in range(B)]
        if rec_flight:
            for b in range(B):
                flt.record(traces[b], "admit", rid=b, slot=b, round=0)
        jkeys: Optional[List[str]] = None
        if journal is not None:
            jkeys = [
                str(journal_keys[b]) if journal_keys is not None
                else f"row{b}" for b in range(B)
            ]
            for b in range(B):
                journal.begin(
                    jkeys[b], prompts[b], problem_id=problem_ids[b],
                    max_new_tokens=int(max_new_arr[b]), trace=traces[b],
                )
                if outputs[b]:  # the sampled head token
                    journal.note(jkeys[b], outputs[b])
            journal.commit()

        loop = (self._fused_generate_rounds if self._fuse_enabled(bds)
                else self._unfused_generate_rounds)
        loop(
            bds, cache, generator, problem_ids, outputs, active, emitted,
            max_new_arr, head, rounds_per_row, stats,
            collect_effective_batch, watchdog=watchdog, journal=journal,
            jkeys=jkeys, flt=flt, traces=traces,
        )
        stats.n_h2d += bds.xfers.pop("h2d", 0)
        stats.n_d2h += bds.xfers.pop("d2h", 0)
        # strip EOS and observe history
        for b in range(B):
            if outputs[b] and outputs[b][-1] == e.eos_token:
                outputs[b] = outputs[b][:-1]
            if rec_flight:
                flt.record(
                    traces[b], "finish", rid=b, status="finished",
                    emitted=len(outputs[b]),
                )
            self.drafter.observe_rollout(
                problem_ids[b], list(prompts[b]) + outputs[b], self.epoch,
                response_len=len(outputs[b]),
                trace=traces[b] if traces is not None else None,
            )
            self.length_policy.observe(problem_ids[b], len(outputs[b]))
        if journal is not None:
            for b in range(B):
                journal.finish(jkeys[b], n_emitted=len(outputs[b]))
            journal.commit()
        stats.n_toks_emitted = int(sum(len(o) for o in outputs))
        stats.per_row_rounds = rounds_per_row
        stats.per_row_emitted = np.array([len(o) for o in outputs])
        stats.wall_time_s = time.perf_counter() - t0
        if self.telemetry.enabled:
            # transfer counters mirror as one delta per call
            self._mx["h2d"].inc(stats.n_h2d)
            self._mx["d2h"].inc(stats.n_d2h)
            self._mx["emitted"].inc(stats.n_toks_emitted)
        return outputs, stats

    def _unfused_generate_rounds(
        self, bds, cache, generator, problem_ids, outputs, active, emitted,
        max_new_arr, head, rounds_per_row, stats, collect_effective_batch,
        watchdog=None, journal=None, jkeys=None, flt=NULL_FLIGHT,
        traces=None,
    ) -> None:
        """Round loop with split steps: batched propose, host block
        assembly, one verify dispatch, host emit scan."""
        e = self.engine
        tel = self.telemetry
        B = len(outputs)
        while active.any():
            if watchdog is not None:
                watchdog.check("generate round")
            host0 = stats.host_time_s
            with tel.span("round"):
                t_h = time.perf_counter()
                with tel.span("budget_solve"):
                    remaining = max_new_arr - emitted
                    budgets_np = self._round_budgets(
                        problem_ids, emitted, active, remaining
                    )
                K = self._bucket(int(budgets_np.max()) if active.any() else 0)
                with tel.span("draft_dispatch"):
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
                # verify_forward includes the device wait (the download)
                with tel.span("verify_forward") as sp_v:
                    sp_v.set(h2d=3, d2h=2)
                    res, cache = verify_step(
                        self.params, self.cfg, cache, block_dev, budgets_dev,
                        active_dev, temperature=e.temperature,
                        generator=generator,
                    )
                    accepted = res.accepted.cpu().numpy().astype(np.int64)
                    next_tok = res.next_token.cpu().numpy().astype(np.int32)
                stats.n_d2h += 2
                # ---- host bookkeeping (vectorized EOS/emit scan) ----
                t_h = time.perf_counter()
                with tel.span("accept_emit"):
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
                    if tel.enabled:
                        self._note_round_obs(budgets_np, accepted, active,
                                             emitted)
                    if flt.enabled:
                        rows_f = np.nonzero(active)[0]
                        flt.record_round(
                            stats.n_rounds, [traces[b] for b in rows_f],
                            accepted[rows_f].tolist(),
                            budgets_np[rows_f].tolist(),
                        )
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
                                problem_ids[b], int(budgets_np[b]),
                                int(accepted[b]),
                            )
                        take = cand[b, : n_take[b]].tolist()
                        outputs[b].extend(take)
                        if journal is not None and take:
                            journal.note(jkeys[b], take)
                        if alive[b]:
                            bds.feed(b, take)
                        else:
                            bds.close(b)
                    emitted[active] += n_take[active]
                    head[:] = np.where(alive, next_tok, head)
                    active[:] = alive
                if journal is not None:  # post-consume group commit
                    journal.commit()
                if watchdog is not None:
                    watchdog.progress()
                stats.host_time_s += time.perf_counter() - t_h
            if tel.enabled:
                self._mx["round_host"].observe(stats.host_time_s - host0)

    def _fused_generate_rounds(
        self, bds, cache, generator, problem_ids, outputs, active, emitted,
        max_new_arr, head, rounds_per_row, stats, collect_effective_batch,
        watchdog=None, journal=None, jkeys=None, flt=NULL_FLIGHT,
        traces=None,
    ) -> None:
        """Lock-step round loop on the fused device-resident rounds: per
        dispatch the host solves budgets, uploads ONE (B,) vector and
        downloads ONE packed result of up to R = ``micro_rounds`` rounds
        (``fused_micro``: the loop leaves once any row finishes), then
        consumes the rounds that ran in order; head/tails/emitted live on
        the device between dispatches (``RoundState``)."""
        e = self.engine
        tel_obs = self.telemetry
        B = len(outputs)
        R = int(e.micro_rounds)
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
            if watchdog is not None:
                watchdog.check("fused round")
            host0 = stats.host_time_s
            with tel_obs.span("round"):
                t_h = time.perf_counter()
                with tel_obs.span("budget_solve"):
                    remaining = max_new_arr - emitted
                    budgets_np = self._round_budgets(
                        problem_ids, emitted, active, remaining
                    )
                K = self._bucket(int(budgets_np.max()))
                with tel_obs.span("forest_refresh"):
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
                # One dispatch = R micro-rounds of propose → verify →
                # accept → commit → emit scan; the span ends at the one
                # download, so it holds the device wait.
                with tel_obs.span("fused_dispatch") as sp_f:
                    sp_f.set(h2d=1, d2h=2)
                    flat = fused_micro(
                        self.params, self.cfg, forest, cache, state, roots_dev,
                        budgets_dev, R=R, K=K, temperature=e.temperature,
                        eos_token=e.eos_token,
                        min_match=self.drafter.cfg.min_match,
                        generator=generator,
                    ).cpu().numpy()
                outs, n_done = unpack_micro_out(flat, R, B, K)
                stats.n_d2h += 2  # the rounds and n_done, as the reference
                stats.n_dispatches += 1
                stats.n_idle_rounds += R - n_done
                if K > 0 and len(rows) > 0:  # each micro-round proposed
                    self.drafter.stats["batched_proposes"] += n_done
                t_h = time.perf_counter()
                with tel_obs.span("accept_emit"):
                    for r in range(n_done):
                        cand, acc, n_take, alive, n_prop = unpack_round_out(
                            outs[r], K)
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
                        if tel_obs.enabled:
                            self._note_round_obs(n_prop, acc, mask, emitted)
                        if flt.enabled:
                            rows_f = np.nonzero(mask)[0]
                            flt.record_round(
                                stats.n_rounds, [traces[b] for b in rows_f],
                                acc[rows_f].tolist(), n_prop[rows_f].tolist(),
                            )
                        rounds_per_row[mask] += 1
                        tel = np.nonzero(mask & (n_prop > 0))[0]
                        if tel.size:  # per-prompt accept telemetry
                            self.drafter.note_draft_rows(
                                [problem_ids[b] for b in tel], n_prop[tel],
                                acc[tel],
                            )
                        for b in np.nonzero(mask & (n_take > 0))[0]:
                            take = cand[b, : n_take[b]].tolist()
                            outputs[b].extend(take)
                            if journal is not None:
                                journal.note(jkeys[b], take)
                        emitted[mask] += n_take[mask]
                        active &= alive
                if journal is not None:  # one group commit per dispatch
                    journal.commit()
                if watchdog is not None:
                    watchdog.progress()
                stats.host_time_s += time.perf_counter() - t_h
            if tel_obs.enabled:
                self._mx["round_host"].observe(stats.host_time_s - host0)

    # -- continuous-batching mode --------------------------------------------
    def serve(
        self,
        requests: Iterable[Request],
        *,
        slots: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        stats: Optional[RolloutStats] = None,
        collect_effective_batch: bool = False,
        watchdog=None,
        journal=None,
        drain=None,
        preemption=None,
        clock=None,
    ) -> Iterator[Request]:
        """Continuous-batching serve loop (generator of finished requests).

        A fixed pool of ``slots`` device slots is fed from an admission
        queue ordered longest-predicted-first (``SlotScheduler``). The
        moment a row finishes, its slot is re-prefilled (coalesced
        bucketed prefill + ``copy_cache_rows``) with the next pending
        request, so the effective batch stays full through the long tail.

        Rounds are double-buffered: after round *t* is dispatched, the
        host (a) observes rollouts that finished in earlier rounds — the
        drafter/length-policy updates help still-running stragglers
        mid-serve — and repacks mutated trees (``bds.prewarm``, which also
        pulls a remote drafter's replicated packs, so the RPC hides behind
        the round in flight), and (b) pre-solves round *t+1* budgets from
        the stale emitted counts (re-clamped against fresh limits before
        dispatch). The round's result is downloaded only when the next
        dispatch needs it.

        Greedy verification is lossless, so per-request outputs are
        token-identical to ``generate`` at temperature 0. At T > 0 the
        draws come from ``generator`` (a ``torch.Generator`` on the
        engine's device; seed 0 when absent).

        ``stats`` counters aggregate across the serve; the per-row arrays
        are request-order views that ``generate_continuous`` fills.

        Durability and lifecycle (all optional, all off by default):

        * ``journal`` — a ``fault.RolloutJournal``. Every request gets a
          ``begin`` record up front; each consumed round's accepted
          tokens buffer as one ``round`` record per request and
          group-commit once per round from the post-consume host window.
          Requests arriving with ``resume_tokens`` (journal recovery, or a
          preemption earlier in this serve) re-admit via prefix re-prefill
          of ``prompt + resume_tokens[:-1]`` with the last salvaged token
          as the head — token-identical at T=0 to the uninterrupted run.
        * ``drain`` — a ``fault.DrainController``. Once draining,
          admissions stop; residents run on until the drain deadline,
          where they are preempted (progress journaled, state PREEMPTED,
          not re-queued) and the serve returns early with the journal
          fsynced.
        * ``preemption`` — a ``scheduler.PreemptionPolicy``. Victims are
          evicted post-consume, re-queued with remaining-length priority,
          and resume later by the same prefix re-prefill.
        * ``watchdog`` — a ``fault.RolloutWatchdog``: every loop pass
          checks in, every consumed round counts as progress.
        * ``clock`` — a ``fault.Clock`` driving per-request
          ``deadline_s`` expiry, drain deadlines and the preemption
          policy's deadline margin.

        Requests cancelled (``cancel_requested``), expired or drained end
        in a non-FINISHED terminal state with their partial ``output``
        kept, and are yielded without being observed into the
        drafter/length history (a truncated rollout must not poison the
        policy).
        """
        yield from self._serve(
            list(requests), slots, generator, stats,
            collect_effective_batch, watchdog, journal, drain, preemption,
            clock,
        )

    # torch's context decorators re-enter on every resume of a generator,
    # so the caller's code between two yields runs outside inference mode
    @torch.inference_mode()
    def _serve(self, reqs, slots, generator, stats, collect_effective_batch,
               watchdog, journal, drain, preemption, clock):
        e = self.engine
        tel_obs = self.telemetry
        if stats is None:
            stats = RolloutStats()
        if not reqs:
            return
        # ``stats`` may accumulate across serve() calls: mirror the
        # transfer counters into the registry as end-of-serve deltas.
        h2d0, d2h0 = stats.n_h2d, stats.n_d2h
        n_slots = max(1, min(int(slots) if slots else len(reqs), len(reqs)))
        sched = SlotScheduler(n_slots, self.length_policy, clock=clock)
        has_deadlines = any(r.deadline_s is not None for r in reqs)
        # Flight recorder: trace IDs mint up front — journal begin records
        # carry them even when nobody records locally, so a later process
        # (crash recovery, requeue survivor) continues the same trace.
        flt = getattr(tel_obs, "flight", None) or NULL_FLIGHT
        rec_flight = flt.enabled
        for r in reqs:
            if r.trace is None:
                r.trace = flt.new_trace()
        if journal is not None:
            for r in reqs:
                if r.journal_key is None:
                    r.journal_key = str(r.rid)
                journal.begin(
                    r.journal_key, r.prompt, problem_id=r.problem_id,
                    max_new_tokens=r.max_new_tokens,
                    resume=bool(r.resume_tokens), trace=r.trace,
                )
        for r in reqs:
            sched.submit(r)
            if rec_flight:
                flt.record(r.trace, "queued", rid=r.rid)
        if generator is None and e.temperature > 0:
            generator = torch.Generator(device=self.device).manual_seed(0)

        def _eff_prompt_len(r: Request) -> int:
            # A resumed request prefills prompt + salvaged[:-1]; size the
            # pool for that effective context.
            rt = r.resume_tokens
            return len(r.prompt) + (max(len(rt) - 1, 0) if rt else 0)

        # One pool cache sized for the worst admitted request.
        max_tp = max(_prompt_bucket(_eff_prompt_len(r)) for r in reqs)
        pool_len = _cache_bucket(
            max_tp + max(int(r.max_new_tokens) for r in reqs)
            + e.max_draft + 2
        )
        cache = M.init_cache(self.cfg, n_slots, pool_len, e.cache_headroom,
                             device=self.device)

        head = np.zeros(n_slots, np.int32)
        emitted = np.zeros(n_slots, np.int64)
        max_new_arr = np.ones(n_slots, np.int64)
        active = np.zeros(n_slots, bool)
        pids: List[Any] = [None] * n_slots
        bds = self._batched_sessions(n_slots)
        fused = self._fuse_enabled(bds)

        # Fused mode: per-slot session state (head / context tails /
        # emitted / limits) lives on the device between rounds; the host
        # mirrors above drive budget solving and bookkeeping only.
        state = None
        forest = None
        roots_dev = None
        last_ver = -1
        if fused:
            state = make_state(
                head, np.full((n_slots, bds.tail_len), -1, np.int32),
                active, emitted, max_new_arr, self.device,
            )
            stats.n_h2d += 5

        pending = None  # in-flight round (see dispatch/consume)
        finalize_q: collections.deque = collections.deque()
        done_q: collections.deque = collections.deque()
        round_no = 0
        roots_dirty = True  # row→tree mapping changed since last upload
        t_serve0 = time.perf_counter()

        def finish(req: Request) -> None:
            if req.output and req.output[-1] == e.eos_token:
                req.output.pop()
            req.emitted = len(req.output)
            req.finish_round = round_no
            req.session = None
            stats.n_toks_emitted += req.emitted
            sched.release(req)
            if journal is not None:
                journal.finish(req.journal_key, n_emitted=req.emitted)
            finalize_q.append(req)
            if rec_flight:
                flt.record(
                    req.trace, "finish", rid=req.rid, status="finished",
                    emitted=req.emitted,
                    rounds=req.finish_round - req.admit_round,
                )
            if tel_obs.enabled:
                self._mx["emitted"].inc(req.emitted)
                tel_obs.emit(
                    "request_done", rid=req.rid, slot=req.slot,
                    emitted=req.emitted,
                    rounds=req.finish_round - req.admit_round,
                )

        def open_row(req: Request, tok: int, fed, n_emitted: int) -> None:
            s = req.slot
            bds.open(s, req.problem_id, req.prompt)
            bds.feed(s, fed)
            pids[s] = req.problem_id
            head[s] = tok
            emitted[s] = n_emitted
            max_new_arr[s] = req.max_new_tokens
            active[s] = True

        def _admit_chunk(Tp: int, sub, admitted: List[Request]) -> None:
            """One coalesced admission chunk: batched prefill, one indexed
            cache-row write, per-request bookkeeping. The ``prefill`` span
            covers the dispatch through the first-token download (the
            device sync), with the ``cache_commit`` write nested."""
            nonlocal cache
            k = len(sub)
            tp0 = time.perf_counter()
            with tel_obs.span("prefill") as sp_pf:
                sp_pf.set(n=k, Tp=Tp)
                toks = np.zeros((k, Tp), np.int32)
                mask = np.zeros((k, Tp), bool)
                for j, (_req, ctx) in enumerate(sub):
                    n_p = len(ctx)
                    toks[j, Tp - n_p:] = ctx
                    mask[j, Tp - n_p:] = True
                last_logits, rows_cache = M.prefill(
                    self.params, self.cfg, self._upload(toks, np.int32),
                    self._upload(mask, bool), max_len=pool_len,
                    headroom=e.cache_headroom,
                )
                stats.n_h2d += 2
                with tel_obs.span("cache_commit"):
                    cache = M.copy_cache_rows(self.cfg, cache, rows_cache,
                                              [r.slot for r, _ in sub])
                stats.n_h2d += 1
                first_toks = sample_token_rows(
                    last_logits[:, : self.cfg.vocab_size],
                    temperature=e.temperature, generator=generator,
                ).cpu().numpy()
                stats.n_d2h += 1
            prefill_s = time.perf_counter() - tp0
            stats.n_fwd += 1
            stats.n_toks_proposed += int(sum(len(c) for _, c in sub))
            for j, (req, _ctx) in enumerate(sub):
                s = req.slot
                req.admit_round = round_no
                rt = req.resume_tokens
                if rt:
                    # Prefix re-prefill resume: the head is the last
                    # salvaged token (at T=0 it is what the prefill's
                    # logits argmax to), not a fresh sample.
                    rt = [int(t) for t in rt]
                    req.resume_tokens = None
                    req.output = list(rt)
                    tok = rt[-1]
                    req.head = tok
                    self._mx["resumed"].inc(float(len(rt)))
                    if journal is not None:
                        # a fresh journal file (recovery onto a new path)
                        # lacks the salvaged prefix: note the missing
                        # suffix so its own recovery is self-contained
                        have = journal.recorded_tokens(req.journal_key)
                        if have < len(rt):
                            journal.note(req.journal_key, rt[have:])
                    if rec_flight:
                        flt.record(
                            req.trace, "resume", dur=prefill_s / k,
                            rid=req.rid, slot=s, round=round_no,
                            salvaged=len(rt),
                        )
                    if tel_obs.enabled:
                        tel_obs.emit(
                            "resume", rid=req.rid, slot=s, round=round_no,
                            salvaged=len(rt),
                        )
                    if tok == e.eos_token or len(rt) >= req.max_new_tokens:
                        finish(req)  # the salvaged tail was done
                        continue
                    open_row(req, tok, rt, len(rt))
                    admitted.append(req)
                    continue
                tok = int(first_toks[j])
                req.head = tok
                if tok == e.eos_token or req.max_new_tokens <= 0:
                    if req.max_new_tokens > 0:
                        req.output.append(tok)
                    finish(req)  # freed; the admission loop re-admits
                    continue
                req.output.append(tok)
                if journal is not None:
                    journal.note(req.journal_key, [tok])
                if req.max_new_tokens <= 1:  # the head fills the limit
                    finish(req)
                    continue
                open_row(req, tok, [tok], 1)
                admitted.append(req)
                if rec_flight:
                    flt.record(
                        req.trace, "admit", dur=prefill_s / k, rid=req.rid,
                        slot=s, round=round_no,
                    )
                if tel_obs.enabled:
                    tel_obs.emit("admit", rid=req.rid, slot=s,
                                 round=round_no)

        def admit() -> None:
            """Fill free slots from the queue with coalesced prefills:
            admissions sharing a prompt bucket run as one batched prefill
            (split into power-of-two chunks, as the reference bounds its
            compiled variants) and their cache rows commit in one indexed
            write. Immediate-EOS admissions release their slot and the
            loop re-admits into it. In fused mode the new rows'
            head/tail/limit are written into the device ``RoundState``.
            Requests carrying ``resume_tokens`` prefill
            ``prompt + salvaged[:-1]`` and take the last salvaged token as
            their head."""
            nonlocal roots_dirty
            while True:
                newly = sched.next_admissions()
                if not newly:
                    return
                with tel_obs.span("admission_coalesce") as sp_adm:
                    groups: Dict[int, List[Tuple[Request, List[int]]]] = {}
                    for req in newly:
                        rt = req.resume_tokens
                        ctx = (list(req.prompt) + [int(t) for t in rt[:-1]]
                               if rt else req.prompt)
                        groups.setdefault(_prompt_bucket(len(ctx)),
                                          []).append((req, ctx))
                    admitted: List[Request] = []
                    for Tp in sorted(groups):
                        greqs = groups[Tp]
                        i0 = 0
                        while i0 < len(greqs):
                            k = 1 << ((len(greqs) - i0).bit_length() - 1)
                            _admit_chunk(Tp, greqs[i0: i0 + k], admitted)
                            i0 += k
                    sp_adm.set(n=len(newly), admitted=len(admitted))
                    if fused and admitted:
                        sl = [r.slot for r in admitted]
                        with tel_obs.span("cache_commit"):
                            admit_state_rows(
                                state, sl, [r.head for r in admitted],
                                np.stack([bds.tail_row(s) for s in sl]),
                                [r.max_new_tokens for r in admitted],
                                emitted[sl],
                            )
                        stats.n_h2d += 5
                        roots_dirty = True

        def consume() -> None:
            """Download the in-flight round (the device sync point) and
            apply its bookkeeping. In fused mode the result arrives as one
            packed download; emit scan, acceptance and next-round session
            state were computed on the device."""
            nonlocal pending
            if pending is None:
                return
            if pending[0] == "fused":
                _, outs_dev, K, mask = pending
                pending = None
                outs = outs_dev.cpu().numpy()
                stats.n_d2h += 1
                t_h = time.perf_counter()
                cand, accepted, n_take, alive, budgets = unpack_round_out(
                    outs, K)
                alive = alive & mask
            else:
                _, res, block, budgets, mask = pending
                pending = None
                accepted = res.accepted.cpu().numpy().astype(np.int64)
                next_tok = res.next_token.cpu().numpy().astype(np.int32)
                stats.n_d2h += 2
                t_h = time.perf_counter()
                cand = np.zeros((n_slots, block.shape[1]), np.int32)
                cand[:, :-1] = block[:, 1:]
                cand[np.arange(n_slots), accepted] = next_tok
                n_take, alive = _emit_scan(
                    cand, accepted + 1, max_new_arr - emitted, e.eos_token
                )
                alive &= mask
                head[:] = np.where(alive, next_tok, head)
            stats.n_toks_proposed += int((1 + budgets[mask]).sum())
            stats.n_drafted += int(budgets[mask].sum())
            stats.n_accepted += int(accepted[mask].sum())
            stats.round_accepts.append(
                float(accepted[mask].mean()) if mask.any() else 0.0
            )
            if tel_obs.enabled:
                # rounds/fwd were counted at dispatch; the token counters
                # and histograms land here, where acceptance is known
                self._note_accepts(budgets, accepted, mask, emitted)
            emitted[mask] += n_take[mask]
            active[mask & ~alive] = False
            if not fused:  # device tails advance inside the fused round
                bds.feed_rows(np.nonzero(alive)[0], cand, n_take)
            tel = np.nonzero(mask & (budgets > 0))[0]
            if tel.size:  # per-prompt acceptance telemetry, batched
                self.drafter.note_draft_rows(
                    [pids[s] for s in tel], budgets[tel], accepted[tel]
                )
            if rec_flight and mask.any():
                # one batched append for the whole pool's round
                rows_f = np.nonzero(mask)[0]
                flt.record_round(
                    round_no, [sched.slots[s].trace for s in rows_f],
                    accepted[rows_f].tolist(), budgets[rows_f].tolist(),
                )
            for s in np.nonzero(mask & (n_take > 0))[0]:
                req = sched.slots[s]
                take = cand[s, : n_take[s]].tolist()
                req.output.extend(take)
                if journal is not None:  # buffered; committed post-consume
                    journal.note(req.journal_key, take)
            for s in np.nonzero(mask & ~alive)[0]:
                req = sched.slots[s]
                bds.close(s)
                pids[s] = None
                finish(req)
            stats.host_time_s += time.perf_counter() - t_h

        def teardown_slot(req: Request) -> int:
            """Host-side eviction of a resident row; the fused device
            ``active`` bit clears in one write afterwards."""
            s = req.slot
            bds.close(s)
            pids[s] = None
            active[s] = False
            req.session = None
            return s

        def finish_terminal(req: Request, status: str) -> None:
            """CANCELLED/EXPIRED terminal: partial output kept, journal
            closed with the terminal status, yielded without being
            observed into the drafter/length history."""
            req.emitted = len(req.output)
            req.finish_round = round_no
            if journal is not None:
                journal.finish(req.journal_key, status=status,
                               n_emitted=req.emitted)
            done_q.append(req)
            if rec_flight:
                flt.record(req.trace, "finish", rid=req.rid, status=status,
                           emitted=req.emitted)
            if tel_obs.enabled:
                tel_obs.emit("request_done", rid=req.rid, status=status,
                             emitted=req.emitted)

        def preempt_req(req: Request, reason: str, requeue: bool) -> None:
            """Evict a resident: its progress is journaled round by round,
            so the victim only needs its salvage prefix staged
            (``resume_tokens``) and, unless draining, a re-queue with
            remaining-length priority."""
            sched.preempt(req)
            req.resume_tokens = list(req.output)
            req.head = -1
            req.predicted_len = sched.remaining_len(req)
            if requeue:
                sched.submit(req)
            self._preempt_fam.labels(reason).inc()
            if rec_flight:
                flt.record(req.trace, "preempt", rid=req.rid, reason=reason,
                           emitted=len(req.output), round=round_no,
                           requeued=requeue)
                if requeue:
                    flt.record(req.trace, "requeue", rid=req.rid,
                               round=round_no)
            if tel_obs.enabled:
                tel_obs.emit("preempt", rid=req.rid, reason=reason,
                             emitted=len(req.output), round=round_no,
                             requeued=requeue)

        def service_lifecycle() -> None:
            """Post-consume lifecycle pass: cancellations, deadlines,
            drain expiry, preemption-policy victims. Runs only while no
            round is in flight, so an evicted slot never receives a stale
            result."""
            evicted: List[int] = []
            now = None
            if has_deadlines or (
                preemption is not None and preemption.deadline_margin_s > 0
            ):
                now = sched.clock.now()
            for req in sched.running() + sched.queued_requests():
                if req.cancel_requested:
                    if req.slot >= 0:
                        evicted.append(teardown_slot(req))
                    sched.cancel(req)
                    finish_terminal(req, CANCELLED)
            if has_deadlines:
                for req in sched.due_requests(now):
                    if req.slot >= 0:
                        evicted.append(teardown_slot(req))
                    sched.expire(req)
                    finish_terminal(req, EXPIRED)
            if drain is not None and drain.draining and drain.expired():
                # journal-and-exit: residents go PREEMPTED but are not
                # re-queued; their journal sessions stay in flight, so
                # the next process resumes them token-identically.
                for req in sched.running():
                    evicted.append(teardown_slot(req))
                    preempt_req(req, "drain", requeue=False)
            elif preemption is not None:
                mrr = preemption.max_resident_rounds
                for req in sched.preemption_victims(preemption, round_no,
                                                    now):
                    reason = (
                        "slot_pressure"
                        if mrr is not None
                        and round_no - req.admit_round >= mrr
                        else "deadline"
                    )
                    evicted.append(teardown_slot(req))
                    preempt_req(req, reason, requeue=True)
            if fused and evicted:
                evict_state_rows(state, evicted)
                stats.n_h2d += 1

        def precompute_budgets():
            """Round t+1 budgets from stale emitted counts, in the overlap
            window. The occupant snapshot guards against slot recycling: a
            budget precomputed for a slot's previous request must not
            apply to the request admitted into it afterwards."""
            if not active.any():
                return None
            with tel_obs.span("budget_solve"):
                rem = max_new_arr - emitted
                return (self._round_budgets(pids, emitted, active, rem),
                        active.copy(), list(sched.slots))

        def solve_budgets(pre) -> np.ndarray:
            """Round budgets for the active rows (post-consume): reuse the
            overlap-window precompute where the slot's occupant is
            unchanged, solve fresh for the rest, clamp against fresh
            limits."""
            with tel_obs.span("budget_solve"):
                remaining = max_new_arr - emitted
                budgets = np.zeros(n_slots, np.int64)
                if pre is not None:
                    pb, pmask, pocc = pre
                    same = np.fromiter(
                        (sched.slots[s] is pocc[s] for s in range(n_slots)),
                        bool, n_slots,
                    )
                    use = pmask & active & same
                    budgets[use] = pb[use]
                    fresh_rows = active & ~use
                else:
                    fresh_rows = active.copy()
                if fresh_rows.any():  # rows recycled since the precompute
                    fb = self._round_budgets(pids, emitted, fresh_rows,
                                             remaining)
                    budgets[fresh_rows] = fb[fresh_rows]
                return np.where(
                    active, np.minimum(budgets, np.maximum(remaining - 1, 0)),
                    0,
                )

        def sync_forest() -> None:
            """Refresh the packed forest and the per-row root handles after
            tree mutations (observations), replicated remote packs, or
            slot turnover (admissions)."""
            nonlocal forest, roots_dev, last_ver, roots_dirty
            with tel_obs.span("history_sync") as sp_s:
                bds.prewarm()
                last_ver = bds.repack_version
                roots_dirty = False
                forest = bds.forest_arrays()
                roots_dev = self._upload(bds.roots_array(), np.int32)
                stats.n_h2d += 1
                sp_s.set(h2d=1)

        def dispatch(budgets, prop_handle, fresh_roots: bool = False) -> None:
            nonlocal pending, cache, round_no
            t_h = time.perf_counter()
            K = self._bucket(int(budgets.max(initial=0)))
            if fused:
                # One fused round: propose → block → verify → commit →
                # next-round state on the device. Rows admitted in this
                # iteration carry budget 0 (they draft from their next
                # round on), so a stale root for them is inert; only the
                # startup branch, whose budgets were solved after
                # admission, needs the roots synced here.
                if roots_dev is None or (
                    fresh_roots
                    and (roots_dirty or bds.repack_version != last_ver)
                ):
                    sync_forest()
                if K > 0:  # solve_budgets zeroes inactive rows
                    self.drafter.stats["batched_proposes"] += 1
                budgets_dev = self._upload(budgets, np.int32)
                stats.host_time_s += time.perf_counter() - t_h
                stats.n_h2d += 1  # the (B,) budget vector
                outs_dev = fused_round(
                    self.params, self.cfg, forest, cache, state, roots_dev,
                    budgets_dev, K=K, temperature=e.temperature,
                    eos_token=e.eos_token,
                    min_match=self.drafter.cfg.min_match,
                    generator=generator,
                )
                pending = ("fused", outs_dev, K, active.copy())
            else:
                block = np.zeros((n_slots, K + 1), np.int32)
                block[:, 0] = head
                props = bds.consume(prop_handle)
                for s in np.nonzero(active)[0]:
                    prop = props[s]
                    budgets[s] = len(prop)
                    if prop:
                        block[s, 1: 1 + len(prop)] = prop
                block_dev = self._upload(block, np.int32)
                budgets_dev = self._upload(budgets, np.int32)
                active_dev = self._upload(active, bool)
                stats.host_time_s += time.perf_counter() - t_h
                stats.n_h2d += 3  # block + budgets + active uploads
                res, cache = verify_step(
                    self.params, self.cfg, cache, block_dev, budgets_dev,
                    active_dev, temperature=e.temperature,
                    generator=generator,
                )
                pending = ("plain", res, block, budgets, active.copy())
            round_no += 1
            stats.n_rounds += 1
            stats.n_fwd += 1
            if tel_obs.enabled:
                self._mx["rounds"].inc()
                self._mx["fwd"].inc()
                self._active_gauge.set(float(active.sum()))
            if collect_effective_batch:
                stats.effective_batch.append(int(active.sum()))
            for s in np.nonzero(active)[0]:
                sched.slots[s].rounds += 1

        if watchdog is not None:
            watchdog.arm()
        while sched.has_work() or pending is not None:
            if watchdog is not None:
                watchdog.check("serve round")
            host0 = stats.host_time_s
            with tel_obs.span("serve_round"):
                # ---- overlap window: the device runs the in-flight round;
                # the host observes finished rollouts (their drafts help
                # the stragglers at once) and pre-solves the next budgets.
                if finalize_q:
                    with tel_obs.span("history_publish") as sp_p:
                        n_fin = 0
                        while finalize_q:
                            req = finalize_q.popleft()
                            self._finalize_request(req)
                            done_q.append(req)
                            n_fin += 1
                        # repack mutated trees once, after all of the
                        # round's observations, so the next dispatch
                        # finds them packed
                        bds.prewarm()
                        sp_p.set(finished=n_fin)
                if fused and (roots_dirty or bds.repack_version != last_ver):
                    # also in the overlap window: the roots/forest upload
                    # for last iteration's admissions rides the round in
                    # flight (their budgets stay 0 until the next solve)
                    sync_forest()
                pre = precompute_budgets() if pending is not None else None
                with tel_obs.span("consume"):
                    consume()  # device sync: bookkeeping needs the result
                if watchdog is not None:
                    watchdog.progress()  # the in-flight round completed
                if journal is not None:
                    # the post-consume group commit: one write per round,
                    # fsync batched (das_journal_* meter it)
                    t_h = time.perf_counter()
                    journal.commit()
                    stats.host_time_s += time.perf_counter() - t_h
                service_lifecycle()
                draining = drain is not None and drain.draining
                # Unfused: the batched draft propose for the surviving rows
                # goes out before admissions. Fused: it runs inside the
                # round dispatch below. Rows admitted below draft from
                # their next round on.
                budgets = prop_handle = None
                if active.any():
                    t_h = time.perf_counter()
                    budgets = solve_budgets(pre)
                    if not fused:
                        prop_handle = bds.dispatch(budgets)
                    stats.host_time_s += time.perf_counter() - t_h
                if not draining:  # drain: stop admissions, run down
                    admit()  # recycle freed slots before the next round
                if active.any():
                    fresh_roots = False
                    if budgets is None:
                        # The pool was empty before admissions (startup):
                        # solve and propose for the admitted batch now, so
                        # warm history drafts from round one.
                        t_h = time.perf_counter()
                        budgets = solve_budgets(None)
                        if not fused:
                            prop_handle = bds.dispatch(budgets)
                        stats.host_time_s += time.perf_counter() - t_h
                        fresh_roots = True
                    with tel_obs.span("verify_dispatch"):
                        dispatch(budgets, prop_handle, fresh_roots)
            if tel_obs.enabled:
                self._mx["round_host"].observe(stats.host_time_s - host0)
            while done_q:
                yield done_q.popleft()
            if (drain is not None and drain.draining
                    and pending is None and not active.any()):
                # Drained out: residents finished (or were journaled and
                # preempted at the deadline); whatever is still queued
                # stays QUEUED with its journal session in flight.
                break
        while done_q:  # lifecycle terminals from the final iteration
            yield done_q.popleft()
        while finalize_q:  # rows that finished in the last round
            req = finalize_q.popleft()
            self._finalize_request(req)
            yield req
        if journal is not None:
            journal.commit()  # tail finish records
            if drain is not None and drain.draining:
                journal.sync()  # drain exit: force power-loss durability
        stats.n_h2d += bds.xfers.pop("h2d", 0)
        stats.n_d2h += bds.xfers.pop("d2h", 0)
        stats.wall_time_s = time.perf_counter() - t_serve0
        if tel_obs.enabled:
            self._mx["h2d"].inc(float(stats.n_h2d - h2d0))
            self._mx["d2h"].inc(float(stats.n_d2h - d2h0))

    def _finalize_request(self, req: Request) -> None:
        """Observe a finished rollout (drafter window + length history).
        The request's trace ID rides the history publish, so the owning
        shard stamps its ``publish`` flight event on the same trace."""
        self.drafter.observe_rollout(
            req.problem_id, list(req.prompt) + req.output, self.epoch,
            response_len=len(req.output), trace=req.trace,
        )
        self.length_policy.observe(req.problem_id, len(req.output))

    def generate_continuous(
        self,
        prompts: Sequence[Sequence[int]],
        problem_ids: Optional[Sequence] = None,
        *,
        slots: Optional[int] = None,
        max_new_tokens=None,
        generator: Optional[torch.Generator] = None,
        collect_effective_batch: bool = False,
        watchdog=None,
        journal=None,
        journal_keys: Optional[Sequence[str]] = None,
        resume: Optional[Dict[str, Any]] = None,
    ) -> Tuple[List[List[int]], RolloutStats]:
        """Drop-in for ``generate`` backed by the continuous engine.

        Streams the batch through a pool of ``slots`` device slots
        (default: one per request; recycling needs ``slots <
        len(prompts)``). Returns outputs in request order plus the usual
        stats; ``n_rounds`` is the pool makespan in verify rounds.

        ``journal``/``journal_keys`` thread the write-ahead token journal
        through ``serve``. ``resume`` maps journal keys to salvaged
        progress — a ``JournalSession`` or a plain token list — from a
        dead worker's journal: matching rows re-admit via prefix
        re-prefill instead of regenerating, and rows whose salvage already
        finished return without any device work."""
        t0 = time.perf_counter()
        B = len(prompts)
        if problem_ids is None:
            problem_ids = list(range(B))
        mn = (max_new_tokens if max_new_tokens is not None
              else self.engine.max_new_tokens)
        max_new_arr = _as_max_new_array(mn, B)
        reqs = [
            Request(rid=i, problem_id=problem_ids[i], prompt=list(prompts[i]),
                    max_new_tokens=int(max_new_arr[i]))
            for i in range(B)
        ]
        if journal_keys is not None:
            for i, r in enumerate(reqs):
                r.journal_key = str(journal_keys[i])
        to_serve = reqs
        if resume:
            from repro_torch.fault.journal import JournalSession, resume_requests

            sessions = {
                str(k): (
                    v if isinstance(v, JournalSession)
                    else JournalSession(key=str(k), tokens=list(v))
                )
                for k, v in resume.items()
            }
            to_serve, pre_done = resume_requests(reqs, sessions)
            if pre_done and self.telemetry.enabled:
                self.telemetry.emit(
                    "resume", pre_done=len(pre_done),
                    salvaged=sum(len(r.output) for r in pre_done),
                )
        stats = RolloutStats()
        for _ in self.serve(to_serve, slots=slots, generator=generator,
                            stats=stats,
                            collect_effective_batch=collect_effective_batch,
                            watchdog=watchdog, journal=journal):
            pass
        outputs = [r.output for r in reqs]
        stats.n_toks_emitted = int(sum(len(o) for o in outputs))
        stats.per_row_rounds = np.array([r.rounds for r in reqs], np.int64)
        stats.per_row_emitted = np.array([len(o) for o in outputs])
        stats.wall_time_s = time.perf_counter() - t0
        return outputs, stats

    def begin_iteration(self, epoch: int, update_norm: float = 0.0) -> None:
        self.epoch = epoch
        self.drafter.begin_iteration(epoch, update_norm)

    def set_params(self, params: M.Transformer) -> None:
        """Policy updated by the learner — the drafter adapts via its
        sliding window; nothing to retrain (the paper's Insight-3)."""
        self.params = params
