"""Rollout phase of the port (counterpart of ``repro.rl.rollout``):
batched generation with G samples per problem.

Wraps the speculative engine for RL: replicates each problem G times
(all G samples share the same per-problem suffix tree — exactly the
reuse the paper exploits), computes verifiable rewards, and packs the
result into a GRPO training batch. The baseline (no speculation) is the
same code path with ``spec_enabled=False``.

With ``continuous=True`` the worker streams the N = problems × G
requests through the engine's fixed slot pool instead of one padded
lock-step batch; outputs are token-identical at temperature 0.

The reference's JAX ``key`` is an explicit ``torch.Generator`` on the
engine's device here (``generator=``). ``MultiWorkerRollout`` draws one
seed a slice from the caller's generator and builds a fresh generator
from it for every attempt at the slice, so a re-queued slice draws what
its first attempt would have (a ``torch.Generator`` is stateful; the
reference re-uses the slice's immutable key).
"""

from __future__ import annotations

import collections
import logging
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.spec_engine import RolloutStats, SpecEngine
from repro_torch.data.tasks import Problem, Task
from repro_torch.data.tokenizer import PAD
from repro_torch.fault.watchdog import StallError
from repro_torch.rl.grpo import group_advantages

log = logging.getLogger("repro_torch.rl.rollout")


@dataclass
class RolloutBatch:
    tokens: np.ndarray  # (N, S) prompt+response, right-padded
    resp_mask: np.ndarray  # (N, S) bool, True on response tokens
    advantages: np.ndarray  # (N,)
    rewards: np.ndarray  # (N,)
    responses: List[List[int]]
    problems: List[Problem]
    stats: RolloutStats
    gen_time_s: float


def pack_train_arrays(
    prompts: Sequence[Sequence[int]], outs: Sequence[Sequence[int]]
) -> Tuple[np.ndarray, np.ndarray]:
    """Right-padded (tokens, resp_mask) train arrays, width rounded up to
    a multiple of 32 (shared by the single- and multi-worker paths)."""
    N = len(prompts)
    S = max(len(p) + len(o) for p, o in zip(prompts, outs)) + 1
    S = ((S + 31) // 32) * 32
    tokens = np.full((N, S), PAD, np.int32)
    resp_mask = np.zeros((N, S), bool)
    for i, (p, o) in enumerate(zip(prompts, outs)):
        seq = list(p) + list(o)
        tokens[i, : len(seq)] = seq
        resp_mask[i, len(p) : len(seq)] = True
    return tokens, resp_mask


class RolloutWorker:
    def __init__(
        self,
        engine: SpecEngine,
        task: Task,
        group_size: int = 8,
        *,
        continuous: bool = False,
        slots: Optional[int] = None,
        watchdog=None,
        journal=None,
    ):
        self.engine = engine
        self.task = task
        self.G = group_size
        self.continuous = continuous
        self.slots = slots  # pool size; None = one slot per request
        # Optional fault.RolloutWatchdog: deadlines this worker's verify
        # rounds; a stall raises StallError out of rollout(), which the
        # fault-tolerant MultiWorkerRollout turns into a re-queue.
        self.watchdog = watchdog
        # Optional fault.RolloutJournal: every rollout's accepted tokens
        # become crash-durable round by round under the key "{pid}#{g}",
        # so a dead worker's in-flight progress is salvageable.
        self.journal = journal

    def rollout(
        self,
        problems: Sequence[Problem],
        *,
        generator: Optional[torch.Generator] = None,
        max_new_tokens: Optional[int] = None,
        collect_effective_batch: bool = False,
        resume=None,
    ) -> RolloutBatch:
        """Roll out ``problems`` × G samples; at T > 0 the draws come from
        ``generator``. ``resume`` maps journal keys (``"{pid}#{g}"``) to
        salvaged sessions from a failed worker's journal: matching rows
        re-admit via the engine's prefix re-prefill (token-identical at
        T=0). Resume always routes through the continuous engine."""
        t0 = time.perf_counter()
        prompts, pids, probs, jkeys = [], [], [], []
        for p in problems:
            for g in range(self.G):
                prompts.append(list(p.prompt))
                pids.append(p.pid)
                probs.append(p)
                jkeys.append(f"{p.pid}#{g}")
        if self.continuous or resume:
            outs, stats = self.engine.generate_continuous(
                prompts, pids, slots=self.slots,
                max_new_tokens=max_new_tokens, generator=generator,
                collect_effective_batch=collect_effective_batch,
                watchdog=self.watchdog, journal=self.journal,
                journal_keys=jkeys, resume=resume,
            )
        else:
            outs, stats = self.engine.generate(
                prompts, pids, max_new_tokens=max_new_tokens,
                generator=generator,
                collect_effective_batch=collect_effective_batch,
                watchdog=self.watchdog, journal=self.journal,
                journal_keys=jkeys,
            )
        gen_time = time.perf_counter() - t0
        rewards = np.array(
            [self.task.reward(pr, o) for pr, o in zip(probs, outs)],
            np.float32,
        )
        adv = group_advantages(rewards, self.G)
        tokens, resp_mask = pack_train_arrays(prompts, outs)
        return RolloutBatch(
            tokens=tokens,
            resp_mask=resp_mask,
            advantages=adv.astype(np.float32),
            rewards=rewards,
            responses=outs,
            problems=probs,
            stats=stats,
            gen_time_s=gen_time,
        )


def merge_rollout_stats(parts: Sequence[RolloutStats]) -> RolloutStats:
    """Sum per-worker rollout stats into one fleet view (counters add,
    traces concatenate; per-row views are reassembled by the caller)."""
    out = RolloutStats()
    for st in parts:
        out.n_rounds += st.n_rounds
        out.n_fwd += st.n_fwd
        out.n_toks_proposed += st.n_toks_proposed
        out.n_toks_emitted += st.n_toks_emitted
        out.n_drafted += st.n_drafted
        out.n_accepted += st.n_accepted
        out.wall_time_s += st.wall_time_s
        out.host_time_s += st.host_time_s
        out.n_h2d += st.n_h2d
        out.n_d2h += st.n_d2h
        out.n_dispatches += st.n_dispatches
        out.n_idle_rounds += st.n_idle_rounds
        out.effective_batch.extend(st.effective_batch)
        out.round_accepts.extend(st.round_accepts)
    return out


class MultiWorkerRollout:
    """N rollout workers sharing one batch — the multi-worker rollout
    phase over the pooled history service.

    Each call partitions the problem batch across the workers
    (round-robin, rotated every call so a problem's rollouts come from a
    different worker each step). Workers run their slices through their
    own engines; with remote-backed drafters each worker's publishes are
    flushed before the next worker starts, so later slices draft against
    trees the earlier slices just warmed, in a deterministic order.

    The merged ``RolloutBatch`` is in the original request order with
    group advantages recomputed over the merged rewards.

    With ``fault_tolerant=True`` a worker that stalls (``StallError``
    from its watchdog), dies mid-slice, or loses its shards does not sink
    the step: the worker is expired for this call and its slice re-queues
    to a survivor with the slice's original seed and whatever its journal
    salvaged, so at T=0 the merged batch is token-identical to the
    no-failure run. A ``supervisor`` (``fault.ShardSupervisor``) is
    polled once per call and after every failure.
    """

    def __init__(
        self,
        workers: Sequence[RolloutWorker],
        rotate: bool = True,
        *,
        fault_tolerant: bool = False,
        supervisor=None,
        flush_timeout: float = 10.0,
        flush_retries: int = 3,
        telemetry=None,
    ):
        from repro_torch import obs

        if not workers:
            raise ValueError("MultiWorkerRollout needs >= 1 worker")
        gs = {w.G for w in workers}
        if len(gs) != 1:
            raise ValueError(f"workers disagree on group size: {gs}")
        self.workers = list(workers)
        self.G = self.workers[0].G
        self.rotate = bool(rotate)
        self.fault_tolerant = bool(fault_tolerant)
        self.supervisor = supervisor
        self.flush_timeout = float(flush_timeout)
        self.flush_retries = int(flush_retries)
        self.telemetry = (
            telemetry if telemetry is not None else obs.get_telemetry()
        )
        self.stats = obs.MirroredCounter(
            sink=self.telemetry.mirror_sink(
                "das_rollout_stat_total", "MultiWorkerRollout counters"
            )
        )
        self._calls = 0

    @property
    def engine(self):
        """Lead worker's engine (trainer introspection)."""
        return self.workers[0].engine

    def _flush_worker(self, worker: RolloutWorker) -> None:
        remote = worker.engine.drafter.remote
        if remote is None or remote.flush(timeout=self.flush_timeout):
            return
        if not self.fault_tolerant:
            # The barrier is what keeps shard trees oracle-identical;
            # proceeding with unacked publishes would silently diverge.
            raise RuntimeError(
                "history-service publish flush timed out: a shard is "
                "unreachable and the epoch barrier cannot be enforced"
            )
        # Fault-tolerant: force-restart dead shards between attempts (the
        # client's outbox resends, shards dedup), then degrade — a weaker
        # barrier only staggers when peers see this worker's history.
        for _ in range(self.flush_retries):
            if self.supervisor is not None:
                self.supervisor.poll(force=True)
            if remote.flush(timeout=self.flush_timeout):
                return
        self.stats["degraded_flushes"] += 1
        self.telemetry.emit(
            "degraded_flush", retries=self.flush_retries,
            timeout_s=self.flush_timeout,
        )
        log.warning(
            "publish flush still timing out after %d shard-restart "
            "attempts; continuing with a degraded epoch barrier (peers "
            "see this worker's rollouts late)", self.flush_retries,
        )

    def _slice_generator(self, worker: RolloutWorker, seed):
        """A fresh generator for one attempt at a slice, on the worker's
        engine device (None when the caller gave no generator)."""
        if seed is None:
            return None
        return torch.Generator(device=worker.engine.device).manual_seed(seed)

    def rollout(
        self,
        problems: Sequence[Problem],
        *,
        generator: Optional[torch.Generator] = None,
        max_new_tokens: Optional[int] = None,
        collect_effective_batch: bool = False,
    ) -> RolloutBatch:
        t0 = time.perf_counter()
        N = len(self.workers)
        off = (self._calls % N) if self.rotate else 0
        self._calls += 1
        # problem j -> worker (j + off) % N; slices keep problem order
        assign = [[] for _ in range(N)]
        for j, p in enumerate(problems):
            assign[(j + off) % N].append(j)
        # One seed a slice, drawn once from the caller's generator: every
        # attempt at the slice builds its generator from it afresh.
        seeds: List[Optional[int]] = [None] * N
        if generator is not None:
            seeds = torch.randint(
                0, 2 ** 62, (N,), generator=generator,
                device=generator.device,
            ).tolist()
        if self.supervisor is not None:
            self.supervisor.poll()  # restart dead shards before the step
        # Work queue of (worker, slice, slice seed, salvage): a failed
        # worker's slice goes back on the queue addressed to a survivor,
        # carrying whatever progress the dead worker's journal holds.
        queue = collections.deque(
            (w, idxs, seeds[w], None) for w, idxs in enumerate(assign)
            if idxs
        )
        expired: set = set()
        slices: List[Tuple[List[int], RolloutBatch]] = []
        while queue:
            w, idxs, seed, salvage = queue.popleft()
            worker = self.workers[w]
            try:
                part = worker.rollout(
                    [problems[j] for j in idxs],
                    generator=self._slice_generator(worker, seed),
                    max_new_tokens=max_new_tokens,
                    collect_effective_batch=collect_effective_batch,
                    resume=salvage,
                )
            except (StallError, RuntimeError, OSError) as exc:
                # StallError: the watchdog expired the worker.
                # RuntimeError/OSError: the worker's engine or its service
                # connection died mid-slice.
                if not self.fault_tolerant:
                    raise
                expired.add(w)
                self.stats["worker_failures"] += 1
                survivors = [v for v in range(N) if v not in expired]
                if not survivors:
                    raise  # nobody left to hand the work to
                if self.supervisor is not None:
                    # the root cause may be a dead shard, not the worker
                    self.supervisor.poll()
                # Salvage the dead worker's journaled in-flight progress
                # (in-memory mirror), merged over whatever salvage this
                # slice already carried.
                jrnl = getattr(worker, "journal", None)
                if jrnl is not None:
                    merged = dict(salvage) if salvage else {}
                    merged.update(jrnl.live_sessions())
                    salvage = merged or None
                n_salvaged = (
                    sum(len(s.tokens) for s in salvage.values())
                    if salvage else 0
                )
                self.stats["salvaged_tokens"] += n_salvaged
                v = survivors[w % len(survivors)]
                queue.append((v, idxs, seed, salvage))
                self.stats["requeued_problems"] += len(idxs)
                flt = getattr(self.telemetry, "flight", None)
                if flt is not None and flt.enabled:
                    # One handoff event per salvaged in-flight trace: the
                    # survivor's resume continues the dead worker's trace.
                    traced = [
                        s.trace for s in (salvage or {}).values()
                        if s.trace is not None and not s.finished
                    ]
                    for tr in traced:
                        flt.record(
                            tr, "handoff", from_worker=w, to_worker=v,
                            error=type(exc).__name__,
                        )
                    if not traced:  # never silently absent
                        flt.record(
                            None, "handoff", from_worker=w, to_worker=v,
                            n_problems=len(idxs),
                            error=type(exc).__name__,
                        )
                self.telemetry.emit(
                    "watchdog_requeue", worker=w, to_worker=v,
                    n_problems=len(idxs), error=str(exc),
                    salvaged_tokens=n_salvaged,
                )
                log.warning(
                    "rollout worker %d expired (%s); re-queued %d "
                    "problem(s) to worker %d (%d journaled tokens "
                    "salvaged)", w, exc, len(idxs), v, n_salvaged,
                )
                continue
            # Epoch barrier: the next worker (and the next trainer step)
            # must see these rollouts on the shards.
            self._flush_worker(worker)
            slices.append((idxs, part))

        # -- reassemble in original problem order --------------------------
        G = self.G
        outs: List[List[int]] = [None] * (len(problems) * G)
        rewards = np.zeros(len(problems) * G, np.float32)
        probs: List[Problem] = [None] * (len(problems) * G)
        prompts: List[List[int]] = [None] * (len(problems) * G)
        for idxs, part in slices:
            for local, j in enumerate(idxs):
                for g in range(G):
                    src = local * G + g
                    dst = j * G + g
                    outs[dst] = part.responses[src]
                    rewards[dst] = part.rewards[src]
                    probs[dst] = part.problems[src]
                    prompts[dst] = list(problems[j].prompt)
        adv = group_advantages(rewards, G)
        tokens, resp_mask = pack_train_arrays(prompts, outs)
        stats = merge_rollout_stats([part.stats for _, part in slices])
        stats.per_row_emitted = np.array([len(o) for o in outs])
        return RolloutBatch(
            tokens=tokens,
            resp_mask=resp_mask,
            advantages=adv.astype(np.float32),
            rewards=rewards,
            responses=outs,
            problems=probs,
            stats=stats,
            gen_time_s=time.perf_counter() - t0,
        )
