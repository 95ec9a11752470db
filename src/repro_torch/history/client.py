"""Worker-side client for the sharded history service.

One ``HistoryClient`` per rollout worker. Two independent paths:

* **publish** — ``publish_rollout`` / ``note_draft`` / ``begin_epoch``
  enqueue into a per-shard **bounded outbox** drained by a background
  sender thread: the verify round never blocks on the service. Batches
  carry a per-session monotone sequence number, so the at-least-once
  resend after a reconnect is deduped shard-side to exactly-once. A
  full outbox drops its *oldest* sealed batch — losing old history is
  strictly better than stalling the round or growing without bound;
  drops are counted per shard (``stats["dropped_batches_s<i>"]``),
  reported to the shard's telemetry with the next acked batch, and
  logged once per overflow episode with the episode's count.
* **sync** — pulls version-gated packed-forest deltas + pooled
  length/accept telemetry from every shard. Deltas older than the
  client's per-key ``(tree version, epoch)`` are ignored (stale-delta
  gating); telemetry is origin-filtered shard-side so the worker never
  re-applies its own observations, and merges into whatever
  ``attach()``-ed ``LengthPolicy`` / telemetry store the engine gave us.

Crash/reconnect: every shard has an explicit health state machine
(``repro_torch.fault.health``: HEALTHY → SUSPECT → DOWN → RESYNCING).
Failures mark a shard SUSPECT, repeats confirm DOWN; while DOWN, RPC
attempts are gated by capped exponential backoff with seeded jitter —
the client fails fast (``ShardBackoffError``) instead of paying a
connect timeout per call, and drafting proceeds from bounded-stale
replicas (or the drafter's local fallback trees). The first successful
RPC after DOWN moves the shard to RESYNCING and the next ``sync``
*hedges* the re-sync (an immediate second pull) before marking it
HEALTHY. A changed shard ``generation`` (restart, possibly from a
snapshot) additionally drops that shard's pack cache and delta cursor
and triggers a full resync, after which drafting proceeds exactly as
before the crash (the restored trees are query-equivalent). Addresses
resolve through a shared ``AddressBook`` on every (re)connect, so a
supervisor restarting a shard on a new port republishes it to every
client without coordination.
"""

from __future__ import annotations

import collections
import logging
import os
import socket
import threading
import time
import zlib
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch import obs
from repro_torch.core.suffix_tree import PackedSuffixTree
from repro_torch.fault.clock import Clock, SystemClock
from repro_torch.fault.health import (
    DOWN,
    BackoffPolicy,
    ShardBackoffError,
    ShardHealth,
)
from repro_torch.fault.supervisor import AddressBook

from . import wire
from .service import shard_for

log = logging.getLogger("repro_torch.history.client")


class ClientStats(obs.MirroredCounter):
    """Counter that is also callable: ``client.stats["key"]`` keeps the
    cheap hot-path counters, ``client.stats()`` returns the full
    snapshot (counters + per-shard health/backoff/outbox/drop state).
    Registry-backed once ``attach_telemetry`` wires a sink — every
    increment then also lands in
    ``das_history_client_stat_total{key=...}``."""

    snapshot_fn: Optional[Callable[[], Dict[str, Any]]] = None

    def __call__(self) -> Dict[str, Any]:
        if self.snapshot_fn is not None:
            return self.snapshot_fn()
        return dict(self)


class HistoryClient:
    """RPC client + replication cache for one rollout worker."""

    def __init__(
        self,
        addresses,
        worker_id: str = "w0",
        n_problems: Optional[int] = None,
        outbox_cap: int = 128,
        rpc_timeout: float = 10.0,
        start_sender: bool = True,
        skip_initial_telemetry: bool = False,
        backoff: Optional[BackoffPolicy] = None,
        suspect_after: int = 2,
        clock: Optional[Clock] = None,
    ) -> None:
        # Addresses resolve through a (possibly shared) AddressBook on
        # every connect: a supervisor restarting a shard republishes
        # the new LISTENING address by mutating the book.
        self._book = (
            addresses if isinstance(addresses, AddressBook)
            else AddressBook(list(addresses))
        )
        self.n_shards = len(self._book)
        if self.n_shards < 1:
            raise ValueError("HistoryClient needs at least one shard address")
        self.worker_id = str(worker_id)
        # Session id = worker id + instance nonce: publish dedup must
        # not confuse a *restarted* worker (fresh seq counter) with a
        # retry from the previous incarnation.
        self.session = f"{self.worker_id}:{os.urandom(4).hex()}"
        self.n_problems = n_problems
        self.outbox_cap = int(outbox_cap)
        self.rpc_timeout = float(rpc_timeout)
        self._clock = clock or SystemClock()
        # Fast-forward past telemetry that predates first contact: set
        # by callers that warm their LengthPolicy straight from restored
        # shard snapshots — replaying the shard's persisted telemetry
        # log on top would double-count every peer observation.
        self.skip_initial_telemetry = bool(skip_initial_telemetry)

        n = self.n_shards
        self._socks: List[Optional[socket.socket]] = [None] * n
        self._sock_locks = [threading.Lock() for _ in range(n)]
        self._seq = [0] * n  # guarded-by: self._cv
        self._pending: List[List[Dict[str, Any]]] = [[] for _ in range(n)]  # guarded-by: self._cv
        self._pending_epoch: List[Optional[int]] = [None] * n  # guarded-by: self._cv
        self._outbox: List[Deque[Dict[str, Any]]] = [  # guarded-by: self._cv
            collections.deque() for _ in range(n)
        ]
        self._delta_cur = [0] * n
        self._tel_cur = [0] * n
        self._gen: List[Optional[str]] = [None] * n

        # Per-shard health (HEALTHY/SUSPECT/DOWN/RESYNCING) + capped
        # exponential backoff with jitter seeded by the worker id, so
        # a fleet of clients never probes a dead shard in lockstep.
        seed = zlib.crc32(self.worker_id.encode("utf-8"))
        self.health = [
            ShardHealth(
                i, clock=self._clock, policy=backoff,
                suspect_after=suspect_after, seed=seed,
            )
            for i in range(n)
        ]
        # shard recovered from DOWN -> next sync owes it a hedged pull
        self._need_resync = [False] * n
        # outbox-overflow accounting: drops in the current overflow
        # episode, and drops not yet reported to the shard's telemetry
        self._drop_episode = [0] * n  # guarded-by: self._cv
        self._drops_unreported = [0] * n  # guarded-by: self._cv

        # replicated pack cache (what the drafter drafts from)
        self._packs: Dict[Any, PackedSuffixTree] = {}
        self._pack_ver: Dict[Any, Tuple[int, int]] = {}
        self._pack_shard: Dict[Any, int] = {}
        self._empty_asof: Dict[Any, int] = {}
        self.sync_count = 0

        # telemetry merge targets (engine/drafter attach these)
        self._length_policy = None
        self._tel_store = None

        self.telemetry = obs.NULL
        self._lat_hist: Optional[Dict[str, Any]] = None
        self.stats: ClientStats = ClientStats()
        self.stats.snapshot_fn = self.stats_snapshot
        # bounded: telemetry must not grow with run length (a multi-day
        # run syncs millions of times); the newest window is plenty for
        # percentile reporting
        self.latencies: Dict[str, Deque[float]] = {
            "publish_ms": collections.deque(maxlen=4096),
            "sync_ms": collections.deque(maxlen=4096),
        }

        self._cv = threading.Condition()
        self._closed = False  # guarded-by: self._cv
        self._sender: Optional[threading.Thread] = None
        if start_sender:
            self._sender = threading.Thread(
                target=self._sender_loop,
                name=f"history-sender-{self.worker_id}", daemon=True,
            )
            self._sender.start()

    @property
    def addresses(self) -> List[Tuple[str, int]]:
        return self._book.snapshot()

    # -- wiring ------------------------------------------------------------
    def attach(self, length_policy=None, store=None) -> "HistoryClient":
        """Register pooled-telemetry merge targets: remote response
        lengths flow into ``length_policy.observe`` (so class thresholds
        warm N× faster) and remote accept counters into
        ``store.record_draft`` (fleet-wide acceptance stats)."""
        if length_policy is not None:
            self._length_policy = length_policy
        if store is not None:
            self._tel_store = store
        return self

    def attach_telemetry(self, telemetry) -> "HistoryClient":
        """Wire this client into a telemetry instance: the stat bag
        mirrors into ``das_history_client_stat_total{key=...}``, RPC
        latencies feed ``das_history_rpc_seconds{op=...}``, per-shard
        health / outbox depth export as callback gauges (labeled by
        worker so a fleet can share one registry), and every health
        state transition lands in the event log.

        Idempotent per telemetry instance: launchers attach clients
        explicitly AND the engine's drafter propagates its telemetry to
        its remote — re-attaching the same instance must not register
        the callback gauges twice (duplicate Prometheus series)."""
        if telemetry is self.telemetry:
            return self
        self.telemetry = telemetry
        self.stats.set_sink(telemetry.mirror_sink(
            "das_history_client_stat_total", "HistoryClient counters by key"
        ))
        if not telemetry.enabled:
            self._lat_hist = None
            return self
        fam = telemetry.registry.histogram_family(
            "das_history_rpc_seconds",
            "History-service RPC wall time by op",
            ("op",), buckets=obs.exp_buckets(1e-4, 2.0, 14),
        )
        self._lat_hist = {
            "publish_ms": fam.labels("publish"),
            "sync_ms": fam.labels("sync"),
        }
        telemetry.registry.callback_gauge(
            "das_shard_state",
            "1 for each (worker, shard)'s current health state",
            self._shard_state_gauge,
        )
        telemetry.registry.callback_gauge(
            "das_shard_outbox",
            "Queued publish batches per (worker, shard)",
            self._shard_outbox_gauge,
        )
        wid = self.worker_id

        def on_transition(shard_id: int, old: str, new: str) -> None:
            telemetry.emit(
                "shard_state", worker=wid, shard=shard_id, old=old, new=new
            )

        for h in self.health:
            h.on_transition = on_transition
        return self

    def _shard_state_gauge(self):
        return {
            (("worker", self.worker_id), ("shard", str(i)),
             ("state", h.state)): 1.0
            for i, h in enumerate(self.health)
        }

    def _shard_outbox_gauge(self):
        with self._cv:
            depths = [len(q) for q in self._outbox]
        return {
            (("worker", self.worker_id), ("shard", str(i))): float(d)
            for i, d in enumerate(depths)
        }

    def shard_of(self, key) -> int:
        return shard_for(key, self.n_shards, self.n_problems)

    # -- health (drafter/rollout-facing) -----------------------------------
    def shard_state(self, i: int) -> str:
        return self.health[i].state

    def degraded_for(self, key) -> bool:
        """True while the shard owning ``key`` is DOWN — the drafter
        falls back to its local trees for this key (lower acceptance,
        never a stall, never a token change)."""
        return self.health[self.shard_of(key)].state == DOWN

    # -- publish (fire-and-forget) ----------------------------------------
    def publish_rollout(
        self, key, tokens: Sequence[int], epoch: int,
        response_len: Optional[int] = None,
        trace: Optional[str] = None,
    ) -> None:
        entry = {
            "kind": "roll", "key": key,
            "tokens": [int(t) for t in tokens], "epoch": int(epoch),
            "rlen": None if response_len is None else int(response_len),
        }
        if trace is not None:
            # optional flight-recorder trace context: version-gated by
            # dict tolerance — old shards ignore unknown entry keys, old
            # clients never set it, so mixed fleets keep parsing
            entry["trace"] = str(trace)
        with self._cv:
            self._pending[self.shard_of(key)].append(entry)
            self._cv.notify_all()

    def note_draft(self, key, drafted: int, accepted: int) -> None:
        entry = {
            "kind": "draft", "key": key,
            "drafted": int(drafted), "accepted": int(accepted),
        }
        with self._cv:
            self._pending[self.shard_of(key)].append(entry)
            self._cv.notify_all()

    def begin_epoch(self, epoch: int) -> None:
        with self._cv:
            for i in range(self.n_shards):
                self._pending_epoch[i] = max(
                    int(epoch), self._pending_epoch[i] or 0
                )
            self._cv.notify_all()

    # das: holds-lock(self._cv)
    def _seal_pending_locked(self) -> None:
        """Move pending entries into sealed, sequenced outbox batches
        (called under ``_cv``)."""
        for i in range(self.n_shards):
            if not self._pending[i] and self._pending_epoch[i] is None:
                continue
            entries, self._pending[i] = self._pending[i], []
            epoch, self._pending_epoch[i] = self._pending_epoch[i], None
            batch = {
                "seq": self._seq[i],
                "epoch": epoch,
                "rollouts": [e for e in entries if e["kind"] == "roll"],
                "drafts": [e for e in entries if e["kind"] == "draft"],
            }
            self._seq[i] += 1
            self._outbox[i].append(batch)
            while len(self._outbox[i]) > self.outbox_cap:
                self._outbox[i].popleft()  # bounded: oldest history loses
                self.stats["dropped_batches"] += 1
                self.stats[f"dropped_batches_s{i}"] += 1
                self._drop_episode[i] += 1
                self._drops_unreported[i] += 1

    def _sender_loop(self) -> None:
        while True:
            with self._cv:
                while (
                    not self._closed
                    and not any(self._pending)
                    and not any(self._outbox)
                    and all(e is None for e in self._pending_epoch)
                ):
                    self._cv.wait(timeout=0.5)
                if self._closed and not any(self._pending) \
                        and not any(self._outbox):
                    return
                self._seal_pending_locked()
            made_progress = False
            for i in range(self.n_shards):
                if self._outbox[i] and not self.health[i].should_attempt():  # dascheck: disable=DAS101 -- single-consumer peek: only this thread pops; a stale read only delays one pass
                    # DOWN shard inside its backoff window: keep the
                    # batches queued; the next pass past the deadline
                    # probes with ONE reconnect, not one per batch.
                    continue
                while self._outbox[i]:  # dascheck: disable=DAS101 -- single-consumer peek: only this thread pops, producers only append
                    batch = self._outbox[i][0]  # peek: pop only on ack  # dascheck: disable=DAS101 -- single-consumer peek: the pop below re-checks identity under the lock
                    acked = False
                    dropped = self._drops_unreported[i]  # dascheck: disable=DAS101 -- single-consumer snapshot: only this thread decrements, and only by this snapshot
                    t0 = time.perf_counter()
                    try:
                        self._rpc(i, {
                            "op": "publish",
                            "session": self.session,
                            "origin": self.worker_id,
                            "seq": batch["seq"],
                            "epoch": batch["epoch"],
                            "rollouts": batch["rollouts"],
                            "drafts": batch["drafts"],
                            # overflow drops since the last acked batch:
                            # surfaced in the shard's service telemetry
                            "dropped": dropped,
                        })
                    except OSError:
                        # ShardBackoffError ⊂ OSError: backoff kicked in
                        # mid-drain; either way keep the batch and retry
                        # after the (next) deadline.
                        self.stats["publish_failures"] += 1
                        break
                    except RuntimeError:
                        # Shard *rejected* the batch (bad request, not a
                        # transport failure): retrying forever would jam
                        # the outbox — drop it and move on.
                        self.stats["rejected_batches"] += 1
                    else:
                        dt = time.perf_counter() - t0
                        self.latencies["publish_ms"].append(1e3 * dt)
                        if self._lat_hist is not None:
                            self._lat_hist["publish_ms"].observe(dt)
                        self.stats["published_batches"] += 1
                        acked = True
                    made_progress = True
                    with self._cv:
                        # pop by identity: a cap-overflow drop may have
                        # already evicted the in-flight batch
                        if self._outbox[i] and self._outbox[i][0] is batch:
                            self._outbox[i].popleft()
                        if acked:
                            # settle the drop report under the lock: a
                            # producer may have bumped the counter while
                            # the RPC was in flight, and an unlocked
                            # decrement would lose that increment
                            self._drops_unreported[i] -= dropped
                        if (
                            self._drop_episode[i]
                            and len(self._outbox[i]) < self.outbox_cap
                        ):
                            # The shard caught back up: close the
                            # overflow episode with ONE log line.
                            n_drop, self._drop_episode[i] = \
                                self._drop_episode[i], 0
                            self.stats["overflow_episodes"] += 1
                            log.warning(
                                "history client %s: shard %d outbox "
                                "overflowed; dropped %d oldest publish "
                                "batch(es) this episode",
                                self.worker_id, i, n_drop,
                            )
                        self._cv.notify_all()
            if not made_progress and any(self._outbox):  # dascheck: disable=DAS101 -- single-consumer peek: worst case is one extra 50ms sleep
                # every shard with queued work is down/backed off
                self._clock.sleep(0.05)

    def flush(self, timeout: float = 10.0) -> bool:
        """Block until every pending/outbox publish is acked (tests and
        epoch barriers; the hot path never calls this)."""
        deadline = self._clock.now() + timeout
        with self._cv:
            self._cv.notify_all()
            while any(self._pending) or any(self._outbox) \
                    or any(e is not None for e in self._pending_epoch):
                remaining = deadline - self._clock.now()
                if remaining <= 0:
                    return False
                self._cv.wait(timeout=min(remaining, 0.2))
        return True

    # -- rpc ---------------------------------------------------------------
    def _rpc_once(
        self, i: int, msg: Dict[str, Any], reconnect: bool = False
    ) -> Optional[Dict[str, Any]]:
        sock = self._socks[i]
        if sock is None:
            sock = socket.create_connection(
                self._book.get(i), timeout=self.rpc_timeout
            )
            sock.settimeout(self.rpc_timeout)
            self._socks[i] = sock
            self.stats["reconnects" if reconnect else "connects"] += 1
        wire.send_msg(sock, msg)
        return wire.recv_msg(sock)

    def _rpc(self, i: int, msg: Dict[str, Any]) -> Dict[str, Any]:
        h = self.health[i]
        if not h.should_attempt():
            # DOWN inside the backoff window: fail fast, no socket work.
            self.stats["backoff_skips"] += 1
            raise ShardBackoffError(
                f"shard {i} is down; next probe in {h.retry_in():.3f}s"
            )
        with self._sock_locks[i]:
            self.stats["rpc_attempts"] += 1
            try:
                resp = self._rpc_once(i, msg)
            except socket.timeout:
                # Shard accepted but never replied within rpc_timeout:
                # no immediate retry (it would just double the wait).
                self.stats["rpc_timeouts"] += 1
                self._drop_sock(i)
                h.record_failure()
                raise
            except ValueError:
                # framing error (torn / oversized frame) — transport-
                # level corruption, same treatment as a lost connection
                self.stats["frame_errors"] += 1
                self._drop_sock(i)
                h.record_failure()
                raise
            except OSError:
                self._drop_sock(i)
                # One immediate reconnect attempt: the common failure is
                # a server restart that closed an idle connection.
                try:
                    self.stats["rpc_attempts"] += 1
                    resp = self._rpc_once(i, msg, reconnect=True)
                except socket.timeout:
                    self.stats["rpc_timeouts"] += 1
                    self._drop_sock(i)
                    h.record_failure()
                    raise
                except OSError:
                    self._drop_sock(i)
                    h.record_failure()
                    raise
            if resp is None:
                self._drop_sock(i)
                h.record_failure()
                raise ConnectionError(f"shard {i} closed the connection")
            if h.record_success():
                # first success after DOWN: replica may be stale — owe
                # this shard a (hedged) resync on the next sync()
                self.stats["shard_recoveries"] += 1
                self._need_resync[i] = True
            if not resp.get("ok"):
                raise RuntimeError(
                    f"shard {i} rejected {msg.get('op')!r}: "
                    f"{resp.get('error')}"
                )
            return resp

    def _drop_sock(self, i: int) -> None:
        sock, self._socks[i] = self._socks[i], None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    # -- sync (delta replication) -----------------------------------------
    def _sync_msg(self, i: int) -> Dict[str, Any]:
        return {
            "op": "sync", "session": self.session,
            "origin": self.worker_id,
            "delta_cursor": self._delta_cur[i],
            "tel_cursor": self._tel_cur[i],
        }

    def sync(self) -> int:
        """Pull deltas + pooled telemetry from every shard; returns the
        number of packs applied. Failing shards are skipped — transport
        errors and shard-side rejections alike — and DOWN shards inside
        their backoff window are skipped without any socket work (the
        worker drafts from its last replicated state — bounded
        staleness, never a stall)."""
        applied = 0
        for i in range(self.n_shards):
            h = self.health[i]
            if not h.should_attempt():
                self.stats["sync_skips"] += 1
                continue
            t0 = time.perf_counter()
            try:
                resp = self._rpc(i, self._sync_msg(i))
                if resp["gen"] != self._gen[i]:
                    first = self._gen[i] is None
                    self._gen[i] = resp["gen"]
                    if not first:
                        # Shard restarted: its delta sequence and tree
                        # versions restarted too — drop everything we
                        # replicated from it and re-pull from zero.
                        self.stats["shard_restarts"] += 1
                        for k in [
                            k for k, s in self._pack_shard.items()
                            if s == i
                        ]:
                            self._packs.pop(k, None)
                            self._pack_ver.pop(k, None)
                            self._pack_shard.pop(k, None)
                        self._delta_cur[i] = 0
                        self._tel_cur[i] = min(
                            self._tel_cur[i], int(resp["tel_cursor"])
                        )
                        resp = self._rpc(i, self._sync_msg(i))
                    elif self.skip_initial_telemetry:
                        # first contact already used cursor 0 — just
                        # drop the pre-existing telemetry (the caller
                        # warmed from snapshots); the cursor advance in
                        # _apply_sync fast-forwards past it
                        resp = dict(resp, tel=[])
            except (OSError, RuntimeError, ValueError):
                # ConnectionError ⊂ OSError; RuntimeError = shard-side
                # rejection; ValueError = framing error
                self.stats["sync_failures"] += 1
                continue
            applied += self._apply_sync(i, resp)
            if self._need_resync[i]:
                # Hedged first re-sync after a recovery: one extra pull
                # right away covers deltas racing the probe (e.g. a
                # restarted shard still republishing restored packs) —
                # duplicates are version-gated no-ops.
                self._need_resync[i] = False
                self.stats["hedged_resyncs"] += 1
                try:
                    applied += self._apply_sync(
                        i, self._rpc(i, self._sync_msg(i))
                    )
                except (OSError, RuntimeError, ValueError):
                    self.stats["sync_failures"] += 1
            h.resynced()  # RESYNCING -> HEALTHY once a sync lands
            dt = time.perf_counter() - t0
            self.latencies["sync_ms"].append(1e3 * dt)
            if self._lat_hist is not None:
                self._lat_hist["sync_ms"].observe(dt)
        self.sync_count += 1
        return applied

    def _apply_sync(self, i: int, resp: Dict[str, Any]) -> int:
        applied = 0
        for d in resp.get("deltas", ()):
            if self.apply_delta(i, d):
                applied += 1
        lengths_by_key: Dict[Any, list] = {}
        for t in resp.get("tel", ()):
            if "len" in t:
                lengths_by_key.setdefault(t["key"], []).append(t["len"])
                self.stats["tel_lengths"] += 1
            else:
                if self._tel_store is not None:
                    self._tel_store.record_draft(
                        t["key"], t["drafted"], t["accepted"]
                    )
                self.stats["tel_drafts"] += 1
        if self._length_policy is not None:
            for key, lens in lengths_by_key.items():
                self._length_policy.observe_many(key, lens)
        self._delta_cur[i] = int(resp["delta_cursor"])
        self._tel_cur[i] = int(resp["tel_cursor"])
        return applied

    def apply_delta(self, shard_i: int, delta: Dict[str, Any]) -> bool:
        """Version-gated delta apply: a delta at or below the known
        per-key ``(tree version, epoch)`` is stale and ignored (both
        components are monotone on a given shard generation)."""
        key = delta["key"]
        ver = (int(delta["ver"][0]), int(delta["ver"][1]))
        known = self._pack_ver.get(key)
        if known is not None and ver <= known:
            self.stats["stale_deltas"] += 1
            return False
        self._packs[key] = wire.wire_to_pack(delta["pack"])
        self._pack_ver[key] = ver
        self._pack_shard[key] = shard_i
        self.stats["packs_applied"] += 1
        return True

    # -- drafter-facing view ----------------------------------------------
    def pack_for(self, key) -> Optional[PackedSuffixTree]:
        """Latest replicated pack for ``key`` (identity changes exactly
        when a newer delta lands — the drafter's forest cache keys on
        object identity)."""
        return self._packs.get(key)

    def n_packs(self) -> int:
        """Number of problem keys with a replicated pack."""
        return len(self._packs)

    def sync_if_missing(self, keys) -> None:
        """Cold-start helper for the dispatch path: sync only when a
        needed key has no replicated pack AND we have not already
        confirmed it empty as of the current sync — so a problem with no
        history costs one RPC per sync generation, not one per round."""
        missing = [
            k for k in keys
            if k not in self._packs
            and self._empty_asof.get(k) != self.sync_count
        ]
        if not missing:
            return
        self.sync()
        for k in missing:
            if k not in self._packs:
                self._empty_asof[k] = self.sync_count

    # -- introspection -----------------------------------------------------
    def stats_snapshot(self) -> Dict[str, Any]:
        """Counters + per-shard health/backoff/outbox/drop view (what
        ``client.stats()`` returns)."""
        with self._cv:
            outbox = [len(q) for q in self._outbox]
            pending = [len(p) for p in self._pending]
        snap: Dict[str, Any] = dict(self.stats)
        snap["shards"] = {
            i: {
                **self.health[i].snapshot(),
                "address": tuple(self._book.get(i)),
                "outbox": outbox[i],
                "pending_entries": pending[i],
                "dropped_batches": int(
                    self.stats.get(f"dropped_batches_s{i}", 0)
                ),
            }
            for i in range(self.n_shards)
        }
        return snap

    # -- lifecycle ---------------------------------------------------------
    def close(self, flush_timeout: float = 5.0) -> int:
        """Flush and shut down. Returns the number of publish batches
        that could NOT be flushed (0 on a clean close); a non-zero count
        is also logged per shard — shutdown data loss must be visible,
        not silently swallowed with ``flush()``'s return value."""
        flushed = self.flush(timeout=flush_timeout)
        with self._cv:
            self._closed = True
            unflushed = [
                len(self._outbox[i]) + (
                    1 if (self._pending[i]
                          or self._pending_epoch[i] is not None) else 0
                )
                for i in range(self.n_shards)
            ]
            self._cv.notify_all()
        total = 0 if flushed else sum(unflushed)
        if total:
            for i, n_un in enumerate(unflushed):
                if n_un:
                    log.warning(
                        "history client %s: closing with %d unflushed "
                        "publish batch(es) for shard %d (%s) — that "
                        "history is lost",
                        self.worker_id, n_un, i, self.health[i].state,
                    )
            self.stats["unflushed_batches"] += total
        if self._sender is not None:
            self._sender.join(timeout=2.0)
        for i in range(self.n_shards):
            self._drop_sock(i)
        return total
