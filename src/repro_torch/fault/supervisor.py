"""Shard supervisor: health-check, restart, republish addresses.

``ShardSupervisor`` watches a ``HistoryService``'s shards (in-process
``ShardServer`` threads or subprocesses), restarts dead ones with
capped exponential backoff + seeded jitter, and republishes the new
LISTENING address through the service's shared ``AddressBook`` — the
clients' next reconnect dials the new address, sees a fresh shard
``generation`` and full-resyncs. Thread-mode restarts are warm (the
dead server's shard state machine is still in memory and is snapshotted
into the replacement — publish-dedup cursors survive, so resent outbox
batches stay exactly-once); subprocess restarts are cold or warm from
``--load`` state, exactly like a fresh spawn.

``poll()`` is the synchronous core (deterministic under a
``VirtualClock``); ``start(interval_s)`` wraps it in a daemon thread
for real runs. The rollout layer also polls opportunistically — once
per ``MultiWorkerRollout`` call and between flush-barrier retries — so
a fleet without the background thread still self-heals at step
granularity.
"""

from __future__ import annotations

import logging
import random
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch import obs

from .clock import Clock, SystemClock
from .health import BackoffPolicy

log = logging.getLogger("repro_torch.fault.supervisor")


class AddressBook:
    """Mutable, thread-safe shard address table shared by the service,
    the supervisor and every client. A ``HistoryClient`` resolves the
    address on every (re)connect, so a supervisor ``set`` after a
    restart republishes the new LISTENING address to the whole fleet
    without any client-side coordination."""

    def __init__(self, addresses: Sequence[Tuple[str, int]]) -> None:
        self._addrs: List[Tuple[str, int]] = [  # guarded-by: self._lock
            (str(h), int(p)) for h, p in addresses
        ]
        self._lock = threading.Lock()
        self.version = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._addrs)

    def get(self, i: int) -> Tuple[str, int]:
        with self._lock:
            return self._addrs[i]

    def set(self, i: int, address: Tuple[str, int]) -> None:
        with self._lock:
            self._addrs[i] = (str(address[0]), int(address[1]))
            self.version += 1

    def snapshot(self) -> List[Tuple[str, int]]:
        with self._lock:
            return list(self._addrs)


class ShardSupervisor:
    """Restart dead shards of one ``HistoryService`` with backoff."""

    def __init__(
        self,
        service,
        *,
        clock: Optional[Clock] = None,
        policy: Optional[BackoffPolicy] = None,
        seed: int = 0,
        max_restarts: Optional[int] = None,
        snapshot_provider: Optional[Callable[[int], Optional[Dict]]] = None,
        telemetry=None,
    ) -> None:
        self.service = service
        self.telemetry = (
            telemetry if telemetry is not None else obs.get_telemetry()
        )
        self.clock = clock or SystemClock()
        # Restarts are heavyweight next to RPC retries: back off slower.
        self.policy = policy or BackoffPolicy(base_s=0.5, max_s=30.0)
        self.max_restarts = max_restarts  # None = unbounded
        # Override where restart state comes from (tests inject states;
        # None defers to the service's own warm/cold restart logic).
        self.snapshot_provider = snapshot_provider
        n = service.n_shards
        self._rng = [
            random.Random((int(seed) << 16) ^ i) for i in range(n)
        ]
        # one poll at a time: the background thread and the rollout
        # layer's opportunistic polls must not race a double-restart
        self._poll_lock = threading.Lock()
        self._attempts = [0] * n  # guarded-by: self._poll_lock
        self._next_try = [0.0] * n  # guarded-by: self._poll_lock
        # Counter-shaped view mirrored into the registry (the existing
        # ``sup.stats["restarts"]`` reads keep working unchanged).
        self.stats = obs.MirroredCounter(
            sink=self.telemetry.mirror_sink(
                "das_supervisor_stat_total", "ShardSupervisor counters"
            )
        )
        self.telemetry.registry.callback_gauge(
            "das_service_shard_alive",
            "1 while the supervised shard's server is alive",
            self._alive_gauge,
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _alive_gauge(self):
        return {
            (("shard", str(i)),): float(self.service.shard_alive(i))
            for i in range(self.service.n_shards)
        }

    # -- liveness ----------------------------------------------------------
    def alive(self, i: int) -> bool:
        return self.service.shard_alive(i)

    # -- the synchronous core ----------------------------------------------
    def poll(self, force: bool = False) -> List[int]:
        """Health-check every shard; restart dead ones whose backoff
        deadline passed (``force=True`` ignores the deadline — used by
        the flush-barrier retry path where waiting out a backoff window
        would just burn the flush timeout). Returns restarted shard
        ids."""
        self.stats["polls"] += 1
        if getattr(self.service, "closed", False):
            return []
        with self.telemetry.span("supervisor_probe"):
            with self._poll_lock:
                restarted = self._poll_once(force)
        return restarted

    # das: holds-lock(self._poll_lock)
    def _poll_once(self, force: bool) -> List[int]:
        restarted: List[int] = []
        now = self.clock.now()
        for i in range(self.service.n_shards):
            if self.alive(i):
                self._attempts[i] = 0
                self._next_try[i] = 0.0
                continue
            if not force and now < self._next_try[i]:
                continue
            if (
                self.max_restarts is not None
                and self._attempts[i] >= self.max_restarts
            ):
                self.stats["gave_up"] += 1
                continue
            self._attempts[i] += 1
            state = (
                self.snapshot_provider(i)
                if self.snapshot_provider is not None else None
            )
            try:
                addr = self.service.respawn_shard(i, state=state)
            except Exception as exc:  # dascheck: disable=DAS303 -- a restart failure is recorded and retried; it must not kill supervision
                self.stats["restart_failures"] += 1
                self.telemetry.emit(
                    "shard_restart_failed", shard=i,
                    attempt=self._attempts[i], error=str(exc),
                )
                self._next_try[i] = self.clock.now() + self.policy.delay(
                    self._attempts[i], self._rng[i]
                )
                log.warning(
                    "shard %d restart attempt %d failed (%s); next try "
                    "in %.2fs", i, self._attempts[i], exc,
                    self._next_try[i] - self.clock.now(),
                )
                continue
            self.stats["restarts"] += 1
            self.telemetry.emit("shard_restart", shard=i, address=str(addr))
            self._attempts[i] = 0
            self._next_try[i] = 0.0
            restarted.append(i)
            log.warning(
                "shard %d was dead; restarted at %s (address republished "
                "to clients)", i, addr,
            )
        return restarted

    # -- optional background loop ------------------------------------------
    def start(self, interval_s: float = 1.0) -> "ShardSupervisor":
        if self._thread is not None:
            return self
        self._stop.clear()

        def _loop() -> None:
            while not self._stop.wait(timeout=float(interval_s)):
                try:
                    self.poll()
                except Exception:  # dascheck: disable=DAS303 -- never kill the supervisor thread
                    self.stats["poll_errors"] += 1

        self._thread = threading.Thread(
            target=_loop, name="shard-supervisor", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
