"""Deterministic fault-injection harness for the chaos suite.

A seeded ``FaultPlan`` is a declarative list of faults that fire at
exact, countable points — the *k*-th publish a shard handles, the *n*-th
check a watchdog runs, the *j*-th rollout call a worker serves — so a
chaos test replays bit-identically with no wall-clock coupling:

* **shard faults** (``kill_shard`` / ``drop_frame`` / ``truncate_frame``
  / ``delay_frame``) install as a ``ShardServer.fault_hook``: after the
  server handles the chosen op for the chosen time, the hook returns an
  action — crash the server without replying, drop the reply, send a
  torn frame (4-byte header promising more payload than follows), or
  delay the reply past the client's ``rpc_timeout``.
* **worker faults** (``FlakyWorker``) wrap a ``RolloutWorker`` and raise
  ``StallError`` on chosen call indices — the deterministic stand-in
  for a hung worker whose watchdog expired.
* **watchdog faults** (``stall_watchdog``) hook a ``RolloutWatchdog``
  running on a ``VirtualClock`` and advance the clock past the deadline
  at a chosen check count — a stuck verify round, with zero sleeps.
* **journal faults** (``crash_journal``) install as a
  ``RolloutJournal.fault_hook``: die right after the *k*-th group
  commit — ``mode="raise"`` throws into the serving loop (the
  in-process stand-in for a dying worker; ``MultiWorkerRollout``
  salvages the journaled tokens), ``mode="exit"`` is ``os._exit`` for
  subprocess crash-recovery tests. ``tear_journal_tail`` rips bytes off
  the file's final frame (power loss mid-commit).
* **file faults** (``truncate_json_file`` / ``garble_json_file``)
  corrupt persisted history files in place for the quarantine tests.

Every fault that fires is appended to ``plan.fired`` so tests can
assert the plan actually exercised what it claims to.
"""

from __future__ import annotations

import collections
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from .watchdog import RolloutWatchdog, StallError

# Shard-hook actions (returned to ShardServer._serve_conn):
KILL = "kill"          # stop the server, no reply (crash mid-RPC)
DROP = "drop"          # close this connection, no reply
TRUNCATE = "truncate"  # reply with a torn frame, then close
# ("delay", seconds)   # sleep server-side, then reply normally


class JournalCrashError(RuntimeError):
    """Injected worker death at a journal commit point (RuntimeError so
    ``MultiWorkerRollout``'s failure path catches it like a real one)."""


class FaultPlan:
    """Seeded, countable fault schedule."""

    def __init__(self, seed: int = 0, telemetry=None) -> None:
        from repro_torch import obs

        self.seed = int(seed)
        self.telemetry = telemetry if telemetry is not None else obs.NULL
        # (shard, op) -> {count k -> action}; ops counted per shard.
        self._shard_faults: Dict[Tuple[int, str], Dict[int, Any]] = {}
        # journal commit count -> crash mode ("raise" | "exit")
        self._journal_faults: Dict[int, str] = {}
        self._counts: collections.Counter = collections.Counter()
        self._lock = threading.Lock()
        self.fired: List[Dict[str, Any]] = []

    def _record(self, rec: Dict[str, Any]) -> None:
        """Append to ``fired`` (caller holds the lock) and mirror into
        the structured event log."""
        self.fired.append(rec)
        if self.telemetry.enabled:
            # rec's "kind" field would shadow emit()'s event kind
            self.telemetry.emit(
                "fault_injected",
                **{("fault" if k == "kind" else k):
                   (v if isinstance(v, (int, float, str)) else str(v))
                   for k, v in rec.items()},
            )

    # -- declaration -------------------------------------------------------
    def kill_shard(self, shard: int, *, op: str = "publish",
                   at: int = 1) -> "FaultPlan":
        """Crash shard ``shard`` right after it handles its ``at``-th
        ``op`` (1-based), before the reply is sent — the client sees a
        dead connection with the batch applied, exercising the
        at-least-once resend / exactly-once dedup path."""
        return self._add(shard, op, at, KILL)

    def drop_frame(self, shard: int, *, op: str = "sync",
                   at: int = 1) -> "FaultPlan":
        return self._add(shard, op, at, DROP)

    def truncate_frame(self, shard: int, *, op: str = "sync",
                       at: int = 1) -> "FaultPlan":
        return self._add(shard, op, at, TRUNCATE)

    def delay_frame(self, shard: int, *, op: str = "sync", at: int = 1,
                    delay_s: float = 0.05) -> "FaultPlan":
        return self._add(shard, op, at, ("delay", float(delay_s)))

    def _add(self, shard: int, op: str, at: int, action) -> "FaultPlan":
        key = (int(shard), str(op))
        self._shard_faults.setdefault(key, {})[int(at)] = action
        return self

    # -- shard-server hook -------------------------------------------------
    def server_hook(self, shard: int) -> Callable[[str], Any]:
        """Hook for ``ShardServer(fault_hook=...)``: counts handled ops
        and returns the scheduled action (or None) for this call."""
        shard = int(shard)

        def hook(op: str):
            with self._lock:
                self._counts[(shard, op)] += 1
                k = self._counts[(shard, op)]
                action = self._shard_faults.get((shard, op), {}).pop(k, None)
                if action is not None:
                    self._record({
                        "kind": "shard", "shard": shard, "op": op,
                        "at": k, "action": action,
                    })
            return action

        return hook

    def pending(self) -> int:
        """Faults declared but not yet fired (shard faults only)."""
        with self._lock:
            return sum(len(d) for d in self._shard_faults.values())

    # -- journal hook ------------------------------------------------------
    def crash_journal(self, *, at: int, mode: str = "raise") -> "FaultPlan":
        """Die right after the journal's ``at``-th group commit
        (1-based). ``mode="raise"`` raises ``JournalCrashError`` into
        the serving loop — the in-process chaos stand-in for a worker
        that crashed with its WAL durable; ``MultiWorkerRollout``
        salvages ``live_sessions()`` and resumes on a survivor.
        ``mode="exit"`` is ``os._exit(9)``: a SIGKILL-grade death for
        subprocess crash-recovery tests (the committed bytes survive in
        the page cache; only the recovery path sees them)."""
        if mode not in ("raise", "exit"):
            raise ValueError(f"unknown crash_journal mode {mode!r}")
        self._journal_faults[int(at)] = mode
        return self

    def journal_hook(self) -> Callable[[int], None]:
        """Hook for ``RolloutJournal(fault_hook=...)``: fires the
        scheduled crash when the commit count matches."""

        def hook(commit: int) -> None:
            with self._lock:
                mode = self._journal_faults.pop(int(commit), None)
                if mode is not None:
                    self._record({
                        "kind": "journal", "at": int(commit), "mode": mode,
                    })
            if mode == "exit":
                os._exit(9)
            if mode == "raise":
                raise JournalCrashError(
                    f"injected journal crash at commit {commit}"
                )

        return hook

    # -- watchdog hook -----------------------------------------------------
    def stall_watchdog(
        self, watchdog: RolloutWatchdog, *, at_check: int,
        advance_s: Optional[float] = None,
    ) -> RolloutWatchdog:
        """Trip ``watchdog`` at its ``at_check``-th check by advancing
        its (virtual) clock past the deadline — a stuck round with no
        real waiting. The clock must expose ``advance`` (VirtualClock)."""
        target = int(at_check)
        jump = (
            float(advance_s) if advance_s is not None
            else watchdog.deadline_s * 2.0
        )

        def on_check(wd: RolloutWatchdog) -> None:
            if wd.checks == target:
                wd.clock.advance(jump)
                with self._lock:
                    self._record({
                        "kind": "watchdog", "at_check": target,
                        "advance_s": jump,
                    })

        watchdog.on_check = on_check
        return watchdog


class FlakyWorker:
    """RolloutWorker proxy that raises ``StallError`` on chosen call
    indices (0-based) — the deterministic stand-in for a worker whose
    round watchdog expired. All other attributes delegate, so
    ``MultiWorkerRollout`` cannot tell it from the real worker."""

    def __init__(self, worker, fail_calls=(0,)) -> None:
        self._worker = worker
        self._fail = {int(c) for c in fail_calls}
        self.calls = 0

    def __getattr__(self, name):
        return getattr(self._worker, name)

    def rollout(self, *args, **kwargs):
        call, self.calls = self.calls, self.calls + 1
        if call in self._fail:
            raise StallError(
                f"injected worker stall on rollout call {call}"
            )
        return self._worker.rollout(*args, **kwargs)


# -- persisted-file corruption ----------------------------------------------
def tear_journal_tail(path: str, drop_bytes: int = 3) -> str:
    """Tear a write-ahead journal mid-frame (power loss during the final
    group commit): drop the last ``drop_bytes`` bytes in place.
    ``RolloutJournal.recover`` must truncate back to the last whole
    frame — losing at most the final un-synced round, never raising."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(0, size - int(drop_bytes)))
    return path


def truncate_json_file(path: str, keep_fraction: float = 0.5) -> str:
    """Truncate a JSON file mid-payload (torn write / torn copy)."""
    with open(path, "rb") as f:
        raw = f.read()
    keep = max(1, min(len(raw) - 1, int(len(raw) * float(keep_fraction))))
    with open(path, "wb") as f:
        f.write(raw[:keep])
    return path

def garble_json_file(path: str, seed: int = 0) -> str:
    """Overwrite a span of the file with seeded garbage bytes (bit rot
    that keeps the length but breaks the JSON)."""
    import random as _random

    rng = _random.Random(int(seed))
    with open(path, "rb") as f:
        raw = bytearray(f.read())
    if raw:
        start = rng.randrange(max(1, len(raw) // 2))
        span = max(1, min(len(raw) - start, 16))
        for j in range(start, start + span):
            raw[j] = rng.randrange(256)
        # Guarantee invalid JSON regardless of where the span landed.
        raw[0:1] = b"\x00"
    with open(path, "wb") as f:
        f.write(bytes(raw))
    return path


class SilentServer:
    """A server that accepts connections and reads requests but never
    replies — the pathological peer behind the ``rpc_timeout`` tests
    (connection succeeds, RPC hangs)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        import socket

        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, port))
        self._lsock.listen(8)
        self.address = self._lsock.getsockname()[:2]
        self._stop = threading.Event()
        self._conns: List[Any] = []
        self.n_requests = 0
        self._thread = threading.Thread(
            target=self._loop, name="silent-server", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        import socket

        self._lsock.settimeout(0.1)
        while not self._stop.is_set():
            try:
                sock, _ = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            self._conns.append(sock)
            threading.Thread(
                target=self._drain, args=(sock,), daemon=True
            ).start()

    def _drain(self, sock) -> None:
        # Read (and discard) whatever arrives; never send a byte back.
        try:
            while not self._stop.is_set():
                if not sock.recv(4096):
                    break
                self.n_requests += 1
        except OSError:
            pass

    def close(self) -> None:
        self._stop.set()
        try:
            self._lsock.close()
        except OSError:
            pass
        for c in self._conns:
            try:
                c.close()
            except OSError:
                pass
        self._thread.join(timeout=1.0)
