"""Sharded cross-worker history service (multi-worker pooled drafting).

With N rollout workers each keeping a private ``RolloutHistoryStore``,
every drafter sees only 1/N of the epoch's trajectories — exactly the
thin-history regime where acceptance decays. This module pools the
fleet's rollout stream: a set of **shards**, each owning a contiguous
problem range and running the existing ``RolloutHistoryStore`` +
``IncrementalIndex`` behind a lightweight length-prefixed msgpack/JSON
socket RPC (``history/wire.py``).

Data flow (all workers, all shards):

* **publish** (worker → shard, async): fire-and-forget batches of
  finished rollouts + per-problem accept/length telemetry, sequenced per
  client session so at-least-once delivery dedupes exactly-once
  (``HistoryClient`` keeps a bounded outbox; the verify round never
  stalls on the service).
* **sync** (worker ← shard, pull): version-gated **packed-forest
  deltas**. Shards repack mutated trees off the hot path
  (``SuffixTree.pack()``) and hand out only packs the client has not
  seen (per-key ``(tree version, epoch)`` gating + a monotone delta
  sequence cursor), so workers draft from a globally-warm forest
  without ever walking a remote tree per round. The same response
  carries pooled length/accept telemetry (origin-filtered so a worker
  never re-applies its own observations).
* **crash/restart**: a shard advertises a random ``generation`` token;
  restoring from a snapshot changes it, which makes clients drop their
  pack caches and delta cursors and do a full resync. Telemetry
  sequence numbers and per-session publish cursors persist in the
  snapshot, so replayed publish batches stay deduped across restarts.

Shards are transport-agnostic state machines (``HistoryShard``) wrapped
by a thread-per-connection socket server (``ShardServer``); the
``HistoryService`` launcher runs them in-process (tests, trainer) or as
subprocesses (``python -m repro_torch.history.service``, real runs).
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import os
import socket
import subprocess
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.fault.clock import Clock, SystemClock
from repro_torch.fault.supervisor import AddressBook

from . import wire
from .incremental import IncrementalIndex, apply_rollout
from .store import RolloutHistoryStore

SHARD_SCHEMA_VERSION = 2


# -- shard map --------------------------------------------------------------
def shard_for(key, n_shards: int, n_problems: Optional[int] = None) -> int:
    """Owning shard of a problem key.

    Integer keys with a declared problem universe map to **contiguous
    ranges** (shard s owns problems [s*P/N, (s+1)*P/N)); integer keys
    without one fall back to modulo, and string keys to a stable digest
    (process-seed-independent — ``hash()`` would shard differently per
    worker). Every participant (shards, clients, persistence) must use
    the same ``(n_shards, n_problems)`` pair.
    """
    if n_shards <= 1:
        return 0
    if isinstance(key, (int, np.integer)) and not isinstance(key, bool):
        k = int(key)
        if n_problems is not None and 0 <= k < int(n_problems):
            return min(k * n_shards // int(n_problems), n_shards - 1)
        return k % n_shards
    digest = hashlib.md5(repr(key).encode("utf-8")).digest()
    return int.from_bytes(digest[:4], "big") % n_shards


def _state_decay(state: Dict[str, Any]) -> float:
    """Epoch decay of a shard (or legacy schema-1 history) payload."""
    return float(state.get(
        "epoch_decay",
        state.get("drafter", {}).get("cfg", {}).get("epoch_decay", 0.9),
    ))


def merge_store_states(states: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Union the per-problem logs of several shard (or legacy) payloads
    into ONE ``RolloutHistoryStore`` state dict. Shard key spaces are
    disjoint by construction; if a key somehow appears twice (e.g. a
    legacy payload mixed with shards), the log with the larger doc_id
    cursor wins — it strictly supersedes the other."""
    problems: Dict[Any, Any] = {}
    window = 1
    epoch = iteration = 0
    for st in states:
        store = st["store"]
        window = max(window, int(store["window_size"]))
        epoch = max(epoch, int(store["epoch"]))
        iteration = max(iteration, int(store["iteration"]))
        for key, log in store["problems"]:
            cur = problems.get(key)
            if cur is None or int(log["next_doc_id"]) > int(cur["next_doc_id"]):
                problems[key] = log
    return {
        "window_size": window,
        "epoch": epoch,
        "iteration": iteration,
        "problems": [[k, v] for k, v in problems.items()],
    }


def reshard_states(
    states: Sequence[Dict[str, Any]],
    n_shards: int,
    n_problems: Optional[int] = None,
) -> List[Dict[str, Any]]:
    """Adapt persisted shard snapshots to the CURRENT service geometry.

    Unchanged geometry (same shard count, states saved for it) passes
    through untouched — telemetry logs and publish-dedup cursors
    survive. A changed geometry (different shard count, or a legacy
    single-store payload) re-routes every problem log through the
    current ``shard_for`` map, so a key can never end up owned by two
    shards (which would let the client's version gate shadow one half
    of its history nondeterministically). A reshard is a restart
    boundary: telemetry logs and dedup cursors are dropped, clients
    full-resync against the fresh shard generations.
    """
    states = list(states)
    n_shards = int(n_shards)
    # None entries are quarantined (corrupt) shard files: with unchanged
    # geometry they pass through and that shard cold-starts; otherwise
    # the surviving shards merge and re-route as usual.
    present = [st for st in states if st is not None]
    if len(states) == n_shards and all(
        int(st.get("n_shards", -1)) == n_shards for st in present
    ):
        return states
    if not present:
        return [None] * n_shards
    merged = merge_store_states(present)
    buckets: List[List] = [[] for _ in range(n_shards)]
    for key, log in merged["problems"]:
        buckets[shard_for(key, n_shards, n_problems)].append([key, log])
    decay = _state_decay(present[0])
    return [
        {
            "schema_version": SHARD_SCHEMA_VERSION,
            "kind": "history_shard",
            "shard_id": i,
            "n_shards": n_shards,
            "window_size": merged["window_size"],
            "epoch_decay": decay,
            "store": {
                "window_size": merged["window_size"],
                "epoch": merged["epoch"],
                "iteration": merged["iteration"],
                "problems": buckets[i],
            },
        }
        for i in range(n_shards)
    ]


# -- shard state machine ----------------------------------------------------
class HistoryShard:
    """One shard: store + live trees + delta/telemetry replication state.

    Transport-free and single-threaded by contract (``ShardServer``
    serializes access with a lock); every public method is an RPC
    handler body.
    """

    def __init__(
        self,
        shard_id: int = 0,
        n_shards: int = 1,
        window_size: int = 16,
        epoch_decay: float = 0.9,
        tel_log_cap: int = 1 << 15,
    ) -> None:
        self.shard_id = int(shard_id)
        self.n_shards = int(n_shards)
        self.window_size = int(window_size)
        self.epoch_decay = float(epoch_decay)
        self.store = RolloutHistoryStore(window_size=self.window_size)
        self.index = IncrementalIndex(epoch_decay=self.epoch_decay)
        # Changes on every construction (including snapshot restore):
        # clients detect it and full-resync their pack caches.
        self.generation = os.urandom(8).hex()
        self._dirty: set = set()
        self._delta_seq = 0
        self._deltas: Dict[Any, Dict[str, Any]] = {}  # key -> latest delta
        self._delta_ver: Dict[Any, Tuple[int, int]] = {}
        self._tel_seq = 0
        self._tel: Deque[Dict[str, Any]] = collections.deque()
        self.tel_log_cap = int(tel_log_cap)
        # Optional flight recorder (repro_torch.obs.flight): publish frames
        # carrying a trace field stamp a shard-side ``publish`` event
        # onto the rollout's fleet-wide trace.
        self.flight = None
        # session -> last applied publish seq (exactly-once over
        # at-least-once retries; persisted so restarts stay deduped)
        self._last_pub: Dict[str, int] = {}
        self.stats: collections.Counter = collections.Counter()

    # -- publish -----------------------------------------------------------
    def publish(
        self,
        session: str,
        origin: str,
        seq: Optional[int],
        rollouts: Sequence[Dict[str, Any]] = (),
        drafts: Sequence[Dict[str, Any]] = (),
        epoch: Optional[int] = None,
        dropped: int = 0,
    ) -> Dict[str, Any]:
        """Apply one publish batch (idempotent per ``(session, seq)``)."""
        if seq is not None:
            last = self._last_pub.get(session, -1)
            if int(seq) <= last:
                self.stats["dup_batches"] += 1
                return {"ok": True, "dup": True}
            self._last_pub[session] = int(seq)
        if dropped:
            # Outbox-overflow drops the client reported with this batch.
            # Counted only on fresh (non-dup) batches: the client clears
            # its unreported counter exactly when this batch acks, so a
            # lost-reply resend never double-counts.
            self.stats["client_dropped_batches"] += int(dropped)
        if epoch is not None:
            self._begin_epoch(int(epoch))
        for r in rollouts:
            key = r["key"]
            rlen = r.get("rlen")
            apply_rollout(
                self.store, self.index, key, r["tokens"], r["epoch"],
                response_len=rlen,
            )
            self._dirty.add(key)
            self.stats["rollouts"] += 1
            # Optional trace field (flight recorder): absent from
            # old-schema frames — ``r.get`` keeps them parsing.
            tr = r.get("trace")
            if tr is not None:
                self.stats["traced_rollouts"] += 1
                if self.flight is not None and self.flight.enabled:
                    self.flight.record(
                        str(tr), "publish", origin=origin, key=str(key),
                        tokens=len(r["tokens"]),
                    )
            if rlen is not None:
                ent = {"origin": origin, "key": key, "len": int(rlen)}
                if tr is not None:
                    ent["trace"] = str(tr)  # sync frames carry it back
                self._tel_push(ent)
        for d in drafts:
            self.store.record_draft(d["key"], d["drafted"], d["accepted"])
            self._tel_push({
                "origin": origin, "key": d["key"],
                "drafted": int(d["drafted"]), "accepted": int(d["accepted"]),
            })
        self.stats["pub_batches"] += 1
        return {"ok": True}

    def _tel_push(self, entry: Dict[str, Any]) -> None:
        self._tel_seq += 1
        entry["seq"] = self._tel_seq
        self._tel.append(entry)
        while len(self._tel) > self.tel_log_cap:
            # Bounded log: a cursor older than the trim point silently
            # loses pooled telemetry (a warm-up accelerant, not
            # authoritative state — the store keeps its own tail).
            self._tel.popleft()
            self.stats["tel_trimmed"] += 1

    def _begin_epoch(self, epoch: int) -> None:
        if epoch <= self.store.epoch:
            return
        self.store.begin_iteration(epoch)
        self.index.begin_epoch(epoch)
        if self.epoch_decay != 1.0:
            # Decayed best_child weights are baked into packs: an epoch
            # move changes every tree's pack, so rebroadcast them all.
            self._dirty.update(self.index.trees.keys())
        self.stats["epochs"] += 1

    # -- delta replication -------------------------------------------------
    def repack(self) -> int:
        """Pack every mutated tree into a fresh delta (off the worker's
        hot path: runs shard-side, before building a sync response)."""
        n = 0
        for key in list(self._dirty):
            self._dirty.discard(key)
            tree = self.index.tree(key)
            if tree is None:
                if not self.store.window(key):
                    continue
                tree = self.index.rebuild(
                    key, self.store.window(key), epoch=self.store.epoch
                )
            pk = tree.pack()
            ver = (int(pk.version), int(pk.epoch))
            if self._delta_ver.get(key) == ver:
                continue  # e.g. epoch rebroadcast of an unchanged tree
            self._delta_seq += 1
            self._delta_ver[key] = ver
            self._deltas[key] = {
                "seq": self._delta_seq,
                "key": key,
                "ver": list(ver),
                "pack": wire.pack_to_wire(pk),
            }
            self.stats["repacks"] += 1
            n += 1
        return n

    def sync(
        self,
        session: str,
        origin: str,
        delta_cursor: int = 0,
        tel_cursor: int = 0,
    ) -> Dict[str, Any]:
        """Deltas + pooled telemetry the caller has not seen yet."""
        self.repack()
        deltas = sorted(
            (d for d in self._deltas.values() if d["seq"] > int(delta_cursor)),
            key=lambda d: d["seq"],
        )
        tel = [
            t for t in self._tel
            if t["seq"] > int(tel_cursor) and t["origin"] != origin
        ]
        self.stats["syncs"] += 1
        return {
            "ok": True,
            "gen": self.generation,
            "shard_id": self.shard_id,
            "deltas": deltas,
            "tel": tel,
            "delta_cursor": self._delta_seq,
            "tel_cursor": self._tel_seq,
        }

    # -- snapshot / restore ------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """JSON-able snapshot (the shard's persistence payload)."""
        return {
            "schema_version": SHARD_SCHEMA_VERSION,
            "kind": "history_shard",
            "shard_id": self.shard_id,
            "n_shards": self.n_shards,
            "window_size": self.window_size,
            "epoch_decay": self.epoch_decay,
            "store": self.store.state_dict(),
            "tel": [dict(t) for t in self._tel],
            "tel_seq": self._tel_seq,
            "last_pub": [[s, q] for s, q in self._last_pub.items()],
        }

    @classmethod
    def from_state(cls, state: Dict[str, Any]) -> "HistoryShard":
        """Restore from a snapshot: warm trees rebuilt from the persisted
        windows (query-equivalent to the pre-crash live trees), a fresh
        ``generation`` (clients full-resync), telemetry + publish-dedup
        cursors carried over. Accepts legacy single-store history
        payloads (schema 1: just a ``store`` blob) as shard 0 of 1.
        """
        shard = cls(
            shard_id=int(state.get("shard_id", 0)),
            n_shards=int(state.get("n_shards", 1)),
            window_size=int(
                state.get("window_size", state["store"]["window_size"])
            ),
            epoch_decay=_state_decay(state),
        )
        shard.store = RolloutHistoryStore.from_state(state["store"])
        shard.window_size = shard.store.window_size
        for key in shard.store.keys():
            if shard.store.window(key):
                shard.index.rebuild(
                    key, shard.store.window(key), epoch=shard.store.epoch
                )
                shard._dirty.add(key)
        shard._tel_seq = int(state.get("tel_seq", 0))
        for t in state.get("tel", []):
            shard._tel.append(dict(t))
        shard._last_pub = {s: int(q) for s, q in state.get("last_pub", [])}
        return shard


# -- socket server ----------------------------------------------------------
class ShardServer:
    """Thread-per-connection RPC server around one ``HistoryShard``.

    ``fault_hook`` is the chaos-suite injection point (see
    ``repro_torch.fault.inject.FaultPlan.server_hook``): called with the op
    name after every handled request, it may return ``"kill"`` (stop the
    server without replying — a crash mid-RPC), ``"drop"`` (close this
    connection without replying), ``"truncate"`` (send a torn frame), or
    ``("delay", seconds)`` (reply late). ``None`` (the default, and the
    only value in production) replies normally.
    """

    def __init__(
        self, shard: HistoryShard, host: str = "127.0.0.1", port: int = 0,
        fault_hook: Optional[Callable[[str], Any]] = None,
        clock: Optional[Clock] = None,
    ) -> None:
        self.shard = shard
        self.fault_hook = fault_hook
        self.clock = clock or SystemClock()
        self._lock = threading.RLock()  # serializes all shard access
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, port))
        self._lsock.listen(32)
        self.address: Tuple[str, int] = self._lsock.getsockname()[:2]
        self._stop = threading.Event()
        self.stopped = threading.Event()  # set once the listener exits
        self._conns: List[socket.socket] = []
        self._accept_thread: Optional[threading.Thread] = None

    def start(self) -> "ShardServer":
        self._accept_thread = threading.Thread(
            target=self._accept_loop,
            name=f"history-shard{self.shard.shard_id}", daemon=True,
        )
        self._accept_thread.start()
        return self

    def _accept_loop(self) -> None:
        try:
            # settimeout races stop() closing the listener (a server
            # killed immediately after start): that is a clean shutdown,
            # not a thread crash.
            self._lsock.settimeout(0.2)
            while not self._stop.is_set():
                try:
                    sock, _ = self._lsock.accept()
                except socket.timeout:
                    continue
                except OSError:
                    break
                with self._lock:
                    self._conns.append(sock)
                threading.Thread(
                    target=self._serve_conn, args=(sock,), daemon=True
                ).start()
        except OSError:
            pass  # listener closed under us mid-setup
        finally:
            try:
                self._lsock.close()
            except OSError:
                pass
            self.stopped.set()

    def _serve_conn(self, sock: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                msg = wire.recv_msg(sock)
                if msg is None:
                    break
                resp = self._handle(msg)
                # Fault injection AFTER the handler: the shard applied
                # the request but the client never learns — exercising
                # the resend/dedup path, not just clean failures.
                action = (
                    self.fault_hook(msg.get("op"))
                    if self.fault_hook is not None else None
                )
                if action == "kill":
                    self.stop()
                    break
                if action == "drop":
                    break
                if action == "truncate":
                    wire.send_truncated(sock, resp)
                    break
                if isinstance(action, tuple) and action[0] == "delay":
                    self.clock.sleep(float(action[1]))
                wire.send_msg(sock, resp)
                if msg.get("op") == "stop":
                    self.stop()
                    break
        except (OSError, ValueError):
            pass  # peer vanished mid-frame; reconnect is the client's job
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def _handle(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        op = msg.get("op")
        try:
            with self._lock:
                if op == "ping":
                    return {
                        "ok": True, "gen": self.shard.generation,
                        "shard_id": self.shard.shard_id,
                        "n_shards": self.shard.n_shards,
                    }
                if op == "publish":
                    return self.shard.publish(
                        msg["session"], msg["origin"], msg.get("seq"),
                        rollouts=msg.get("rollouts", ()),
                        drafts=msg.get("drafts", ()),
                        epoch=msg.get("epoch"),
                        dropped=msg.get("dropped", 0) or 0,
                    )
                if op == "sync":
                    return self.shard.sync(
                        msg.get("session", ""), msg.get("origin", ""),
                        delta_cursor=msg.get("delta_cursor", 0),
                        tel_cursor=msg.get("tel_cursor", 0),
                    )
                if op == "state":
                    return {"ok": True, "state": self.shard.state_dict()}
                if op == "stats":
                    return {"ok": True, "stats": dict(self.shard.stats)}
                if op == "stop":
                    return {"ok": True}
                return {"ok": False, "error": f"unknown op {op!r}"}
        except Exception as exc:  # dascheck: disable=DAS303 -- the server must outlive arbitrary bad requests; the error is returned to the peer
            return {"ok": False, "error": f"{type(exc).__name__}: {exc}"}

    def stop(self) -> None:
        self._stop.set()
        try:
            self._lsock.close()
        except OSError:
            pass
        with self._lock:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.close()
            except OSError:
                pass


# -- service launcher -------------------------------------------------------
def _spawn_shard_subprocess(i: int, spec: Dict[str, Any]):
    """Launch one shard child per ``spec`` (also the respawn path):
    returns ``(proc, (host, port))`` once the child prints LISTENING."""
    import subprocess
    import sys

    cmd = [
        sys.executable, "-m", "repro_torch.history.service",
        "--shard-id", str(i), "--n-shards", str(spec["n_shards"]),
        "--window-size", str(spec["window_size"]),
        "--epoch-decay", str(spec["epoch_decay"]),
    ]
    if spec.get("load_dir"):
        cmd += ["--load", spec["load_dir"]]
    env = dict(os.environ)
    src_dir = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))
    ))
    env["PYTHONPATH"] = src_dir + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, env=env)
    line = proc.stdout.readline().strip()
    parts = line.split()
    if len(parts) != 3 or parts[0] != "LISTENING":
        proc.terminate()
        raise RuntimeError(
            f"history shard {i} failed to start (got {line!r})"
        )
    return proc, (parts[1], int(parts[2]))


class HistoryService:
    """Launcher/handle for a set of shards (in-process or subprocess).

    ``addresses`` (one ``(host, port)`` per shard, shard order) is the
    only thing a ``HistoryClient`` needs; handing the client ``book``
    instead additionally republishes restarted shards' new addresses
    live. ``shard_alive``/``respawn_shard`` are the hooks a
    ``repro_torch.fault.ShardSupervisor`` drives.
    """

    def __init__(
        self,
        addresses,
        servers: Optional[List[ShardServer]] = None,
        procs: Optional[List] = None,
        n_problems: Optional[int] = None,
        spawn_spec: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.book = (
            addresses if isinstance(addresses, AddressBook)
            else AddressBook([tuple(a) for a in addresses])
        )
        self.servers = servers or []
        self.procs = procs or []
        self.n_problems = n_problems
        self.closed = False
        # How the shards were spawned — enough to respawn one in kind.
        self._spec = dict(spawn_spec or {})

    @property
    def addresses(self) -> List[Tuple[str, int]]:
        return self.book.snapshot()

    @property
    def n_shards(self) -> int:
        return len(self.book)

    # -- telemetry ---------------------------------------------------------
    def attach_telemetry(self, telemetry) -> None:
        """Export per-shard server counters as a callback gauge (read
        only at scrape time; in-process shards only — subprocess shards
        expose theirs through the ``stats`` RPC instead). Idempotent
        per telemetry instance."""
        if getattr(self, "_attached_telemetry", None) is telemetry:
            return
        self._attached_telemetry = telemetry
        telemetry.registry.callback_gauge(
            "das_service_shard_stat",
            "HistoryShard server counters (in-process shards)",
            self._shard_stat_gauge,
        )

    def _shard_stat_gauge(self):
        out = {}
        for i, s in enumerate(self.servers):
            try:
                stats = dict(s.shard.stats)
            except Exception:  # dascheck: disable=DAS303 -- scrape-time gauge: a mid-mutation read must never break /metrics
                continue
            for k, v in stats.items():
                out[(("shard", str(i)), ("key", str(k)))] = float(v)
        return out

    # -- spawning ----------------------------------------------------------
    @classmethod
    def spawn_in_process(
        cls,
        n_shards: int,
        window_size: int = 16,
        epoch_decay: float = 0.9,
        states: Optional[Sequence[Dict[str, Any]]] = None,
        n_problems: Optional[int] = None,
        fault_hooks: Optional[Sequence] = None,
        clock: Optional[Clock] = None,
    ) -> "HistoryService":
        """Shards as daemon threads in this process (tests, trainer)."""
        if states is not None:
            # adapt to the current geometry: a shard-count change (or a
            # legacy single-store payload) re-routes every problem log
            # through the current shard map; None entries (quarantined
            # shard files) cold-start
            states = reshard_states(states, n_shards, n_problems)
        servers = []
        for i in range(int(n_shards)):
            if states is not None and i < len(states) \
                    and states[i] is not None:
                shard = HistoryShard.from_state(states[i])
                shard.shard_id, shard.n_shards = i, int(n_shards)
            else:
                shard = HistoryShard(
                    shard_id=i, n_shards=int(n_shards),
                    window_size=window_size, epoch_decay=epoch_decay,
                )
            hook = fault_hooks[i] if fault_hooks is not None else None
            servers.append(
                ShardServer(shard, fault_hook=hook, clock=clock).start()
            )
        return cls(
            [s.address for s in servers], servers=servers,
            n_problems=n_problems,
            spawn_spec={
                "mode": "thread", "window_size": int(window_size),
                "epoch_decay": float(epoch_decay),
            },
        )

    @classmethod
    def spawn_subprocess(
        cls,
        n_shards: int,
        window_size: int = 16,
        epoch_decay: float = 0.9,
        load_dir: Optional[str] = None,
        n_problems: Optional[int] = None,
    ) -> "HistoryService":
        """Shards as subprocesses (real runs): each child binds port 0
        and reports ``LISTENING host port`` on stdout."""
        spec = {
            "mode": "subprocess", "n_shards": int(n_shards),
            "window_size": int(window_size),
            "epoch_decay": float(epoch_decay),
            "load_dir": load_dir or None,
        }
        procs, addresses = [], []
        for i in range(int(n_shards)):
            proc, addr = _spawn_shard_subprocess(i, spec)
            procs.append(proc)
            addresses.append(addr)
        return cls(
            addresses, procs=procs, n_problems=n_problems, spawn_spec=spec
        )

    # -- supervision -------------------------------------------------------
    def shard_alive(self, i: int) -> bool:
        """Liveness of shard ``i``: listener thread still accepting
        (thread mode) / child process running (subprocess mode). An
        address-only handle has no liveness signal and reports True."""
        if self.servers:
            return not self.servers[i].stopped.is_set()
        if self.procs:
            return self.procs[i].poll() is None
        return True

    def respawn_shard(
        self, i: int, state: Optional[Dict[str, Any]] = None
    ) -> Tuple[str, int]:
        """Replace a dead shard and republish its new address through
        ``book`` (every client resolves addresses there on reconnect).

        Thread mode restarts **warm** by default: the dead server's
        shard state machine is still in memory, so its snapshot — trees,
        telemetry log, and the per-session publish-dedup cursors —
        seeds the replacement, which means outbox batches the fleet
        resends stay exactly-once. The fresh ``generation`` still forces
        a client full resync. Subprocess restarts re-run the original
        spawn spec (cold, or warm from its ``load_dir``); pass ``state``
        to override either.
        """
        if self.servers:
            old = self.servers[i]
            old.stop()
            st = state if state is not None else old.shard.state_dict()
            shard = HistoryShard.from_state(st)
            shard.shard_id, shard.n_shards = i, self.n_shards
            server = ShardServer(
                shard, fault_hook=old.fault_hook, clock=old.clock,
            ).start()
            self.servers[i] = server
            self.book.set(i, server.address)
            return server.address
        if self.procs:
            try:
                self.procs[i].terminate()
                self.procs[i].wait(timeout=2.0)
            except (OSError, subprocess.TimeoutExpired):
                pass  # already dead or wedged; the fresh spawn below replaces it
            proc, addr = _spawn_shard_subprocess(i, self._spec)
            self.procs[i] = proc
            self.book.set(i, addr)
            return addr
        raise RuntimeError(
            "cannot respawn a shard on an address-only service handle"
        )

    # -- management --------------------------------------------------------
    def _rpc(self, address: Tuple[str, int], msg: Dict[str, Any]) -> Dict:
        with socket.create_connection(address, timeout=10.0) as sock:
            wire.send_msg(sock, msg)
            resp = wire.recv_msg(sock)
        if resp is None or not resp.get("ok"):
            raise RuntimeError(
                f"shard rpc {msg.get('op')!r} failed: {resp!r}"
            )
        return resp

    def state_dicts(self) -> List[Dict[str, Any]]:
        """Per-shard snapshots, shard order (local fast path when the
        shards live in this process, RPC otherwise)."""
        if self.servers:
            out = []
            for s in self.servers:
                with s._lock:
                    out.append(s.shard.state_dict())
            return out
        return [
            self._rpc(a, {"op": "state"})["state"] for a in self.addresses
        ]

    def save(self, dir_or_file: str, meta: Optional[Dict] = None) -> str:
        from . import persist

        return persist.save_service_history(
            dir_or_file, self.state_dicts(), meta=meta
        )

    def stop(self) -> None:
        self.closed = True  # tells any supervisor to stand down
        for s in self.servers:
            s.stop()
        for p in self.procs:
            try:
                self._rpc_noraise(p)
            finally:
                p.terminate()
        for p in self.procs:
            try:
                p.wait(timeout=5.0)
            except (OSError, subprocess.TimeoutExpired):
                p.kill()
        self.servers, self.procs = [], []

    def _rpc_noraise(self, proc) -> None:
        # Best-effort orderly stop before terminate(): lets the child
        # close its listener instead of dying mid-frame.
        idx = self.procs.index(proc)
        try:
            self._rpc(self.addresses[idx], {"op": "stop"})
        except (OSError, RuntimeError, ValueError):
            pass  # shutting down anyway; terminate() follows


# -- subprocess entry point -------------------------------------------------
def main() -> None:
    ap = argparse.ArgumentParser(description="history shard server")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--shard-id", type=int, default=0)
    ap.add_argument("--n-shards", type=int, default=1)
    ap.add_argument("--window-size", type=int, default=16)
    ap.add_argument("--epoch-decay", type=float, default=0.9)
    ap.add_argument("--load", default="",
                    help="history dir (sharded manifest or legacy "
                         "history.json) to restore this shard from")
    args = ap.parse_args()

    shard: Optional[HistoryShard] = None
    if args.load:
        from . import persist

        states = reshard_states(
            persist.load_service_history(args.load)["shards"],
            args.n_shards,
        )
        if args.shard_id < len(states) and states[args.shard_id] is not None:
            shard = HistoryShard.from_state(states[args.shard_id])
            shard.shard_id = args.shard_id
            shard.n_shards = args.n_shards
    if shard is None:
        shard = HistoryShard(
            shard_id=args.shard_id, n_shards=args.n_shards,
            window_size=args.window_size, epoch_decay=args.epoch_decay,
        )
    server = ShardServer(shard, host=args.host, port=args.port).start()
    print(f"LISTENING {server.address[0]} {server.address[1]}", flush=True)  # dascheck: disable=DAS304 -- stdout handshake: the spawner parses this line for the bound address
    server.stopped.wait()


if __name__ == "__main__":
    main()
