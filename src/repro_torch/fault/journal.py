"""Write-ahead token journal: crash-durable progress for in-flight
rollouts.

The paper's long-tail argument cuts both ways: a handful of long
trajectories dominate rollout makespan, so losing a half-finished
10k-token straggler to a crash (and regenerating it from token zero) is
the single most expensive failure the system can have. At temperature 0
the engine is deterministic from any prefix, which makes journaled
progress *perfectly* resumable: re-prefill ``prompt + salvaged tokens``
and the continuation is token-identical to the uninterrupted run.

One ``RolloutJournal`` is an append-only file of CRC-framed records:

* ``begin``  — session key, prompt tokens, problem id, token limit;
* ``round``  — session key, round seq, the tokens that round emitted;
* ``finish`` — session key, terminal status, final emitted count.

The serving loop buffers records with ``begin``/``note``/``finish``
(pure list appends, no I/O) and **group-commits once per verify round**
from the post-consume host window via ``commit()`` — one unbuffered
``write`` per round (so the bytes survive a SIGKILL the instant the
syscall returns), with ``fsync`` batched every ``fsync_every`` commits
(power-loss durability is paid off the per-round path). dascheck DAS005
statically enforces that this is the *only* file I/O reachable from a
``# das: hot-path`` round loop.

Recovery (``RolloutJournal.recover``) replays the frames into
per-session token prefixes. Durability semantics match
``history/persist.py``: a torn tail (short frame / bad CRC at EOF —
the signature of a crash mid-append) is truncated in place and loses at
most the final un-synced round; corruption *before* the tail (bit rot
in an append-only file) quarantines the whole file to
``<name>.corrupt`` and raises ``JournalCorruptError``; a well-formed
header from a FUTURE schema raises ``JournalError`` and leaves the file
untouched (a newer build's valid journal must survive a rollback).
"""

from __future__ import annotations

import json
import os
import struct
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from repro_torch.history.persist import _quarantine

SCHEMA_VERSION = 1
_FRAME = struct.Struct("<II")  # (payload_len, crc32(payload))
_MAX_FRAME = 1 << 26  # 64 MiB: any larger length prefix is garbage

# Terminal statuses recorded by ``finish``; anything absent from a
# session's replay means it was in flight when the process died.
FINISHED = "finished"
CANCELLED = "cancelled"
EXPIRED = "expired"


class JournalError(RuntimeError):
    """A journal file cannot be used (unknown schema, closed writer)."""


class JournalCorruptError(JournalError):
    """Corruption before the tail of a journal file. The offending file
    has been quarantined (``<name>.corrupt``) by the time this
    propagates — the torn-*tail* case never raises; it truncates and
    loses at most the final un-synced round."""


@dataclass
class JournalSession:
    """Replay state for one journaled rollout session."""

    key: str
    prompt: List[int] = field(default_factory=list)
    problem_id: Any = None
    max_new_tokens: int = 0
    tokens: List[int] = field(default_factory=list)  # salvaged output
    rounds: int = 0  # round records replayed
    finished: bool = False
    status: str = ""  # finish status ("" while in flight)
    # Flight-recorder trace ID (repro_torch.obs.flight): carried through
    # crash→recover→resume so the continuation extends the SAME trace.
    trace: Optional[str] = None

    @property
    def resumable(self) -> bool:
        """In flight at crash time with salvageable progress semantics:
        finished/cancelled/expired sessions must not be re-served."""
        return not self.finished


def _encode(rec: Dict[str, Any]) -> bytes:
    payload = json.dumps(rec, separators=(",", ":")).encode()
    return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload


def _encode_round(esc_key: str, seq: int, toks: List[int]) -> bytes:
    # Hand-built frame for the one record shape emitted every round:
    # ~4x cheaper than json.dumps, byte-compatible with _decode's
    # json.loads (``esc_key`` is pre-escaped, tokens are plain ints).
    payload = ('{"k":"r","s":%s,"q":%d,"t":[%s]}' % (
        esc_key, seq, ",".join(map(str, toks))
    )).encode()
    return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload


class RolloutJournal:
    """Per-process write-ahead token journal (append-only, CRC-framed).

    ``begin``/``note``/``finish`` buffer records in memory;
    ``commit()`` group-writes the buffer (the once-per-round call from
    the serve loop's post-consume window). The journal also keeps an
    in-memory mirror of every session it has recorded, so an in-process
    supervisor (``MultiWorkerRollout``) can salvage a failed worker's
    progress via ``live_sessions()`` without re-reading the file.

    ``fault_hook`` (``FaultPlan.journal_hook()``) is called after every
    committed group write with the 1-based commit count — the
    crash-at-kth-journal-append chaos point.
    """

    def __init__(
        self,
        path: str,
        *,
        fsync_every: int = 8,
        telemetry=None,
        fault_hook: Optional[Callable[[int], None]] = None,
    ) -> None:
        from repro_torch import obs

        if fsync_every < 1:
            raise ValueError(f"fsync_every must be >= 1, got {fsync_every}")
        self.path = str(path)
        self.fsync_every = int(fsync_every)
        self.fault_hook = fault_hook
        self.telemetry = telemetry if telemetry is not None else obs.NULL
        tel = self.telemetry
        self._m_appends = tel.counter(
            "das_journal_appends_total",
            "Records group-committed into the write-ahead token journal",
        )
        self._m_fsync = tel.histogram(
            "das_journal_fsync_seconds",
            "Wall time of batched journal fsyncs",
            buckets=obs.TIME_BUCKETS,
        )
        self._fh = None
        self._pending: List[bytes] = []
        self._pending_recs = 0
        self._commits = 0
        self._unsynced = 0
        self._next_seq: Dict[str, int] = {}
        self._esc_keys: Dict[str, str] = {}  # key -> json-escaped key
        self.sessions: Dict[str, JournalSession] = {}
        self._closed = False

    # -- buffered record building (no I/O) -------------------------------
    def begin(
        self,
        key: str,
        prompt: Iterable[int],
        *,
        problem_id: Any = None,
        max_new_tokens: int = 0,
        resume: bool = False,
        trace: Optional[str] = None,
    ) -> None:
        """Open (or re-open) a session.

        ``resume=True`` continues an unfinished session: accumulated
        ``round`` records keep counting (the prefix re-prefill path).
        ``resume=False`` (the default) starts a NEW logical rollout
        under the key — any prior state for it (a finished rollout from
        an earlier training step, or a stale unfinished tail from an
        old crash) resets, so stable per-problem keys never leak tokens
        across steps. The flag is recorded, so replay applies the same
        rule."""
        key = str(key)
        prompt = [int(t) for t in prompt]
        sess = self.sessions.get(key)
        if sess is None:
            sess = self.sessions[key] = JournalSession(key=key)
            self._next_seq.setdefault(key, 0)
        elif not resume or sess.finished:
            sess.tokens = []
            sess.rounds = 0
            self._next_seq[key] = 0
        sess.prompt = prompt
        sess.problem_id = problem_id
        sess.max_new_tokens = int(max_new_tokens)
        sess.finished = False
        sess.status = ""
        if trace is not None:
            sess.trace = str(trace)
        rec: Dict[str, Any] = {"k": "b", "s": key, "p": prompt,
                               "mn": int(max_new_tokens)}
        if resume:
            rec["re"] = 1
        if trace is not None:
            # optional minor add: old readers skip unknown keys, so a
            # traced journal stays replayable by pre-flight builds
            rec["tr"] = str(trace)
        if problem_id is not None:
            rec["pid"] = problem_id if isinstance(
                problem_id, (int, str)) else str(problem_id)
        self._push(rec)

    def note(self, key: str, tokens: Iterable[int]) -> None:
        """Buffer one round's emitted tokens for a session."""
        # Hot: once per accepting slot per round. A plain list is
        # trusted as python ints (the engine feeds ``.tolist()`` rows).
        if type(tokens) is not list:
            tokens = [int(t) for t in tokens]
        if not tokens:
            return
        key = str(key)
        seq = self._next_seq.get(key, 0)
        self._next_seq[key] = seq + 1
        sess = self.sessions.get(key)
        if sess is None:
            sess = self.sessions[key] = JournalSession(key=key)
        sess.tokens.extend(tokens)
        sess.rounds += 1
        esc = self._esc_keys.get(key)
        if esc is None:
            esc = self._esc_keys[key] = json.dumps(key)
        self._pending.append(_encode_round(esc, seq, tokens))
        self._pending_recs += 1

    def finish(
        self, key: str, *, status: str = FINISHED,
        n_emitted: Optional[int] = None,
    ) -> None:
        """Buffer a terminal record. ``n_emitted`` is the final output
        length (round records include the EOS the engine strips on
        finish; replay truncates to this count)."""
        key = str(key)
        sess = self.sessions.get(key)
        if sess is None:
            sess = self.sessions[key] = JournalSession(key=key)
        if n_emitted is not None:
            del sess.tokens[int(n_emitted):]
        sess.finished = True
        sess.status = str(status)
        rec: Dict[str, Any] = {"k": "f", "s": key, "st": str(status)}
        if n_emitted is not None:
            rec["n"] = int(n_emitted)
        self._push(rec)

    def _push(self, rec: Dict[str, Any]) -> None:
        self._pending.append(_encode(rec))
        self._pending_recs += 1

    @property
    def pending_records(self) -> int:
        return self._pending_recs

    # -- group commit ----------------------------------------------------
    # das: hot-path — the serve loop's once-per-round group commit; the
    # sanctioned post-consume write window (DAS005 bans file I/O in every
    # other hot-path function, so journal appends can ONLY flow through
    # here).
    def commit(self) -> int:  # dascheck: disable=DAS006 -- commit latency is already first-class telemetry (das_journal_appends_total / das_journal_fsync_seconds); a span would double-bill inside the consume window
        """Write all buffered records as one unbuffered append
        (crash-safe against SIGKILL the moment ``write`` returns, the
        handle has no userspace buffer); fsync every
        ``fsync_every`` commits (power-loss durability, batched off the
        round path). Returns the number of records committed."""
        if not self._pending:
            return 0
        if self._closed:
            raise JournalError(f"journal {self.path} is closed")
        fh = self._ensure_open()
        buf = b"".join(self._pending)
        n = self._pending_recs
        self._pending = []
        self._pending_recs = 0
        # unbuffered handle: one syscall straight to the page cache
        # (survives SIGKILL), no userspace buffer to flush
        fh.write(buf)  # dascheck: disable=DAS005 -- the journal's group-commit IS the sanctioned post-consume write window
        self._commits += 1
        self._unsynced += 1
        self._m_appends.inc(float(n))
        if self._unsynced >= self.fsync_every:
            self._fsync()
        if self.fault_hook is not None:
            self.fault_hook(self._commits)
        return n

    # das: hot-path — feeds commit(); lazy open amortized to once per file
    def _ensure_open(self):  # dascheck: disable=DAS006 -- once-per-file lazy open; steady-state rounds never enter the branch, so there is no recurring time to attribute
        if self._fh is None:
            fresh = not (
                os.path.exists(self.path)
                and os.path.getsize(self.path) > 0
            )
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
            self._fh = open(self.path, "ab", buffering=0)  # dascheck: disable=DAS005 -- lazy open of the journal file feeding the sanctioned commit path
            if fresh:
                self._fh.write(_encode({"k": "h", "v": SCHEMA_VERSION}))  # dascheck: disable=DAS005 -- schema header, written once per file (unbuffered: already in the page cache)
        return self._fh

    # das: hot-path — called from commit(); batched by fsync_every
    def _fsync(self) -> None:  # dascheck: disable=DAS006 -- exported as das_journal_fsync_seconds below; a span would duplicate that histogram
        t0 = time.perf_counter()
        os.fsync(self._fh.fileno())  # dascheck: disable=DAS005 -- the batched fsync the fsync_every knob exists to amortize
        self._unsynced = 0
        self._m_fsync.observe(time.perf_counter() - t0)

    def sync(self) -> None:
        """Commit anything buffered and force an fsync (drain/shutdown
        path — after this returns, every record survives power loss)."""
        self.commit()
        if self._fh is not None and self._unsynced:
            self._fsync()

    def close(self) -> None:
        if self._closed:
            return
        try:
            self.sync()
        finally:
            self._closed = True
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    # -- salvage ---------------------------------------------------------
    def recorded_tokens(self, key: str) -> int:
        """Tokens already recorded (committed or buffered) for a
        session — the resume path re-notes only the salvaged suffix a
        fresh journal file is missing."""
        sess = self.sessions.get(str(key))
        return len(sess.tokens) if sess is not None else 0

    def live_sessions(self) -> Dict[str, JournalSession]:
        """In-memory mirror of sessions still in flight (committed OR
        buffered — the in-process salvage path for a worker that died
        with the journal object still reachable)."""
        return {
            k: s for k, s in self.sessions.items() if s.resumable
        }

    @classmethod
    def recover(
        cls, path: str, *, telemetry=None
    ) -> Dict[str, JournalSession]:
        """Replay a journal file into per-session salvage state.

        Torn tail → truncate in place (at most the final un-synced
        round is lost); pre-tail corruption → quarantine + raise
        ``JournalCorruptError``; missing file → ``{}``.
        """
        from repro_torch import obs

        tel = telemetry if telemetry is not None else obs.NULL
        sessions: Dict[str, JournalSession] = {}
        if not os.path.exists(path):
            return sessions
        with open(path, "rb") as f:
            raw = f.read()
        size = len(raw)
        off = 0
        good = 0  # offset past the last fully-valid frame
        saw_header = False
        torn = False
        while off < size:
            if off + _FRAME.size > size:
                torn = True  # frame header itself is cut short
                break
            ln, crc = _FRAME.unpack_from(raw, off)
            end = off + _FRAME.size + ln
            if ln > _MAX_FRAME:
                # a garbage length prefix mid-file is bit rot, not a
                # torn append — unless nothing follows it
                if off + _FRAME.size >= size:
                    torn = True
                    break
                _quarantine(path, f"frame at {off} claims {ln} bytes")
                raise JournalCorruptError(
                    f"{path}: frame at offset {off} claims {ln} bytes"
                )
            if end > size:
                torn = True  # payload cut short: crash mid-append
                break
            payload = raw[off + _FRAME.size:end]
            if zlib.crc32(payload) != crc:
                if end >= size:
                    torn = True  # bad CRC on the final frame: torn tail
                    break
                _quarantine(path, f"CRC mismatch at offset {off}")
                raise JournalCorruptError(
                    f"{path}: CRC mismatch at offset {off} (pre-tail)"
                )
            try:
                rec = json.loads(payload.decode())
            except (ValueError, UnicodeDecodeError) as exc:
                if end >= size:
                    torn = True
                    break
                _quarantine(path, f"unparseable frame at offset {off}")
                raise JournalCorruptError(
                    f"{path}: unparseable frame at offset {off}"
                ) from exc
            off = good = end
            kind = rec.get("k")
            if kind == "h":
                v = rec.get("v")
                if v != SCHEMA_VERSION:
                    # future schema: loud, file left untouched
                    raise JournalError(
                        f"{path}: journal schema {v} not supported "
                        f"(current {SCHEMA_VERSION})"
                    )
                saw_header = True
                continue
            if not saw_header:
                _quarantine(path, "no schema header before records")
                raise JournalCorruptError(
                    f"{path}: record before schema header"
                )
            key = str(rec.get("s", ""))
            sess = sessions.get(key)
            if sess is None:
                sess = sessions[key] = JournalSession(key=key)
            if kind == "b":
                if sess.finished or not rec.get("re"):
                    sess.tokens = []  # new logical rollout on the key
                    sess.rounds = 0
                sess.prompt = [int(t) for t in rec.get("p", [])]
                sess.problem_id = rec.get("pid")
                sess.max_new_tokens = int(rec.get("mn", 0))
                sess.finished = False
                sess.status = ""
                if rec.get("tr") is not None:
                    sess.trace = str(rec["tr"])
            elif kind == "r":
                sess.tokens.extend(int(t) for t in rec.get("t", []))
                sess.rounds += 1
            elif kind == "f":
                if "n" in rec:
                    del sess.tokens[int(rec["n"]):]
                sess.finished = True
                sess.status = str(rec.get("st", FINISHED))
            # unknown record kinds skip (forward-compatible minor adds)
        if torn and good < size:
            with open(path, "r+b") as f:
                f.truncate(good)
        if tel.enabled:
            tel.emit(
                "journal_recover", path=path,
                sessions=len(sessions),
                resumable=sum(1 for s in sessions.values() if s.resumable),
                tokens=sum(len(s.tokens) for s in sessions.values()),
                torn_tail=bool(torn),
            )
        return sessions

    def adopt(self, sessions: Dict[str, JournalSession]) -> None:
        """Seed the in-memory mirror + seq counters from a recovery —
        call before re-serving resumed sessions through this journal so
        round seqs continue instead of restarting at 0."""
        for key, sess in sessions.items():
            self.sessions[key] = sess
            self._next_seq[key] = max(
                self._next_seq.get(key, 0), sess.rounds
            )


def resume_requests(requests, sessions: Dict[str, JournalSession]):
    """Split a request list against journal salvage.

    For every request whose journal key has an unfinished session with
    salvaged tokens, sets ``req.resume_tokens`` (the engine re-admits
    it via prefix re-prefill — token-identical at T=0). Requests whose
    sessions already finished are completed in place (output restored
    from the journal) and returned separately.

    Returns ``(to_serve, already_done)``.
    """
    to_serve, done = [], []
    for req in requests:
        key = getattr(req, "journal_key", None) or str(req.rid)
        sess = sessions.get(str(key))
        if sess is None:
            to_serve.append(req)
            continue
        if sess.trace is not None and getattr(req, "trace", None) is None:
            req.trace = sess.trace  # continue the dead run's trace
        if sess.finished:
            req.output = list(sess.tokens)
            req.emitted = len(req.output)
            req.state = sess.status or FINISHED
            done.append(req)
            continue
        if sess.tokens:
            req.resume_tokens = list(sess.tokens)
        to_serve.append(req)
    return to_serve, done
