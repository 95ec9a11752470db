"""Perfetto / Chrome trace-event exporter.

Folds the round-phase tracer's spans (:mod:`repro_torch.obs.trace`) and the
flight recorder's lifecycle events (:mod:`repro_torch.obs.flight`) into ONE
Chrome trace-event JSON document per run, openable in ``ui.perfetto.dev``
or ``chrome://tracing``:

* one **process track per worker** (spans on a ``rounds`` thread,
  request residency slices on per-slot threads, lifecycle instants on a
  ``flight`` thread) and one per **shard** (publish instants);
* **flow arrows** (``ph:"s"``/``"f"``) following each trace ID across
  preempt→resume and handoff→resume boundaries — a requeued rollout's
  arrow visibly crosses from the dead worker's track to the survivor's.

Clock alignment: spans stamp ``time.perf_counter()`` while flight
events stamp wall ``time.time()``; each recorder carries a per-process
``perf_offset`` (wall − perf at construction) that shifts span
timestamps onto the wall axis. All trace-event timestamps are
microseconds.
"""

from __future__ import annotations

import json
import zlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "to_chrome_trace",
    "export_trace",
    "validate_chrome_trace",
]

_TID_ROUNDS = 1  # span tree
_TID_FLIGHT = 2  # lifecycle instants
_TID_SLOT0 = 10  # request residency slices: tid = _TID_SLOT0 + slot


def _flow_id(trace: str, n: int) -> int:
    """Stable positive int id for the n-th flow arrow of a trace."""
    return (zlib.crc32(trace.encode()) << 8 | (n & 0xFF)) & 0x7FFFFFFF


def _us(ts: float) -> float:
    return round(ts * 1e6, 3)


def _meta(pid: int, name: str, tid: Optional[int] = None,
          tname: Optional[str] = None) -> List[dict]:
    out = [{
        "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
        "args": {"name": name},
    }]
    if tid is not None:
        out.append({
            "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": tname or str(tid)},
        })
    return out


def _span_events(spans: Sequence[dict], pid: int, offset: float) -> List[dict]:
    """Tracer SpanRecords (``to_dict`` form) → 'X' complete events."""
    out = []
    for s in spans:
        ev = {
            "ph": "X", "name": s["name"], "cat": "span",
            "pid": pid, "tid": _TID_ROUNDS,
            "ts": _us(float(s["t0"]) + offset),
            "dur": _us(float(s.get("dur_s", 0.0))),
        }
        attrs = s.get("attrs")
        args = {"depth": s.get("depth", 0)}
        if attrs:
            args.update(attrs)
        ev["args"] = args
        out.append(ev)
    return out


def _flight_track(events: Sequence[dict], pids: Dict[str, int],
                  used_tids: Dict[int, Dict[int, str]]) -> List[dict]:
    """Flight events → lifecycle instants + per-slot residency slices +
    cross-segment flow arrows."""
    out: List[dict] = []
    # ---- instants on the owner's flight thread ----------------------
    for e in events:
        pid = pids[_track_key(e)]
        ev = {
            "ph": "i" if not e.get("dur") else "X",
            "name": e["kind"], "cat": "flight",
            "pid": pid, "tid": _TID_FLIGHT,
            "ts": _us(e["ts"] - float(e.get("dur") or 0.0)),
            "args": {
                k: v for k, v in e.items()
                if k not in ("ts", "worker", "shard") and v is not None
            },
        }
        if ev["ph"] == "i":
            ev["s"] = "t"  # thread-scoped instant
        else:
            ev["dur"] = _us(float(e["dur"]))
        out.append(ev)

    # ---- per-trace residency slices + flow arrows --------------------
    by_trace: Dict[str, List[dict]] = {}
    for e in events:
        tr = e.get("trace")
        if tr is not None:
            by_trace.setdefault(tr, []).append(e)
    for tr, evs in by_trace.items():
        evs = sorted(evs, key=lambda e: (e["ts"], e["seq"]))
        # segments: admit/resume opens residency on (worker, slot);
        # preempt/finish/handoff closes it
        seg_open: Optional[dict] = None
        segments: List[Tuple[dict, dict]] = []
        for e in evs:
            k = e["kind"]
            if k in ("admit", "resume"):
                if seg_open is not None:
                    segments.append((seg_open, e))
                seg_open = e
            elif k in ("preempt", "finish", "handoff", "stall"):
                if seg_open is not None:
                    segments.append((seg_open, e))
                    seg_open = None
        if seg_open is not None:
            last = evs[-1]
            segments.append((seg_open, last))
        for a, b in segments:
            pid = pids[_track_key(a)]
            slot = a.get("slot")
            tid = _TID_SLOT0 + int(slot) if slot is not None else _TID_FLIGHT
            used_tids.setdefault(pid, {})[tid] = (
                f"slot {slot}" if slot is not None else "flight"
            )
            out.append({
                "ph": "X", "name": f"rollout {tr}", "cat": "rollout",
                "pid": pid, "tid": tid,
                "ts": _us(a["ts"]),
                "dur": max(_us(b["ts"]) - _us(a["ts"]), 1.0),
                "args": {"trace": tr, "rid": a.get("rid")},
            })
        # flow arrows: every close→open pair of consecutive segments
        # (preempt→resume, handoff→resume); arrows across pids are the
        # cross-worker handoffs the chaos tests assert on
        n = 0
        for (a1, b1), (a2, _b2) in zip(segments, segments[1:]):
            fid = _flow_id(tr, n)
            n += 1
            src_pid = pids[_track_key(b1)]
            dst_pid = pids[_track_key(a2)]
            src_slot = a1.get("slot")
            dst_slot = a2.get("slot")
            out.append({
                "ph": "s", "id": fid, "name": "trace", "cat": "flight",
                "pid": src_pid,
                "tid": (_TID_SLOT0 + int(src_slot)
                        if src_slot is not None else _TID_FLIGHT),
                "ts": _us(b1["ts"]),
            })
            out.append({
                "ph": "f", "bp": "e", "id": fid, "name": "trace",
                "cat": "flight",
                "pid": dst_pid,
                "tid": (_TID_SLOT0 + int(dst_slot)
                        if dst_slot is not None else _TID_FLIGHT),
                "ts": _us(a2["ts"]),
            })
    return out


def _track_key(e: dict) -> str:
    if e.get("shard") is not None:
        return f"shard:{e['shard']}"
    return f"worker:{e.get('worker', 'w?')}"


def to_chrome_trace(
    workers: Sequence[dict],
) -> dict:
    """Build a Chrome trace-event document.

    ``workers`` is a list of per-process dicts::

        {"name": "w0",                  # worker tag (track name)
         "spans": [...SpanRecord.to_dict()...],
         "flight": [...flight event dicts...],
         "perf_offset": 1712.3,         # wall - perf_counter anchor
         "shard": None}                 # or a shard tag

    Returns ``{"traceEvents": [...], "displayTimeUnit": "ms"}``.
    """
    pids: Dict[str, int] = {}
    events: List[dict] = []
    all_flight: List[dict] = []
    used_tids: Dict[int, Dict[int, str]] = {}

    def _pid(key: str, label: str) -> int:
        if key not in pids:
            pids[key] = len(pids) + 1
            events.extend(_meta(pids[key], label))
        return pids[key]

    for w in workers:
        name = str(w.get("name", f"w{len(pids)}"))
        shard = w.get("shard")
        key = f"shard:{shard}" if shard is not None else f"worker:{name}"
        label = f"shard {shard}" if shard is not None else f"worker {name}"
        pid = _pid(key, label)
        events.extend(_meta(pid, label, _TID_ROUNDS, "rounds"))
        events.extend(_meta(pid, label, _TID_FLIGHT, "flight"))
        offset = float(w.get("perf_offset", 0.0))
        events.extend(_span_events(w.get("spans", ()), pid, offset))
        for e in w.get("flight", ()):
            ee = dict(e)
            # events recorded by another process (handoffs recorded by
            # the fleet supervisor) keep their own worker tag; register
            # a track for it on first sight
            k = _track_key(ee)
            if k not in pids:
                _pid(k, k.replace(":", " "))
            all_flight.append(ee)
    events.extend(_flight_track(all_flight, pids, used_tids))
    for pid, tids in used_tids.items():
        for tid, tname in tids.items():
            events.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": tname},
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_trace(
    path: str,
    telemetries: Sequence,
    names: Optional[Sequence[str]] = None,
    shards: Sequence = (),
    max_spans: int = 4096,
) -> dict:
    """Export one trace.json from live telemetry objects.

    ``telemetries``: one per worker (spans + flight recorder each);
    ``shards``: optional extra :class:`~repro_torch.obs.flight.FlightRecorder`
    instances (history-shard side). Returns the document (also written
    to ``path``).
    """
    workers = []
    for i, tel in enumerate(telemetries):
        fr = getattr(tel, "flight", None)
        name = (
            names[i] if names is not None
            else (fr.worker if fr is not None and fr.enabled else f"w{i}")
        )
        spans = [s.to_dict() for s in tel.tracer.recent(max_spans)]
        workers.append({
            "name": name,
            "spans": spans,
            "flight": fr.events() if fr is not None else [],
            "perf_offset": getattr(fr, "perf_offset", 0.0) or 0.0,
        })
    for fr in shards:
        workers.append({
            "name": fr.worker, "shard": fr.shard, "spans": [],
            "flight": fr.events(), "perf_offset": fr.perf_offset,
        })
    doc = to_chrome_trace(workers)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


_REQUIRED = {"ph", "name", "pid", "tid"}
_PH_KNOWN = {"X", "B", "E", "i", "I", "M", "s", "f", "t", "C"}


def validate_chrome_trace(doc: dict) -> List[str]:
    """Structural validation against the trace-event format. Returns a
    list of problems (empty = valid): required keys per event, numeric
    ts/dur, known phases, and matched s/f flow-id pairs."""
    problems: List[str] = []
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    flows: Dict[int, Dict[str, int]] = {}
    for i, e in enumerate(evs):
        if not isinstance(e, dict):
            problems.append(f"event {i}: not an object")
            continue
        missing = _REQUIRED - set(e)
        if missing:
            problems.append(f"event {i}: missing {sorted(missing)}")
            continue
        ph = e["ph"]
        if ph not in _PH_KNOWN:
            problems.append(f"event {i}: unknown ph {ph!r}")
        if ph != "M":
            ts = e.get("ts")
            if not isinstance(ts, (int, float)):
                problems.append(f"event {i}: non-numeric ts {ts!r}")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i}: X without numeric dur")
        if ph == "i" and e.get("s") not in (None, "t", "p", "g"):
            problems.append(f"event {i}: bad instant scope {e.get('s')!r}")
        if ph in ("s", "f"):
            fid = e.get("id")
            if fid is None:
                problems.append(f"event {i}: flow event without id")
            else:
                d = flows.setdefault(int(fid), {"s": 0, "f": 0})
                d[ph] += 1
    for fid, d in flows.items():
        if d["s"] == 0 or d["f"] == 0:
            problems.append(
                f"flow id {fid}: unmatched (s={d['s']}, f={d['f']})"
            )
    return problems
