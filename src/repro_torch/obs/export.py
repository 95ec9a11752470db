"""Exporters: Prometheus text exposition 0.0.4 and JSONL snapshots.

``to_prometheus`` renders every family plus callback gauges; histograms
emit cumulative ``_bucket{le=...}`` series with ``le="+Inf"``, then
``_sum`` and ``_count``, per the exposition format.  ``parse_prometheus``
is the (deliberately small) inverse used by round-trip tests and by
anything that wants to scrape a worker without a Prometheus server.

``write_jsonl_snapshot`` appends one JSON object per call — a
timestamped registry snapshot plus optional recent spans/events — so a
run leaves a greppable time series behind for offline analysis.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Tuple


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def _labels_str(kv: Tuple[Tuple[str, str], ...],
                extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    items = tuple(kv) + tuple(extra)
    if not items:
        return ""
    inner = ",".join(f'{k}="{_escape(str(v))}"' for k, v in items)
    return "{" + inner + "}"


def to_prometheus(registry) -> str:
    """Render the registry in Prometheus text exposition format 0.0.4."""
    collect = getattr(registry, "collect", None)
    if collect is not None:
        collect()  # fold deferred sources (pending spans) in first
    lines: List[str] = []
    for fam in registry.families():
        children = fam.children()
        if not children:
            continue
        ptype = "counter" if fam.kind == "counter" else (
            "gauge" if fam.kind == "gauge" else "histogram")
        if fam.help:
            lines.append(f"# HELP {fam.name} {_escape(fam.help)}")
        lines.append(f"# TYPE {fam.name} {ptype}")
        for child in children:
            if fam.kind in ("counter", "gauge"):
                lines.append(
                    f"{fam.name}{_labels_str(child.labels_kv)} "
                    f"{_fmt_value(child.value)}"
                )
            else:
                cum = 0
                for le, c in zip(child.buckets, child.counts[:-1]):
                    cum += int(c)
                    lines.append(
                        f"{fam.name}_bucket"
                        f"{_labels_str(child.labels_kv, (('le', _fmt_value(le)),))}"
                        f" {cum}"
                    )
                cum += int(child.counts[-1])
                lines.append(
                    f"{fam.name}_bucket"
                    f"{_labels_str(child.labels_kv, (('le', '+Inf'),))} {cum}"
                )
                lines.append(
                    f"{fam.name}_sum{_labels_str(child.labels_kv)} "
                    f"{_fmt_value(child.sum)}"
                )
                lines.append(
                    f"{fam.name}_count{_labels_str(child.labels_kv)} "
                    f"{child.count}"
                )
    for name, help, fns in registry.callbacks():
        header = False
        for fn in fns:
            try:
                val = fn()
            except Exception:  # dascheck: disable=DAS303 -- a broken callback must not break the scrape
                continue
            if not header:
                if help:
                    lines.append(f"# HELP {name} {_escape(help)}")
                lines.append(f"# TYPE {name} gauge")
                header = True
            if isinstance(val, dict):
                for kv, v in val.items():
                    lines.append(
                        f"{name}{_labels_str(tuple(kv))} "
                        f"{_fmt_value(float(v))}"
                    )
            else:
                lines.append(f"{name} {_fmt_value(float(val))}")
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float]:
    """Parse exposition text into ``{(name, ((k, v), ...)): value}``.

    Handles the subset ``to_prometheus`` emits: no timestamps, label
    values without embedded escaped quotes beyond ``\\"``.
    """
    out: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        series, _, value = line.rpartition(" ")
        if "{" in series:
            name, _, rest = series.partition("{")
            body = rest.rsplit("}", 1)[0]
            labels = []
            for part in _split_labels(body):
                k, _, v = part.partition("=")
                labels.append((k, v.strip('"').replace('\\"', '"')
                               .replace("\\n", "\n").replace("\\\\", "\\")))
            key = (name, tuple(labels))
        else:
            key = (series, ())
        out[key] = float(value)
    return out


def _split_labels(body: str) -> List[str]:
    parts, cur, in_str, prev = [], [], False, ""
    for ch in body:
        if ch == '"' and prev != "\\":
            in_str = not in_str
        if ch == "," and not in_str:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
        prev = ch
    if cur:
        parts.append("".join(cur))
    return parts


def snapshot_dict(telemetry, spans: int = 0, events: int = 0,
                  flight: int = 0) -> dict:
    """One JSON-able snapshot of a :class:`~repro_torch.obs.Telemetry`.

    ``flight`` bounds how many flight-recorder lifecycle events ride
    along (most-recent-first truncation) — ``repro_torch.obs.attrib
    --snapshot`` consumes them, plus the recorder's perf↔wall anchor
    so spans and flight events stay alignable offline.
    """
    snap = {
        "ts": time.time(),  # dascheck: disable=DAS201 -- wall-clock snapshot timestamp, not a duration
        "metrics": telemetry.registry.snapshot(),
    }
    if spans:
        snap["spans"] = [s.to_dict() for s in telemetry.tracer.recent(spans)]
    if events:
        snap["events"] = telemetry.events.recent(events)
    fr = getattr(telemetry, "flight", None)
    if flight and fr is not None and fr.enabled:
        snap["flight"] = fr.events()[-flight:]
        snap["flight_worker"] = fr.worker
        snap["perf_offset"] = fr.perf_offset
    return snap


def write_jsonl_snapshot(telemetry, path: str, spans: int = 0,
                         events: int = 0, flight: int = 0,
                         extra: Optional[dict] = None) -> dict:
    """Append one snapshot line to ``path``; returns the snapshot."""
    snap = snapshot_dict(telemetry, spans=spans, events=events,
                         flight=flight)
    if extra:
        snap.update(extra)
    with open(path, "a") as f:
        f.write(json.dumps(snap) + "\n")
    return snap


def read_jsonl(path: str) -> List[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
