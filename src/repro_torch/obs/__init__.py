"""Unified telemetry: metrics registry, round-phase tracer, event log.

One :class:`Telemetry` object bundles the three stores plus exporter
shortcuts.  The process default is :data:`NULL` — a shared
:class:`NullTelemetry` whose every operation is a no-op — so nothing
pays for instrumentation unless a caller either injects a real
``Telemetry`` into a component (``SpecEngine(..., telemetry=...)``) or
flips the process default with :func:`enable`.

Typical wiring::

    import repro_torch.obs as obs

    tel = obs.Telemetry()                 # per-worker instance
    eng = SpecEngine(params, mcfg, cfg, telemetry=tel)
    srv = obs.MetricsServer(tel, port=9100).start()
    ...
    print(tel.prometheus())               # or curl :9100/metrics

Metric name catalog (all ``das_`` prefixed) is documented in the README
"Observability" section.
"""

from __future__ import annotations

import threading
from typing import Optional

from .events import EventLog, NullEventLog
from .flight import (
    EVENT_KINDS,
    NULL_FLIGHT,
    FlightRecorder,
    NullFlightRecorder,
    merge_events,
    new_trace_id,
)
from .export import (
    parse_prometheus,
    read_jsonl,
    snapshot_dict,
    to_prometheus,
    write_jsonl_snapshot,
)
from .http import MetricsServer
from .registry import (
    TIME_BUCKETS,
    TOKEN_BUCKETS,
    Counter,
    Family,
    Gauge,
    Histogram,
    MetricsRegistry,
    MirroredCounter,
    NullRegistry,
    exp_buckets,
)
from .trace import NullTracer, Tracer

__all__ = [
    "Telemetry",
    "NullTelemetry",
    "NULL",
    "get_telemetry",
    "set_telemetry",
    "enable",
    "MetricsRegistry",
    "NullRegistry",
    "MirroredCounter",
    "Counter",
    "Gauge",
    "Histogram",
    "Family",
    "Tracer",
    "NullTracer",
    "EventLog",
    "NullEventLog",
    "FlightRecorder",
    "NullFlightRecorder",
    "NULL_FLIGHT",
    "EVENT_KINDS",
    "new_trace_id",
    "merge_events",
    "attribute",
    "attribute_journals",
    "render_report",
    "export_trace",
    "to_chrome_trace",
    "validate_chrome_trace",
    "MetricsServer",
    "to_prometheus",
    "parse_prometheus",
    "snapshot_dict",
    "write_jsonl_snapshot",
    "read_jsonl",
    "exp_buckets",
    "TIME_BUCKETS",
    "TOKEN_BUCKETS",
]

# attrib/perfetto re-exports resolve lazily (PEP 562): both modules are
# also `python -m` CLIs, and an eager import here would double-import
# them under runpy (RuntimeWarning on every CLI invocation).
_LAZY_EXPORTS = {
    "attribute": "attrib",
    "attribute_journals": "attrib",
    "render_report": "attrib",
    "export_trace": "perfetto",
    "to_chrome_trace": "perfetto",
    "validate_chrome_trace": "perfetto",
}


def __getattr__(name: str):
    mod = _LAZY_EXPORTS.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        )
    import importlib

    val = getattr(importlib.import_module(f".{mod}", __name__), name)
    globals()[name] = val
    return val


class Telemetry:
    """Live telemetry: real registry, tracer, and event log."""

    enabled = True

    def __init__(self, max_spans: int = 2048, event_cap: int = 4096):
        self.registry = MetricsRegistry()
        self.tracer = Tracer(self.registry, max_spans=max_spans)
        self.events = EventLog(self.registry, cap=event_cap)
        # Per-rollout flight recorder (repro_torch.obs.flight): NULL_FLIGHT
        # until attach_flight() names this process's worker track.
        self.flight = NULL_FLIGHT
        # hot-path binding: skip the facade method hop per span
        self.span = self.tracer.span

    # convenience passthroughs ----------------------------------------
    def counter(self, name: str, help: str = "") -> Counter:
        return self.registry.counter(name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self.registry.gauge(name, help)

    def histogram(self, name: str, help: str = "", **kw) -> Histogram:
        return self.registry.histogram(name, help, **kw)

    def span(self, name: str):
        return self.tracer.span(name)

    def emit(self, kind: str, **fields) -> None:
        self.events.emit(kind, **fields)

    def mirror_sink(self, name: str, help: str = "",
                    label: str = "key"):
        """A ``sink(key, delta)`` for :class:`MirroredCounter` backed by
        a labeled counter family ``name{label=key}``."""
        fam = self.registry.counter_family(name, help, (label,))
        cache: dict = {}

        def sink(key: str, delta: float) -> None:
            ctr = cache.get(key)
            if ctr is None:
                ctr = fam.labels(key)
                cache[key] = ctr
            ctr.inc(delta)

        return sink

    def attach_flight(self, worker: str = "w0", shard: Optional[str] = None,
                      cap: int = 65536) -> FlightRecorder:
        """Enable per-rollout flight recording for this telemetry
        (idempotent per worker tag); returns the recorder."""
        fr = self.flight
        if fr.enabled and fr.worker == worker and fr.shard == shard:
            return fr  # type: ignore[return-value]
        self.flight = FlightRecorder(
            worker=worker, shard=shard, cap=cap, registry=self.registry
        )
        return self.flight

    # exports ---------------------------------------------------------
    def prometheus(self) -> str:
        return to_prometheus(self.registry)

    def snapshot(self, spans: int = 0, events: int = 0,
                 flight: int = 0) -> dict:
        return snapshot_dict(self, spans=spans, events=events,
                             flight=flight)

    def write_jsonl(self, path: str, **kw) -> dict:
        return write_jsonl_snapshot(self, path, **kw)


class NullTelemetry:
    """No-op telemetry; the process default until :func:`enable`."""

    enabled = False

    def __init__(self) -> None:
        self.registry = NullRegistry()
        self.tracer = NullTracer()
        self.events = NullEventLog()
        self.flight = NULL_FLIGHT
        self.span = self.tracer.span

    def counter(self, name: str, help: str = ""):
        return self.registry.counter(name, help)

    def gauge(self, name: str, help: str = ""):
        return self.registry.gauge(name, help)

    def histogram(self, name: str, help: str = "", **kw):
        return self.registry.histogram(name, help)

    def span(self, name: str):
        return self.tracer.span(name)

    def emit(self, kind: str, **fields) -> None:
        pass

    def mirror_sink(self, name: str, help: str = "", label: str = "key"):
        return None

    def attach_flight(self, worker: str = "w0", shard=None,
                      cap: int = 65536):
        return NULL_FLIGHT

    def prometheus(self) -> str:
        return ""

    def snapshot(self, spans: int = 0, events: int = 0,
                 flight: int = 0) -> dict:
        return {"ts": 0.0, "metrics": self.registry.snapshot()}

    def write_jsonl(self, path: str, **kw) -> dict:
        return self.snapshot()


NULL = NullTelemetry()

_default: "Telemetry | NullTelemetry" = NULL
_default_lock = threading.Lock()


def get_telemetry() -> "Telemetry | NullTelemetry":
    """The process-default telemetry (``NULL`` unless :func:`enable`\\ d)."""
    return _default


def set_telemetry(tel: Optional["Telemetry | NullTelemetry"]):
    """Install ``tel`` (or ``NULL`` if None) as the process default."""
    global _default
    with _default_lock:
        _default = tel if tel is not None else NULL
    return _default


def enable() -> Telemetry:
    """Make the process default a real :class:`Telemetry` (idempotent)."""
    global _default
    with _default_lock:
        if not _default.enabled:
            _default = Telemetry()
        return _default  # type: ignore[return-value]
