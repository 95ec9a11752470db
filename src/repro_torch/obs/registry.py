"""Process-wide metrics registry.

Pre-registered handles (:class:`Counter`, :class:`Gauge`,
:class:`Histogram`) keep the hot path to one lock-free-ish increment on
a Python float/int plus, for histograms, a ``bisect`` into a fixed
bucket table and a ring-buffer write.  Registration happens once at
component construction; per-round code only touches resolved handles.

Label support is deliberately small: a :class:`Family` owns the metric
name and a fixed label *key* tuple, and ``family.labels(v1, v2)``
returns (creating on first use) the child handle for those label
values.  Children are cached so steady-state lookups are a dict hit.

``callback_gauge`` registers a function evaluated only at export time —
the right shape for values that are cheap to read but pointless to push
every round (shard health states, outbox depth, per-problem acceptance).

Null variants (:class:`NullCounter` etc.) share the handle API but do
nothing, so disabled telemetry costs one no-op method call per site.
"""

from __future__ import annotations

import bisect
import re
import threading
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def exp_buckets(start: float, factor: float, count: int) -> Tuple[float, ...]:
    """Exponential histogram bucket upper bounds: start * factor**i."""
    if start <= 0 or factor <= 1.0 or count < 1:
        raise ValueError("exp_buckets needs start>0, factor>1, count>=1")
    return tuple(start * factor**i for i in range(count))


# Default buckets for host-side wall times in seconds: 10us .. ~80ms.
TIME_BUCKETS = exp_buckets(1e-5, 2.0, 14)
# Default buckets for token counts per round: 1 .. 512.
TOKEN_BUCKETS = exp_buckets(1.0, 2.0, 10)


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "labels_kv", "_value", "_lock")

    def __init__(self, name: str, labels_kv: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels_kv = labels_kv
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("name", "labels_kv", "_value", "_lock")

    def __init__(self, name: str, labels_kv: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels_kv = labels_kv
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram with a bounded ring of raw observations.

    ``buckets`` are upper bounds (le); an implicit +Inf bucket is
    appended.  ``counts`` is an int64 view of per-bucket hits, ``ring``
    a float64 view of the most recent raw values for percentile
    estimates offline.  Internally both are plain Python lists — item
    writes on a list are several times cheaper than numpy scalar
    indexing, and ``observe`` sits on the per-round hot path.
    """

    __slots__ = (
        "name",
        "labels_kv",
        "buckets",
        "_counts",
        "sum",
        "count",
        "_ring",
        "_cap",
        "_ring_idx",
        "_lock",
    )

    def __init__(
        self,
        name: str,
        buckets: Sequence[float] = TIME_BUCKETS,
        labels_kv: Tuple[Tuple[str, str], ...] = (),
        ring: int = 256,
    ):
        self.name = name
        self.labels_kv = labels_kv
        self.buckets: Tuple[float, ...] = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.count = 0
        self._cap = max(1, int(ring))
        self._ring: list = [0.0] * self._cap
        self._ring_idx = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._counts[i] += 1
            self.sum += value
            self.count += 1
            idx = self._ring_idx
            self._ring[idx % self._cap] = value
            self._ring_idx = idx + 1

    def observe_many(self, values: Iterable[float]) -> None:
        for v in values:
            self.observe(v)

    @property
    def counts(self) -> np.ndarray:
        with self._lock:
            return np.asarray(self._counts, dtype=np.int64)

    @property
    def ring(self) -> np.ndarray:
        with self._lock:
            return np.asarray(self._ring, dtype=np.float64)

    def recent(self) -> np.ndarray:
        """Raw observations still in the ring, oldest first."""
        with self._lock:
            cap = self._cap
            if self._ring_idx <= cap:
                return np.asarray(self._ring[: self._ring_idx], np.float64)
            start = self._ring_idx % cap
            return np.asarray(
                self._ring[start:] + self._ring[:start], np.float64
            )

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class NullCounter:
    __slots__ = ()
    name = "null"
    labels_kv: Tuple[Tuple[str, str], ...] = ()
    value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        pass


class NullGauge(NullCounter):
    __slots__ = ()

    def set(self, value: float) -> None:
        pass


class NullHistogram:
    __slots__ = ()
    name = "null"
    labels_kv: Tuple[Tuple[str, str], ...] = ()
    buckets: Tuple[float, ...] = ()
    sum = 0.0
    count = 0
    mean = 0.0

    def observe(self, value: float) -> None:
        pass

    def observe_many(self, values: Iterable[float]) -> None:
        pass

    def recent(self) -> np.ndarray:
        return np.zeros(0, dtype=np.float64)


class Family:
    """A named metric with a fixed label-key tuple and cached children."""

    __slots__ = ("name", "help", "kind", "label_keys", "_children", "_lock", "_kwargs")

    def __init__(self, name: str, help: str, kind: str,
                 label_keys: Tuple[str, ...], **kwargs):
        self.name = name
        self.help = help
        self.kind = kind
        self.label_keys = label_keys
        self._children: Dict[Tuple[str, ...], object] = {}  # guarded-by: self._lock
        self._lock = threading.Lock()
        self._kwargs = kwargs

    def labels(self, *values) -> object:
        key = tuple(str(v) for v in values)
        child = self._children.get(key)  # dascheck: disable=DAS101 -- lock-free fast path: children are published once and never replaced; a miss falls through to the locked double-check below
        if child is None:
            if len(key) != len(self.label_keys):
                raise ValueError(
                    f"{self.name}: expected {len(self.label_keys)} label "
                    f"values, got {len(key)}"
                )
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    kv = tuple(zip(self.label_keys, key))
                    if self.kind == "counter":
                        child = Counter(self.name, kv)
                    elif self.kind == "gauge":
                        child = Gauge(self.name, kv)
                    else:
                        child = Histogram(self.name, labels_kv=kv, **self._kwargs)
                    self._children[key] = child
        return child

    def children(self) -> List[object]:
        with self._lock:
            return list(self._children.values())


class NullFamily:
    __slots__ = ("_child",)

    def __init__(self, child):
        self._child = child

    def labels(self, *values):
        return self._child

    def children(self) -> List[object]:
        return []


class MetricsRegistry:
    """Thread-safe, get-or-create registry of metric families.

    Every metric is a :class:`Family`; an unlabeled metric is a family
    with zero label keys whose single child is created eagerly (the
    ``counter``/``gauge``/``histogram`` helpers return that child
    directly so hot paths never see the family wrapper).
    """

    def __init__(self) -> None:
        self._families: Dict[str, Family] = {}  # guarded-by: self._lock
        self._callbacks: Dict[str, Tuple[str, List[Callable[[], object]]]] = {}  # guarded-by: self._lock
        self._collect_hooks: List[Callable[[], None]] = []  # guarded-by: self._lock
        self._lock = threading.Lock()

    # -- collect hooks ------------------------------------------------
    def add_collect_hook(self, fn: Callable[[], None]) -> None:
        """Register ``fn`` to run before any export/snapshot.

        Deferred sources (the tracer's pending span buffer) use this to
        fold buffered raw events into their histograms at read time
        instead of on the hot path.
        """
        with self._lock:
            self._collect_hooks.append(fn)

    def collect(self) -> None:
        """Run every collect hook (exporters call this first)."""
        with self._lock:
            hooks = list(self._collect_hooks)
        for fn in hooks:
            try:
                fn()
            except Exception:  # dascheck: disable=DAS303 -- a broken hook must not take down a scrape
                pass

    def _family(self, name: str, help: str, kind: str,
                label_keys: Sequence[str], **kwargs) -> Family:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name: {name!r}")
        label_keys = tuple(label_keys)
        for k in label_keys:
            if not _LABEL_RE.match(k):
                raise ValueError(f"invalid label name: {k!r}")
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.label_keys != label_keys:
                    raise ValueError(
                        f"metric {name!r} re-registered with different "
                        f"kind/labels ({fam.kind}{fam.label_keys} vs "
                        f"{kind}{label_keys})"
                    )
                return fam
            fam = Family(name, help, kind, label_keys, **kwargs)
            self._families[name] = fam
            return fam

    # -- unlabeled handles --------------------------------------------
    def counter(self, name: str, help: str = "") -> Counter:
        return self._family(name, help, "counter", ()).labels()

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._family(name, help, "gauge", ()).labels()

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = TIME_BUCKETS,
                  ring: int = 256) -> Histogram:
        return self._family(
            name, help, "histogram", (), buckets=buckets, ring=ring
        ).labels()

    # -- labeled families ---------------------------------------------
    def counter_family(self, name: str, help: str,
                       label_keys: Sequence[str]) -> Family:
        return self._family(name, help, "counter", label_keys)

    def gauge_family(self, name: str, help: str,
                     label_keys: Sequence[str]) -> Family:
        return self._family(name, help, "gauge", label_keys)

    def histogram_family(self, name: str, help: str,
                         label_keys: Sequence[str],
                         buckets: Sequence[float] = TIME_BUCKETS,
                         ring: int = 256) -> Family:
        return self._family(name, help, "histogram", label_keys,
                            buckets=buckets, ring=ring)

    # -- callback gauges ----------------------------------------------
    def callback_gauge(self, name: str, help: str,
                       fn: Callable[[], object]) -> None:
        """Register ``fn`` evaluated at export time.

        ``fn`` may return a scalar, or a dict mapping
        ``((label_key, label_value), ...)`` tuples to scalars for a
        dynamic label set.  Several callbacks may share one name (e.g.
        one per worker, disambiguated by a ``worker`` label); their
        dict results merge at export.
        """
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name: {name!r}")
        with self._lock:
            if name in self._families:
                raise ValueError(f"{name!r} already registered as a family")
            _, fns = self._callbacks.setdefault(name, (help, []))
            fns.append(fn)

    # -- introspection ------------------------------------------------
    def families(self) -> List[Family]:
        with self._lock:
            return list(self._families.values())

    def callbacks(self) -> List[Tuple[str, str, List[Callable[[], object]]]]:
        with self._lock:
            return [(n, h, list(fns)) for n, (h, fns) in self._callbacks.items()]

    def get(self, name: str, labels_kv: Tuple[Tuple[str, str], ...] = ()):
        """Look up an existing child handle, or None."""
        with self._lock:
            fam = self._families.get(name)
        if fam is None:
            return None
        key = tuple(v for _, v in labels_kv)
        return fam._children.get(key)

    def value(self, name: str,
              labels_kv: Tuple[Tuple[str, str], ...] = ()) -> float:
        """Current scalar value of a counter/gauge child (0.0 if absent)."""
        child = self.get(name, labels_kv)
        return float(getattr(child, "value", 0.0)) if child is not None else 0.0

    def snapshot(self) -> dict:
        """JSON-able snapshot of every metric, callbacks included."""
        self.collect()
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}

        def _key(child) -> str:
            if not child.labels_kv:
                return child.name
            lbl = ",".join(f"{k}={v}" for k, v in child.labels_kv)
            return f"{child.name}{{{lbl}}}"

        for fam in self.families():
            for child in fam.children():
                if fam.kind == "counter":
                    out["counters"][_key(child)] = child.value
                elif fam.kind == "gauge":
                    out["gauges"][_key(child)] = child.value
                else:
                    out["histograms"][_key(child)] = {
                        "buckets": list(child.buckets),
                        "counts": child.counts.tolist(),
                        "sum": child.sum,
                        "count": child.count,
                    }
        for name, _help, fns in self.callbacks():
            for fn in fns:
                try:
                    val = fn()
                except Exception:  # dascheck: disable=DAS303 -- a broken callback must not break the snapshot
                    continue
                if isinstance(val, dict):
                    for kv, v in val.items():
                        lbl = ",".join(f"{k}={x}" for k, x in kv)
                        out["gauges"][f"{name}{{{lbl}}}"] = float(v)
                else:
                    out["gauges"][name] = float(val)
        return out


class NullRegistry:
    """API-compatible registry whose handles all do nothing."""

    _counter = NullCounter()
    _gauge = NullGauge()
    _hist = NullHistogram()

    def counter(self, name: str, help: str = "") -> NullCounter:
        return self._counter

    def gauge(self, name: str, help: str = "") -> NullGauge:
        return self._gauge

    def histogram(self, name: str, help: str = "", buckets=TIME_BUCKETS,
                  ring: int = 256) -> NullHistogram:
        return self._hist

    def counter_family(self, name, help, label_keys) -> NullFamily:
        return NullFamily(self._counter)

    def gauge_family(self, name, help, label_keys) -> NullFamily:
        return NullFamily(self._gauge)

    def histogram_family(self, name, help, label_keys,
                         buckets=TIME_BUCKETS, ring: int = 256) -> NullFamily:
        return NullFamily(self._hist)

    def callback_gauge(self, name, help, fn) -> None:
        pass

    def add_collect_hook(self, fn) -> None:
        pass

    def collect(self) -> None:
        pass

    def families(self) -> list:
        return []

    def callbacks(self) -> list:
        return []

    def get(self, name, labels_kv=()):
        return None

    def value(self, name, labels_kv=()) -> float:
        return 0.0

    def snapshot(self) -> dict:
        return {"counters": {}, "gauges": {}, "histograms": {}}


class MirroredCounter(dict):
    """A ``collections.Counter``-shaped dict that mirrors deltas.

    Drop-in replacement for the ad-hoc ``collections.Counter`` stat
    bags (``SuffixDrafter.stats``, ``HistoryClient`` stats, supervisor
    stats): every positive delta written through ``__setitem__`` /
    ``update`` / ``+=`` is forwarded to ``sink(key, delta)`` — normally
    a labeled counter family in the registry — while the dict itself
    keeps serving the existing read API unchanged.

    ``clear()`` only resets the local view; registry counters are
    monotonic by contract, so resets (e.g. checkpoint restore in
    ``history/persist.py``) do not emit negative deltas.
    """

    __slots__ = ("_sink",)

    def __init__(self, initial=None, sink: Optional[Callable[[str, float], None]] = None):
        super().__init__()
        self._sink = None  # silent while seeding the initial view
        if initial:
            for k, v in dict(initial).items():
                super().__setitem__(k, v)
        self._sink = sink

    # Counter-compatible surface -------------------------------------
    def __missing__(self, key):
        return 0

    def __setitem__(self, key, value) -> None:
        if self._sink is not None:
            delta = value - self.get(key, 0)
            if delta > 0:
                self._sink(str(key), float(delta))
        super().__setitem__(key, value)

    def update(self, other=None, **kwargs) -> None:  # type: ignore[override]
        # Counter.update adds; dict.update replaces. The stat bags use
        # Counter semantics, so add — routing through __setitem__ keeps
        # the mirror consistent.
        if other:
            items = other.items() if hasattr(other, "items") else other
            for k, v in items:
                self[k] = self.get(k, 0) + v
        for k, v in kwargs.items():
            self[k] = self.get(k, 0) + v

    def set_sink(self, sink: Optional[Callable[[str, float], None]]) -> None:
        self._sink = sink

    def most_common(self, n: Optional[int] = None):
        items = sorted(self.items(), key=lambda kv: kv[1], reverse=True)
        return items if n is None else items[:n]
