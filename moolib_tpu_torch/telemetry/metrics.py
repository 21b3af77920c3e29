"""Process-wide metrics registry: labeled counters, gauges, histograms.

The reference moolib exposes only ``debug_info`` string dumps (SURVEY §5.1);
this is the uniform replacement: every subsystem registers named instruments
against one process registry and exporters (Prometheus text, JSONL snapshots,
SIGUSR1 dumps — :mod:`moolib_tpu_torch.telemetry.exporters`) read them without the
subsystems knowing.  Stdlib only: importable from env workers, benchmarks,
and the docs generator without touching torch.

Hot-path design: callers bind a labeled child once (``counter.labels(...)``
at wiring time — e.g. per RPC connection) and the per-event cost is one
``child.inc(n)``: a single uncontended ``threading.RLock`` acquire around a
float add (reentrant so the SIGUSR1/watchdog diagnostics dump can't
self-deadlock against an interrupted update).  CPython can't do true
lock-free, but the lock is per-child, never shared across metrics, and held
for two bytecodes — cheap enough for the per-frame RPC path (~100 ns), and
consistent reads come for free.

Naming follows Prometheus conventions: ``snake_case``, ``_total`` suffix on
counters, base-unit ``_seconds``/``_bytes`` suffixes.  Metric names are
documented in docs/TELEMETRY.md; add new ones there.
"""

from __future__ import annotations

import bisect
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "get_registry",
    "DEFAULT_TIME_BUCKETS",
    "DEFAULT_SIZE_BUCKETS",
]

# Latency buckets: 100 us .. ~2 min, roughly x4 per step — wide enough to
# cover an ipc RTT and a wedged collective in the same histogram.
DEFAULT_TIME_BUCKETS = (
    0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0, 120.0,
)
# Size buckets (bytes): 256 B .. 1 GiB, x16 per step.
DEFAULT_SIZE_BUCKETS = (
    256.0, 4096.0, 65536.0, 1048576.0, 16777216.0, 268435456.0, 1073741824.0,
)


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _max_labelsets() -> int:
    """Per-family cardinality cap.  Unbounded label values (a peer name
    used as a label by a process that churns peers forever) would grow the
    registry — and every exporter payload — without bound; past the cap new
    label sets collapse into one hidden overflow child and
    ``telemetry_dropped_labelsets_total`` counts the drops.  Read per
    overflow decision (not hot: the check only runs when a *new* child
    would be created), so tests and operators can retune it live."""
    try:
        return max(1, int(os.environ.get("MOOLIB_TELEMETRY_MAX_LABELSETS", "1000")))
    except ValueError:
        return 1000


class _Child:
    """One (metric, label-set) time series.

    Locks here (and on histograms / metric families / the registry) are
    REENTRANT: the SIGUSR1/watchdog diagnostics dump formats the registry
    from the main thread, and a signal can land while that same thread is
    inside an ``inc()``/``observe()`` — a plain Lock would self-deadlock
    the process the dump exists to diagnose.  CPython's RLock is C-level
    and keeps the fast path a single uncontended acquire.
    """

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.RLock()
        self._value = 0.0

    def get(self) -> float:
        with self._lock:
            return self._value


class _CounterChild(_Child):
    __slots__ = ()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount


class _GaugeChild(_Child):
    __slots__ = ()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount


class _HistogramChild:
    __slots__ = ("_lock", "_bounds", "_counts", "_sum", "_count")

    def __init__(self, bounds: Sequence[float]):
        self._lock = threading.RLock()  # reentrant: see _Child
        self._bounds = tuple(bounds)
        self._counts = [0] * (len(bounds) + 1)  # last bucket = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self._bounds, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    def time(self):
        """Context manager observing the elapsed seconds of its body."""
        return _HistTimer(self)

    def get(self) -> Dict[str, object]:
        with self._lock:
            return {
                "buckets": list(self._counts),
                "sum": self._sum,
                "count": self._count,
            }


class _HistTimer:
    __slots__ = ("_h", "_t0")

    def __init__(self, h: _HistogramChild):
        self._h = h

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._h.observe(time.perf_counter() - self._t0)
        return False


class _Metric:
    """Base: a named family of children keyed by label values."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.RLock()  # reentrant: see _Child
        self._children: Dict[Tuple[Tuple[str, str], ...], object] = {}
        self._registry: Optional["Registry"] = None  # set by Registry._register
        self._overflow = None  # shared sink for label sets past the cap

    def _new_child(self):
        raise NotImplementedError

    def labels(self, **labels):
        """Bind (and memoize) the child for one label set.  Unknown or
        missing label names are an error — mismatched label sets would
        render as distinct series of the same family and break aggregation.

        Cardinality guard: once a family holds :func:`_max_labelsets`
        distinct label sets, further NEW sets all bind one shared overflow
        child that is never exported, and each such call increments
        ``telemetry_dropped_labelsets_total`` — bounding memory and export
        size while keeping writers crash-free."""
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labelnames}, got "
                f"{tuple(sorted(labels))}"
            )
        key = _label_key(labels)
        child = self._children.get(key)
        if child is not None:
            return child
        dropped = False
        with self._lock:
            child = self._children.get(key)
            if child is None:
                if self.labelnames and len(self._children) >= _max_labelsets():
                    if self._overflow is None:
                        self._overflow = self._new_child()
                    child = self._overflow
                    dropped = True
                else:
                    child = self._children.setdefault(key, self._new_child())
        if dropped:
            # Outside the family lock: the drop counter is another family in
            # the same registry; nesting its child lock under ours would
            # order locks across families.
            reg = self._registry
            if reg is not None:
                reg.counter(
                    "telemetry_dropped_labelsets_total",
                    "new label sets dropped by the per-family cardinality "
                    "cap (MOOLIB_TELEMETRY_MAX_LABELSETS)",
                ).inc()
        return child

    def _default(self):
        if self.labelnames:
            raise ValueError(f"metric {self.name!r} requires labels {self.labelnames}")
        return self.labels()

    def samples(self) -> List[Tuple[Dict[str, str], object]]:
        """[(labels_dict, value_or_hist_dict)] for every child."""
        with self._lock:
            items = list(self._children.items())
        return [(dict(k), c.get()) for k, c in items]


class Counter(_Metric):
    """Monotonically increasing count (events, bytes, errors)."""

    kind = "counter"

    def _new_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0, **labels) -> None:
        (self.labels(**labels) if labels or self.labelnames else self._default()).inc(amount)


class Gauge(_Metric):
    """Point-in-time value (queue depth, membership size, flags)."""

    kind = "gauge"

    def _new_child(self):
        return _GaugeChild()

    def set(self, value: float, **labels) -> None:
        (self.labels(**labels) if labels or self.labelnames else self._default()).set(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        (self.labels(**labels) if labels or self.labelnames else self._default()).inc(amount)

    def dec(self, amount: float = 1.0, **labels) -> None:
        (self.labels(**labels) if labels or self.labelnames else self._default()).dec(amount)


class Histogram(_Metric):
    """Fixed-bucket distribution (latencies, sizes).  Buckets are chosen at
    registration and shared by every label set of the family (Prometheus
    requires it for cross-series aggregation)."""

    kind = "histogram"

    def __init__(self, name, help, labelnames=(), buckets: Sequence[float] = DEFAULT_TIME_BUCKETS):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(float(b) for b in buckets))

    def _new_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, value: float, **labels) -> None:
        (self.labels(**labels) if labels or self.labelnames else self._default()).observe(value)

    def time(self, **labels):
        return (self.labels(**labels) if labels or self.labelnames else self._default()).time()


class Registry:
    """A named set of metrics.  ``get_registry()`` returns the process-wide
    default; tests build private ones.  Registration is idempotent: asking
    for an existing (name, kind) returns the existing family, so every
    subsystem can declare its metrics at wiring time without coordination."""

    def __init__(self):
        self._lock = threading.RLock()  # reentrant: see _Child
        self._metrics: Dict[str, _Metric] = {}

    def _register(self, cls, name, help, labelnames, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) or m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind} "
                        f"with labels {m.labelnames}"
                    )
                return m
            m = cls(name, help, labelnames, **kw)
            m._registry = self
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(
        self,
        name: str,
        help: str = "",
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_TIME_BUCKETS,
    ) -> Histogram:
        return self._register(Histogram, name, help, labelnames, buckets=buckets)

    def collect(self) -> List[_Metric]:
        with self._lock:
            return sorted(self._metrics.values(), key=lambda m: m.name)

    # ------------------------------------------------------------- flat views
    def counter_values(self) -> Dict[str, float]:
        """Flat ``name{label="v",...}`` -> value map of every COUNTER series.

        Counters only: they are the sum-aggregatable subset, which is what
        the cohort delta reduce (the JAX package's ``telemetry.cohort``) ships —
        gauges and histogram internals don't add meaningfully across peers.
        """
        out: Dict[str, float] = {}
        for m in self.collect():
            if m.kind != "counter":
                continue
            for labels, value in m.samples():
                out[_series_name(m.name, labels)] = value
        return out

    def snapshot(self) -> Dict[str, object]:
        """JSON-ready dump of every metric family (exporters use this)."""
        out: Dict[str, object] = {}
        for m in self.collect():
            fam = {"kind": m.kind, "help": m.help, "series": []}
            if m.kind == "histogram":
                fam["buckets"] = list(m.buckets)
            for labels, value in m.samples():
                fam["series"].append({"labels": labels, "value": value})
            out[m.name] = fam
        return out

    def reset_for_tests(self) -> None:
        """Drop every registered metric.  Test isolation only — production
        code must never reset counters (rates are computed from deltas)."""
        with self._lock:
            self._metrics.clear()


def _series_name(name: str, labels: Dict[str, str]) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


_default_registry: Optional[Registry] = None
_default_lock = threading.Lock()


def get_registry() -> Registry:
    """The process-wide registry every subsystem wires into."""
    global _default_registry
    if _default_registry is None:
        with _default_lock:
            if _default_registry is None:
                _default_registry = Registry()
    return _default_registry
