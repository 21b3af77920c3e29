"""Cohort aggregation: ship registry counter deltas on the existing
``GlobalStatsAccumulator`` reduce so leader logs show fleet-wide rates.

:class:`CohortCounters` implements the same snapshot/delta/apply_delta
protocol as ``StatSum``/``StatMean`` (``moolib_tpu_torch/utils/stats.py``), but
over the *whole registry's counter series* at once: its delta is a flat
``{series_name: increment}`` dict.  Drop one into the stats dict an agent
already reduces::

    stats["telemetry"] = telemetry.CohortCounters()
    ...
    global_stats.reduce(stats)          # unchanged call
    stats["telemetry"].value("envpool_steps_total")   # fleet-wide total

No second allreduce, no extra wire protocol: the deltas piggyback on the
agent's periodic stats round (``examples/common`` reduces dict deltas
key-wise).  Remote contributions accumulate in an overlay — local
instruments are never written to, so process-local exporters stay honest."""

from __future__ import annotations

import threading
from typing import Dict, Optional

from .metrics import Registry, get_registry

__all__ = ["CohortCounters"]


class _CounterSnapshot:
    """Frozen counter values; the delta-protocol baseline object."""

    __slots__ = ("values",)

    def __init__(self, values: Dict[str, float]):
        self.values = values

    def apply_delta(self, d: Dict[str, float]) -> None:
        """No-op, deliberately.  ``GlobalStatsAccumulator`` applies remote
        contributions to the delta baseline because ``StatSum.value`` is the
        *merged* total — here ``delta()`` reads the local instruments only
        (remote lives in the stat's overlay), so folding remote into the
        baseline would subtract other peers' progress from the next local
        delta and re-broadcast it as negative."""


class CohortCounters:
    """Registry counters as one cohort-reducible stat (see module doc)."""

    def __init__(self, registry: Optional[Registry] = None, prefix: str = ""):
        self._registry = registry or get_registry()
        self._prefix = prefix
        self._lock = threading.Lock()
        self._remote: Dict[str, float] = {}

    def _local(self) -> Dict[str, float]:
        vals = self._registry.counter_values()
        if self._prefix:
            vals = {k: v for k, v in vals.items() if k.startswith(self._prefix)}
        return vals

    # ---------------------------------------------------- delta protocol
    def snapshot(self) -> _CounterSnapshot:
        return _CounterSnapshot(self._local())

    def delta(self, prev: _CounterSnapshot) -> Dict[str, float]:
        base = prev.values
        cur = self._local()
        # Series can appear over time (a new label set binds); missing in
        # the baseline means it started at zero.
        return {k: v - base.get(k, 0.0) for k, v in cur.items()}

    def apply_delta(self, d: Dict[str, float]) -> None:
        with self._lock:
            for k, v in d.items():
                self._remote[k] = self._remote.get(k, 0.0) + v

    def reset(self) -> None:
        """Counters are monotonic — windowed reset is a no-op (matches
        ``StatSum`` semantics under ``GlobalStatsAccumulator.reset``)."""

    # ---------------------------------------------------------- reading
    def value(self, series: str) -> float:
        """Fleet-wide total for one series: local counter + every remote
        contribution learned through the reduce."""
        with self._lock:
            remote = self._remote.get(series, 0.0)
        return self._local().get(series, 0.0) + remote

    def result(self) -> Dict[str, float]:
        """Fleet-wide totals for every known series."""
        out = self._local()
        with self._lock:
            for k, v in self._remote.items():
                out[k] = out.get(k, 0.0) + v
        return out
