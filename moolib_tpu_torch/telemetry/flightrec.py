"""Flight recorder: a bounded in-memory ring of recent *notable* events.

The span tracer records everything and overflows quickly under load; the
metrics registry keeps totals but no ordering.  The flight recorder sits
between them: subsystems append one-line events at state transitions that
matter for postmortems — epoch bumps, elections, broker failovers, hot
swaps, watchdog expiries, scale events — and the newest few hundred are
dumped verbatim alongside the SIGUSR1 / watchdog diagnostics
(:func:`moolib_tpu_torch.telemetry.exporters.dump_diagnostics`).  A soak kill
then shows *what the process believed was happening* in its last seconds
without any log archaeology.

Events are wall-clock stamped (they must line up with other hosts' logs),
mirror into the span tracer as instant events (so they also appear on the
Chrome timeline), and cost one deque append — safe from IO threads and
signal-adjacent paths.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional, Tuple

from . import tracing

__all__ = [
    "FlightRecorder",
    "get_flight_recorder",
    "flight_event",
    "format_tail",
]


class FlightRecorder:
    """Bounded ring of ``(unix_time, name, args)`` events."""

    def __init__(self, capacity: int = 512):
        self._events: deque = deque(maxlen=capacity)

    def event(self, name: str, **args) -> None:
        """Record one event; also mirrored into the default span tracer as
        an instant event so merged traces show it in place."""
        self._events.append((time.time(), name, args or None))
        try:
            tracing.get_tracer().event(name, **args)
        except Exception:  # noqa: BLE001 — recording must never raise
            pass

    def events(self) -> List[Tuple[float, str, Optional[dict]]]:
        return list(self._events)

    def clear(self) -> None:
        self._events.clear()

    def format_tail(self, limit: Optional[int] = None) -> str:
        """Human-readable tail for diagnostic dumps (newest last).  Only
        formats already-recorded tuples — safe from a signal handler."""
        events = self.events()
        if limit is not None:
            events = events[-limit:]
        if not events:
            return "--- flight recorder: empty ---\n"
        lines = [f"--- flight recorder (last {len(events)} events) ---\n"]
        for t, name, args in events:
            stamp = time.strftime("%H:%M:%S", time.localtime(t)) + f".{int(t % 1 * 1000):03d}"
            if args:
                kv = " ".join(f"{k}={v}" for k, v in args.items())
                lines.append(f"{stamp} {name} {kv}\n")
            else:
                lines.append(f"{stamp} {name}\n")
        return "".join(lines)


_default: Optional[FlightRecorder] = None
_default_lock = threading.Lock()


def get_flight_recorder() -> FlightRecorder:
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = FlightRecorder()
    return _default


def flight_event(name: str, **args) -> None:
    """``telemetry.flight_event("group.epoch", epoch=7)`` against the
    process-default recorder."""
    get_flight_recorder().event(name, **args)


def format_tail(limit: Optional[int] = None) -> str:
    return get_flight_recorder().format_tail(limit)
