"""moolib_tpu_torch.telemetry — metrics registry + span tracing.

The slim counterpart of the JAX package's ``telemetry`` package: the metric
registry, the host span tracer (with the distributed trace context the RPC
layer carries on every call frame), the opt-in exporters, the flight
recorder of notable events (``flightrec``: epoch bumps, broker failovers,
watchdog expiries), :class:`CohortCounters`, which ship counter deltas
on the agents' ``GlobalStatsAccumulator`` reduce, the device monitor
(``devmon``: card memory, counted step FLOPs, MFU), and the cohort
aggregator (``aggregator``: the ``__telemetry_*`` scrape endpoints every
serving replica and Accumulator installs, :class:`CohortAggregator`).  The
profiling and timeline planes come with a later slice;
``recovery`` (the ``recovery_seconds{phase}`` family) came with EnvPool's
worker supervision.

Environment knobs (read by :func:`init_from_env`, which entry points call
once; everything defaults to off):

- ``MOOLIB_TELEMETRY_HTTP_PORT`` — serve ``/metrics`` + ``/trace`` on this
  loopback port (``0`` picks a free port).
- ``MOOLIB_TELEMETRY_DIR`` — run directory for periodic JSONL snapshots
  (``telemetry.jsonl``) and the final host Chrome trace
  (``host_trace.json``).
- ``MOOLIB_TELEMETRY_INTERVAL`` — JSONL snapshot period, seconds
  (default 15).
- ``MOOLIB_TELEMETRY_SIGUSR1`` — ``0`` disables the dump-on-signal
  handler (installed by default when ``init_from_env`` runs on the main
  thread).
"""

from __future__ import annotations

import atexit
import os
import threading
from typing import Optional

from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    Registry,
    DEFAULT_SIZE_BUCKETS,
    DEFAULT_TIME_BUCKETS,
    get_registry,
)
from .tracing import (  # noqa: F401
    Span,
    TraceContext,
    Tracer,
    attach_context,
    child_span,
    current_context,
    decode_context,
    encode_context,
    get_tracer,
    root_span,
    span,
)
from .exporters import (  # noqa: F401
    JsonlSnapshotter,
    dump_diagnostics,
    install_signal_dump,
    prometheus_text,
    read_snapshot_tail,
    serve_http,
)
from .flightrec import (  # noqa: F401
    FlightRecorder,
    flight_event,
    get_flight_recorder,
)
from .cohort import CohortCounters  # noqa: F401
from .aggregator import CohortAggregator, install_rpc_handlers  # noqa: F401
from .recovery import observe_phase  # noqa: F401
from . import devmon  # noqa: F401,E402  (torch imported lazily inside)

__all__ = [
    "CohortAggregator",
    "CohortCounters",
    "Counter",
    "Gauge",
    "Histogram",
    "JsonlSnapshotter",
    "Registry",
    "Span",
    "TraceContext",
    "Tracer",
    "attach_context",
    "child_span",
    "current_context",
    "decode_context",
    "dump_diagnostics",
    "encode_context",
    "FlightRecorder",
    "flight_event",
    "flush",
    "get_flight_recorder",
    "get_registry",
    "get_tracer",
    "init_from_env",
    "install_rpc_handlers",
    "install_signal_dump",
    "observe_phase",
    "prometheus_text",
    "read_snapshot_tail",
    "root_span",
    "serve_http",
    "shutdown",
    "span",
]

_init_lock = threading.Lock()
_initialized = False
_snapshotter: Optional[JsonlSnapshotter] = None
_http_port: Optional[int] = None


def init_from_env() -> dict:
    """Start the exporters the environment asks for (see module docstring).

    Idempotent — only the first call starts anything.  Returns
    ``{"http_port": int|None, "run_dir": str|None}`` for logging."""
    global _initialized, _snapshotter, _http_port
    with _init_lock:
        if _initialized:
            return {"http_port": _http_port, "run_dir": _snapshotter._dir if _snapshotter else None}
        _initialized = True
        # Every failure below degrades to "that exporter is off" with a
        # stderr note — a malformed observability knob must never kill an
        # entry point at startup.
        run_dir = os.environ.get("MOOLIB_TELEMETRY_DIR") or None
        port_s = os.environ.get("MOOLIB_TELEMETRY_HTTP_PORT")
        if port_s is not None:
            try:
                _http_port = serve_http(int(port_s))
            except (OSError, ValueError) as e:
                _http_port = None
                _warn(f"http exporter disabled ({e!r})")
        if run_dir:
            try:
                interval = float(os.environ.get("MOOLIB_TELEMETRY_INTERVAL", "15"))
            except ValueError as e:
                interval = 15.0
                _warn(f"bad MOOLIB_TELEMETRY_INTERVAL ({e!r}); using 15s")
            try:
                _snapshotter = JsonlSnapshotter(run_dir, interval=interval)
                atexit.register(shutdown)
            except OSError as e:
                run_dir = None
                _warn(f"jsonl exporter disabled ({e!r})")
        if os.environ.get("MOOLIB_TELEMETRY_SIGUSR1", "1") != "0":
            install_signal_dump(run_dir)
        devmon.install_from_env()  # MOOLIB_DEVMON_INTERVAL memory sampler
        return {"http_port": _http_port, "run_dir": run_dir}


def _warn(msg: str) -> None:
    import sys

    sys.stderr.write(f"moolib_tpu_torch.telemetry: {msg}\n")


def flush() -> None:
    """Write a JSONL snapshot + host trace now, keeping the exporters
    running."""
    with _init_lock:
        snap = _snapshotter
    if snap is not None:
        snap.flush()


def shutdown() -> None:
    """Stop the JSONL snapshotter after a final snapshot + host trace.
    Registered atexit by init_from_env."""
    global _snapshotter
    with _init_lock:
        snap, _snapshotter = _snapshotter, None
        if snap is not None:
            snap.close()
