"""Exporters: Prometheus text exposition, HTTP endpoint, JSONL snapshots,
dump-on-SIGUSR1.

All opt-in and stdlib-only.  The usual wiring is one
:func:`moolib_tpu_torch.telemetry.init_from_env` call at the top of a training
entry point; each exporter can also be driven directly:

- :func:`prometheus_text` — the registry in Prometheus text exposition
  format 0.0.4 (counters, gauges, histograms with ``_bucket/_sum/_count``).
- :func:`serve_http` — a daemon-thread ``http.server`` answering
  ``/metrics`` (Prometheus text) and ``/trace`` (Chrome trace JSON).
- :class:`JsonlSnapshotter` — periodic one-line JSON snapshots of every
  metric family appended to ``<dir>/telemetry.jsonl`` (plus a final Chrome
  trace at ``close()``), for offline rate computation when no scraper runs.
- :func:`install_signal_dump` — SIGUSR1 prints the Prometheus text (and
  writes the Chrome trace when a run dir is known): kick a live process for
  its counters without attaching anything.
"""

from __future__ import annotations

import json
import math
import os
import signal
import sys
import threading
import time
import traceback
from typing import Optional

from .flightrec import format_tail as _flight_tail
from .metrics import Registry, get_registry
from .tracing import Tracer, get_tracer

__all__ = [
    "prometheus_text",
    "serve_http",
    "JsonlSnapshotter",
    "dump_diagnostics",
    "install_signal_dump",
    "read_snapshot_tail",
]


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _fmt_labels(labels: dict, extra: Optional[tuple] = None) -> str:
    items = sorted(labels.items())
    if extra is not None:
        items = items + [extra]
    if not items:
        return ""
    inner = ",".join(
        '%s="%s"' % (k, str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n"))
        for k, v in items
    )
    return "{%s}" % inner


def prometheus_text(registry: Optional[Registry] = None) -> str:
    """Prometheus text exposition (format 0.0.4) of every registered
    metric.  Histograms render cumulative ``_bucket{le=...}`` series plus
    ``_sum``/``_count``, as scrapers expect."""
    registry = registry or get_registry()
    lines = []
    for m in registry.collect():
        if m.help:
            lines.append(f"# HELP {m.name} {m.help}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        if m.kind == "histogram":
            for labels, h in m.samples():
                cum = 0
                for bound, n in zip(m.buckets, h["buckets"]):
                    cum += n
                    lines.append(
                        f"{m.name}_bucket{_fmt_labels(labels, ('le', _fmt_value(bound)))} {cum}"
                    )
                cum += h["buckets"][-1]
                lines.append(f"{m.name}_bucket{_fmt_labels(labels, ('le', '+Inf'))} {cum}")
                lines.append(f"{m.name}_sum{_fmt_labels(labels)} {_fmt_value(h['sum'])}")
                lines.append(f"{m.name}_count{_fmt_labels(labels)} {h['count']}")
        else:
            for labels, v in m.samples():
                lines.append(f"{m.name}{_fmt_labels(labels)} {_fmt_value(v)}")
    return "\n".join(lines) + "\n"


def serve_http(
    port: int = 0,
    host: str = "127.0.0.1",
    registry: Optional[Registry] = None,
    tracer: Optional[Tracer] = None,
) -> int:
    """Serve ``/metrics`` (Prometheus text) and ``/trace`` (Chrome trace
    JSON) from a daemon thread; returns the bound port (``port=0`` picks a
    free one).  Loopback by default — exposing beyond the host is a
    deployment decision, not a library default."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    registry = registry or get_registry()
    tracer = tracer or get_tracer()

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 — http.server API
            if self.path.split("?")[0] == "/metrics":
                body = prometheus_text(registry).encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif self.path.split("?")[0] == "/trace":
                body = json.dumps(tracer.chrome_trace()).encode()
                ctype = "application/json"
            else:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # scrapes must not spam stderr
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    t = threading.Thread(target=server.serve_forever, name="telemetry-http", daemon=True)
    t.start()
    return server.server_address[1]


class JsonlSnapshotter:
    """Append one JSON line of the full registry snapshot to
    ``<run_dir>/telemetry.jsonl`` every ``interval`` seconds (daemon
    thread); ``close()`` writes a final snapshot plus the Chrome trace to
    ``<run_dir>/host_trace.json``.  Rates are computed offline from
    consecutive counter snapshots, so no scraper needs to be running."""

    def __init__(
        self,
        run_dir: str,
        interval: float = 15.0,
        registry: Optional[Registry] = None,
        tracer: Optional[Tracer] = None,
    ):
        self._registry = registry or get_registry()
        self._tracer = tracer or get_tracer()
        self._dir = run_dir
        self._path = os.path.join(run_dir, "telemetry.jsonl")
        self._interval = float(interval)
        self._stop = threading.Event()
        os.makedirs(run_dir, exist_ok=True)
        self._thread = threading.Thread(
            target=self._run, name="telemetry-jsonl", daemon=True
        )
        self._thread.start()

    def snapshot_now(self) -> None:
        row = {
            "time": time.time(),
            "pid": os.getpid(),
            "metrics": self._registry.snapshot(),
        }
        with open(self._path, "a") as f:
            f.write(json.dumps(row) + "\n")

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.snapshot_now()
            except OSError:
                return  # run dir vanished; stop quietly

    def flush(self) -> None:
        """Write a snapshot + the host Chrome trace now, without stopping
        the periodic thread (end-of-run flush; the process may train again)."""
        try:
            self.snapshot_now()
            self._tracer.export_chrome_trace(os.path.join(self._dir, "host_trace.json"))
        except OSError:
            pass

    def close(self) -> None:
        self._stop.set()
        self.flush()


def read_snapshot_tail(path: str, max_bytes: int = 1 << 20):
    """Last parseable JSONL snapshot in ``path`` (None if absent/empty) —
    the reader counterpart of :class:`JsonlSnapshotter`, shared by the
    autoscaler's file-tail sampling and the cohort aggregator's fallbacks.
    Reads only the file tail: snapshot files grow for the process lifetime,
    and a half-written final line (snapshotter racing us) falls back to the
    previous complete one."""
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - max_bytes))
            tail = f.read().decode("utf-8", errors="replace")
    except OSError:
        return None
    for line in reversed(tail.splitlines()):
        line = line.strip()
        if not line:
            continue
        try:
            snap = json.loads(line)
        except ValueError:
            continue
        if isinstance(snap, dict) and "metrics" in snap:
            return snap
    return None


def dump_diagnostics(
    reason: str = "",
    run_dir: Optional[str] = None,
    registry: Optional[Registry] = None,
    tracer: Optional[Tracer] = None,
    file=None,
    stacks: bool = True,
) -> None:
    """One-stop diagnostic dump shared by the SIGUSR1 handler and the
    run-loop watchdog: the registry in
    Prometheus text, the python stack of every live thread (wedge triage:
    *where* is each thread blocked?), the flight recorder's tail, the
    lock-order graph's findings, the device monitor's summary, and — when
    a run dir is known — the host Chrome trace.  Only formats already-collected data, so it is safe
    from a signal handler or a monitor thread."""
    registry = registry or get_registry()
    tracer = tracer or get_tracer()
    out = file or sys.stderr
    header = f"pid {os.getpid()}" + (f", {reason}" if reason else "")
    parts = [f"--- telemetry dump ({header}) ---\n", prometheus_text(registry)]
    if stacks:
        names = {t.ident: t.name for t in threading.enumerate()}
        for tid, frame in sys._current_frames().items():
            parts.append(f"--- thread {names.get(tid, '?')!r} (ident {tid}) ---\n")
            parts.append("".join(traceback.format_stack(frame)))
    # The flight recorder's recent-event tail: what the process believed
    # was happening right before the dump (watchdog expiry, crash, signal).
    parts.append(_flight_tail())
    # Lock-order graph (MOOLIB_LOCKGRAPH=1): observed acquisition-order
    # cycles with both offending stacks, plus long-hold outliers.
    try:
        from ..testing import lockgraph as _lockgraph

        parts.append(_lockgraph.diagnostics_tail())
    except Exception:  # noqa: BLE001 — diagnostics must never throw
        pass
    # Device performance plane: memory watermarks and the counted step
    # costs — the "why is the card idle" tail.
    try:
        from . import devmon as _devmon

        parts.append(_devmon.summary_text())
    except Exception:  # noqa: BLE001 — diagnostics must never throw
        pass
    parts.append("--- end telemetry dump ---\n")
    out.write("".join(parts))
    try:
        out.flush()
    except OSError:
        pass
    if run_dir:
        try:
            tracer.export_chrome_trace(os.path.join(run_dir, "host_trace.json"))
        except OSError:
            pass


_signal_installed = False


def install_signal_dump(
    run_dir: Optional[str] = None,
    registry: Optional[Registry] = None,
    tracer: Optional[Tracer] = None,
    signum: int = signal.SIGUSR1,
) -> bool:
    """SIGUSR1 → :func:`dump_diagnostics` to stderr (metrics + thread
    stacks, plus the Chrome trace into ``run_dir`` when given).  Main
    thread only (CPython restriction); returns False when the handler
    could not be installed."""
    global _signal_installed
    registry = registry or get_registry()
    tracer = tracer or get_tracer()

    def _dump(sig, frame):
        dump_diagnostics(
            reason=f"signal {sig}", run_dir=run_dir, registry=registry, tracer=tracer
        )

    try:
        signal.signal(signum, _dump)
    except (ValueError, OSError):  # not the main thread, or unsupported
        return False
    _signal_installed = True
    return True
