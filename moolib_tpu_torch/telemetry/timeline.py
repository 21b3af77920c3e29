"""Fused host+device step timeline: overlap/exposure attribution.

The port of the JAX package's ``telemetry/timeline.py``.  The host span
tracer (:mod:`moolib_tpu_torch.telemetry.tracing`) sees dispatch and RPC
wall time but not what the card ran, and a ``torch.profiler`` capture
(:mod:`moolib_tpu_torch.telemetry.profiling`) sees device slices but not
which train step they belong to.  This module fuses the two for one short
capture window at a time:

1. a window opens through :mod:`profiling` (so it can never overlap a
   user-requested profile — the profiler is a single slot) and records the
   start anchors ``(unix_time_ns, perf_counter_ns)``;
2. while it is open, every instrumented dispatch
   (:class:`moolib_tpu_torch.telemetry.devmon.dispatch_span` around the
   examples' train steps, :func:`~moolib_tpu_torch.telemetry.devmon.instrument`)
   reports its ``(fn, t0, t1)`` through the devmon dispatch hook, and
   host-side collective / host-blocked phases report through
   :func:`comm_span` / :func:`host_span` (the Accumulator's collective
   allreduce, the rollout fetch, the engine's decode fetch);
3. on close, the torch.profiler Chrome trace under the window's logdir is
   loaded, rebased onto the host anchors through the window's clock marker
   (:data:`profiling.CLOCK_MARKER`, written beside the trace), and every
   device slice is classified into {compute, collective-comm,
   host-blocked} by name;
4. wall time between consecutive dispatch starts is one *step* owned by
   the dispatching fn, and each step partitions exactly into

   - **compute** — device compute slices (plus the dispatch interval
     itself, which on the CPU *is* the execution),
   - **comm** — collective intervals NOT covered by concurrent compute
     (the *exposed* communication; collective time under compute is
     *overlapped* and counted inside compute's share),
   - **host** — host-blocked intervals (memcpys, and host spans fed via
     :func:`host_span`) not covered by either,
   - **idle** — the remainder,

   so ``step_time_fraction{bucket,fn}`` sums to 1.0 per fn by
   construction.

Exported metrics (the JAX package's names): ``step_time_fraction{bucket,fn}``,
``exposed_comm_seconds`` / ``overlapped_comm_seconds``,
``pipeline_bubble_fraction{stage}`` (per device track),
``timeline_comm_vs_psum_ratio`` (set whenever a window holds growth of
``accum_psum_seconds``, which ``parallel.redistribute`` and the
Accumulator's sharded share-down observe), plus ``timeline_windows_total``
/ ``timeline_ingest_errors_total``.

Periodic windows are off by default: ``MOOLIB_TIMELINE_INTERVAL=N`` opens
one ``MOOLIB_TIMELINE_WINDOW_S``-long window every N instrumented
dispatches (wired by :func:`moolib_tpu_torch.telemetry.init_from_env`).
Everything degrades: an unparsable capture or a user profile holding the
slot cost one skipped/host-only window, never the step.
"""

from __future__ import annotations

import gzip
import json
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from . import metrics, profiling, tracing
from .flightrec import flight_event

__all__ = [
    "BUCKETS",
    "begin_window",
    "classify_name",
    "comm_span",
    "configure",
    "end_window",
    "host_span",
    "ingest_window",
    "install_from_env",
    "load_profiler_trace",
    "on_dispatch",
    "reset_for_tests",
    "status",
]

_REG = metrics.get_registry()
_M_FRACTION = _REG.gauge(
    "step_time_fraction",
    "per-fn share of step wall time by bucket (compute / comm = exposed "
    "collectives / host = host-blocked / idle); sums to 1.0 per fn over "
    "the last timeline window",
    ("bucket", "fn"),
)
_M_EXPOSED = _REG.counter(
    "exposed_comm_seconds",
    "collective-comm seconds NOT covered by concurrent compute in timeline "
    "windows (the overlap work's target)",
)
_M_OVERLAPPED = _REG.counter(
    "overlapped_comm_seconds",
    "collective-comm seconds hidden behind concurrent compute in timeline "
    "windows",
)
_M_BUBBLE = _REG.gauge(
    "pipeline_bubble_fraction",
    "idle fraction of each device timeline track over the last window "
    "(per-stage bubble for the MPMD pipeline plane)",
    ("stage",),
)
_M_PSUM_RATIO = _REG.gauge(
    "timeline_comm_vs_psum_ratio",
    "timeline-measured collective seconds / accum_psum_seconds growth over "
    "the same window (cross-check between the device and host planes)",
)
_M_WINDOWS = _REG.counter(
    "timeline_windows_total", "timeline capture windows ingested"
)
_M_ERRORS = _REG.counter(
    "timeline_ingest_errors_total",
    "timeline windows whose device capture failed to load or parse",
)

BUCKETS = ("compute", "comm", "host", "idle")

DEFAULT_WINDOW_S = 0.25

# Substring classification of device slice names (the JAX package's table,
# unchanged).  Collectives first: "all-reduce-start.1" or an NCCL kernel
# ("ncclDevKernel_AllReduce_Sum_f32_RING_LL") must not fall through to
# compute.
_COMM_PATTERNS = (
    "all-reduce", "allreduce", "all-gather", "allgather", "reduce-scatter",
    "reducescatter", "all-to-all", "alltoall", "collective-permute",
    "collectivepermute", "collective", "psum", "ncclallreduce", "send",
    "recv",
)
_HOST_PATTERNS = (
    "infeed", "outfeed", "transfer", "copy", "memcpy", "h2d", "d2h",
    "host_callback", "device_to_host", "host_to_device",
)


def classify_name(name: str) -> str:
    """Bucket for one device-timeline slice name: "comm" for collectives,
    "host" for host<->device transfer/infeed work, else "compute"."""
    n = (name or "").lower()
    for pat in _COMM_PATTERNS:
        if pat in n:
            return "comm"
    for pat in _HOST_PATTERNS:
        if pat in n:
            return "host"
    return "compute"


# ------------------------------------------------------------ interval math
# Intervals are (start, end) float pairs on one axis (seconds here); all
# helpers return sorted, disjoint lists, so measures add exactly and the
# four buckets partition each step by construction.
def _union(iv: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted((s, e) for s, e in iv if e > s):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _measure(iv: Sequence[Tuple[float, float]]) -> float:
    return sum(e - s for s, e in iv)


def _clip(
    iv: Sequence[Tuple[float, float]], lo: float, hi: float
) -> List[Tuple[float, float]]:
    return [(max(s, lo), min(e, hi)) for s, e in iv if min(e, hi) > max(s, lo)]


def _subtract(
    a: Sequence[Tuple[float, float]], b: Sequence[Tuple[float, float]]
) -> List[Tuple[float, float]]:
    """a minus b; both must be sorted+disjoint (outputs of _union/_clip)."""
    out: List[Tuple[float, float]] = []
    bi = 0
    for s, e in a:
        cur = s
        while bi < len(b) and b[bi][1] <= cur:
            bi += 1
        j = bi
        while j < len(b) and b[j][0] < e:
            bs, be = b[j]
            if bs > cur:
                out.append((cur, bs))
            cur = max(cur, be)
            if cur >= e:
                break
            j += 1
        if cur < e:
            out.append((cur, e))
    return out


# ----------------------------------------------------------- device capture
def _find_trace_file(logdir: str) -> Optional[str]:
    """Newest ``*.trace.json(.gz)`` under ``logdir`` (torch.profiler writes
    ``<host>_<pid>.pt.trace.json``)."""
    best: Tuple[float, Optional[str]] = (-1.0, None)
    for root, _dirs, files in os.walk(logdir):
        for f in files:
            if f.endswith(".trace.json.gz") or f.endswith(".trace.json"):
                p = os.path.join(root, f)
                try:
                    mt = os.path.getmtime(p)
                except OSError:
                    continue
                if mt > best[0]:
                    best = (mt, p)
    return best[1]


# Kineto trace categories of work on the card; a trace without any of them
# (a CPU-only run) is read through its CPU operator events instead.
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _read_anchor(logdir: str) -> Optional[Dict[str, Any]]:
    from .profiling import ANCHOR_FILE

    try:
        with open(os.path.join(logdir, ANCHOR_FILE)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def load_profiler_trace(logdir: Optional[str]) -> List[Dict[str, Any]]:
    """Device slices from the newest Chrome trace JSON under ``logdir``:
    ``[{"name", "ts_us", "dur_us", "track", "bucket"}, ...]`` ("X" events
    only; metadata resolves pid/tid to a readable track label).

    Torch's trace carries CPU operators, CUDA runtime calls and the card's
    own work; the card's (categories ``kernel``, ``gpu_memcpy``,
    ``gpu_memset``) are the device slices.  A trace with none of them — a
    CPU-only run — yields its CPU operator events.  A kernel is never
    host-blocked work (its name may say "copy": a cast or a device-side
    copy runs on the SMs), so a kernel that :func:`classify_name` puts
    under "host" counts as compute.

    When the window's ``moolib_anchor.json`` is present, timestamps are
    rebased onto unix µs through the clock marker the window emitted at a
    known ``perf_counter_ns``.  Returns ``[]`` when there is nothing to
    load; raises only on a present but unparsable file (the caller counts
    it as an ingest error)."""
    if not logdir:
        return []
    path = _find_trace_file(logdir)
    if path is None:
        return []
    if path.endswith(".gz"):
        with gzip.open(path, "rt", encoding="utf-8", errors="replace") as f:
            data = json.load(f)
    else:
        with open(path, encoding="utf-8", errors="replace") as f:
            data = json.load(f)
    events = data.get("traceEvents", data if isinstance(data, list) else [])
    pnames: Dict[Any, str] = {}
    tnames: Dict[Tuple[Any, Any], str] = {}
    for ev in events:
        if ev.get("ph") == "M":
            argname = (ev.get("args") or {}).get("name")
            if ev.get("name") == "process_name" and argname:
                pnames[ev.get("pid")] = str(argname)
            elif ev.get("name") == "thread_name" and argname:
                tnames[(ev.get("pid"), ev.get("tid"))] = str(argname)
    # Clock: unix µs = ts + off_us, from the marker's host time.
    off_us = 0.0
    anchor = _read_anchor(logdir)
    if anchor is not None:
        marker = anchor.get("marker", "")
        for ev in events:
            if ev.get("ph") == "X" and ev.get("name") == marker:
                unix_us = (anchor["unix_time_ns"]
                           + (anchor["marker_perf_ns"] - anchor["perf_counter_ns"])) / 1e3
                off_us = unix_us - float(ev["ts"])
                break
    xs = [ev for ev in events if ev.get("ph") == "X"]
    cats = _DEVICE_CATS if any(ev.get("cat") in _DEVICE_CATS for ev in xs) else ("cpu_op",)
    out: List[Dict[str, Any]] = []
    for ev in xs:
        cat = ev.get("cat")
        if cat not in cats:
            continue
        try:
            ts = float(ev["ts"])
            dur = float(ev.get("dur", 0.0))
        except (KeyError, TypeError, ValueError):
            continue
        if dur <= 0:
            continue
        pid, tid = ev.get("pid"), ev.get("tid")
        track = tnames.get((pid, tid)) or pnames.get(pid) or f"{pid}/{tid}"
        name = str(ev.get("name", ""))
        bucket = classify_name(name)
        if cat == "kernel" and bucket == "host":
            bucket = "compute"
        out.append(
            {
                "name": name,
                "ts_us": ts + off_us,
                "dur_us": dur,
                "track": track,
                "bucket": bucket,
            }
        )
    return out


# -------------------------------------------------------------- attribution
def _host_to_unix_s(t_ns: int, anchor: Tuple[int, int]) -> float:
    """perf_counter_ns -> unix seconds via the window's start anchors."""
    unix_ns, perf_ns = anchor
    return (unix_ns + (t_ns - perf_ns)) / 1e9


def ingest_window(
    steps: Sequence[Tuple[str, int, int]],
    comm_spans: Sequence[Tuple[str, int, int]] = (),
    host_spans: Sequence[Tuple[str, int, int]] = (),
    slices: Sequence[Dict[str, Any]] = (),
    anchor: Optional[Tuple[int, int]] = None,
    window_end_ns: Optional[int] = None,
    psum_host_seconds: Optional[float] = None,
    publish: bool = True,
) -> Dict[str, Any]:
    """Attribute one capture window and (optionally) publish the gauges.

    ``steps`` / ``comm_spans`` / ``host_spans`` are host-clock
    ``(name, t0_ns, t1_ns)`` perf_counter records; ``slices`` come from
    :func:`load_profiler_trace`; ``anchor`` is the window's
    ``(unix_time_ns, perf_counter_ns)`` start pair (defaults to "now",
    which only matters when device slices need rebasing).  Returns the
    report dict tests and the smoke harness consume.
    """
    if anchor is None:
        anchor = (time.time_ns(), time.perf_counter_ns())
    steps = sorted(steps, key=lambda s: s[1])
    report: Dict[str, Any] = {
        "steps": len(steps),
        "slices": len(slices),
        "fns": {},
        "exposed_comm_seconds": 0.0,
        "overlapped_comm_seconds": 0.0,
        "bubble": {},
        "comm_vs_psum_ratio": None,
    }
    if not steps:
        return report

    # Host records onto the unix axis.
    step_pts = [
        (name, _host_to_unix_s(t0, anchor), _host_to_unix_s(t1, anchor))
        for name, t0, t1 in steps
    ]
    w0 = step_pts[0][1]
    w1 = max(s[2] for s in step_pts)
    if window_end_ns is not None:
        w1 = max(w1, _host_to_unix_s(window_end_ns, anchor))
    for _n, t0, t1 in (
        (n, _host_to_unix_s(a, anchor), _host_to_unix_s(b, anchor))
        for n, a, b in list(comm_spans) + list(host_spans)
    ):
        w1 = max(w1, t1)

    # Device slices onto the same axis.  Slices rebased through the window's
    # clock marker stamp unix microseconds already; a capture on a private
    # origin (or a synthetic fixture) is rebased so its first slice lands
    # at the window start.
    dev: List[Tuple[str, str, float, float]] = []  # (bucket, track, s, e)
    if slices:
        dmin = min(s["ts_us"] for s in slices)
        span = max(w1 - w0, 1e-6)
        off_s = 0.0
        if abs(dmin / 1e6 - w0) > 10.0 * span:
            off_s = w0 - dmin / 1e6
        for s in slices:
            t0 = s["ts_us"] / 1e6 + off_s
            t1 = t0 + s["dur_us"] / 1e6
            dev.append((s["bucket"], s["track"], t0, t1))

    compute_u = _union(
        [(t0, t1) for _n, t0, t1 in step_pts]
        + [(t0, t1) for b, _tr, t0, t1 in dev if b == "compute"]
    )
    comm_u = _union(
        [
            (_host_to_unix_s(a, anchor), _host_to_unix_s(b, anchor))
            for _n, a, b in comm_spans
        ]
        + [(t0, t1) for b, _tr, t0, t1 in dev if b == "comm"]
    )
    host_u = _union(
        [
            (_host_to_unix_s(a, anchor), _host_to_unix_s(b, anchor))
            for _n, a, b in host_spans
        ]
        + [(t0, t1) for b, _tr, t0, t1 in dev if b == "host"]
    )

    # One step = [this dispatch start, next dispatch start); the last step
    # runs to the window end so trailing comm/idle is attributed, not lost.
    fns: Dict[str, Dict[str, float]] = {}
    total_exposed = 0.0
    total_overlapped = 0.0
    for i, (name, t0, _t1) in enumerate(step_pts):
        end = step_pts[i + 1][1] if i + 1 < len(step_pts) else w1
        if end <= t0:
            continue
        comp = _clip(compute_u, t0, end)
        c = _measure(comp)
        comm_in = _clip(comm_u, t0, end)
        exposed_iv = _subtract(comm_in, comp)
        e = _measure(exposed_iv)
        overlapped = _measure(comm_in) - e
        host_in = _subtract(_subtract(_clip(host_u, t0, end), comp), comm_in)
        h = _measure(host_in)
        dur = end - t0
        row = fns.setdefault(
            name,
            {"compute": 0.0, "comm": 0.0, "host": 0.0, "idle": 0.0,
             "total": 0.0, "steps": 0.0, "overlapped": 0.0},
        )
        row["compute"] += c
        row["comm"] += e
        row["host"] += h
        row["idle"] += max(0.0, dur - c - e - h)
        row["total"] += dur
        row["steps"] += 1
        row["overlapped"] += overlapped
        total_exposed += e
        total_overlapped += overlapped

    for name, row in fns.items():
        total = row["total"] or 1.0
        fracs = {b: row[b] / total for b in BUCKETS}
        report["fns"][name] = {
            "fractions": fracs,
            "seconds": {b: row[b] for b in BUCKETS},
            "overlapped_comm_seconds": row["overlapped"],
            "steps": int(row["steps"]),
            "total_seconds": row["total"],
        }
        if publish:
            for b, v in fracs.items():
                _M_FRACTION.set(v, bucket=b, fn=name)
    report["exposed_comm_seconds"] = total_exposed
    report["overlapped_comm_seconds"] = total_overlapped

    # Per-stage bubble: each device track's idle share of the window.
    tracks: Dict[str, List[Tuple[float, float]]] = {}
    for _b, tr, t0, t1 in dev:
        tracks.setdefault(tr, []).append((t0, t1))
    for tr, iv in tracks.items():
        busy = _measure(_clip(_union(iv), w0, w1))
        frac = max(0.0, 1.0 - busy / max(w1 - w0, 1e-9))
        report["bubble"][tr] = frac
        if publish:
            _M_BUBBLE.set(frac, stage=tr)

    comm_total = total_exposed + total_overlapped
    if psum_host_seconds is not None and psum_host_seconds > 1e-9:
        ratio = comm_total / psum_host_seconds
        report["comm_vs_psum_ratio"] = ratio
        if publish:
            _M_PSUM_RATIO.set(ratio)
    if publish:
        _M_EXPOSED.inc(total_exposed)
        _M_OVERLAPPED.inc(total_overlapped)
        _M_WINDOWS.inc()
        tracing.get_tracer().event(
            "timeline.window",
            steps=len(steps),
            slices=len(slices),
            exposed_comm_s=round(total_exposed, 6),
        )
        flight_event(
            "timeline.window",
            steps=len(steps),
            exposed_comm_s=round(total_exposed, 6),
            overlapped_comm_s=round(total_overlapped, 6),
        )
    return report


# ---------------------------------------------------- periodic window plumbing
_lock = threading.Lock()
_state: Dict[str, Any] = {
    "interval": 0,          # dispatches between windows; 0 = off
    "window_s": DEFAULT_WINDOW_S,
    "device": True,         # open a torch.profiler capture per window
    "calls": 0,
    "opening": False,
    "window": None,         # active window dict
    "window_seq": 0,
    "windows": 0,           # ingested windows (for status())
    "last_report": None,
    "hooked": False,
}


def _psum_total() -> float:
    fam = _REG.snapshot().get("accum_psum_seconds") or {}
    total = 0.0
    for s in fam.get("series", ()):  # type: ignore[union-attr]
        v = s.get("value")
        if isinstance(v, dict):
            total += float(v.get("sum", 0.0))
    return total


def _timeline_logdir(seq: int) -> str:
    base = os.environ.get("MOOLIB_PROFILE_DIR") or os.path.join(
        os.environ.get("TMPDIR", "/tmp"), "moolib_profiles"
    )
    return os.path.join(base, f"timeline-pid{os.getpid()}-{seq}")


def _open_window(seq: int, window_s: Optional[float] = None) -> Optional[Dict[str, Any]]:
    """Open one capture window of ``window_s`` (default: the configured
    length; ``inf`` for an explicit window); None when the profiler slot is
    busy (a user-requested profile always wins)."""
    if window_s is None:
        window_s = _state["window_s"]
    anchor: Optional[Tuple[int, int]] = None
    logdir: Optional[str] = None
    if _state["device"]:
        if profiling.profile_status().get("active"):
            return None
        res = profiling.start_device_trace(_timeline_logdir(seq))
        if res.get("ok"):
            logdir = res["logdir"]
            anchor = (res["unix_time_ns"], res["perf_counter_ns"])
        elif "already active" in str(res.get("error", "")):
            return None
    if anchor is None:  # host-only window (device capture off)
        anchor = (time.time_ns(), time.perf_counter_ns())
    w: Dict[str, Any] = {
        "id": seq,
        "logdir": logdir,
        "anchor": anchor,
        "deadline": time.monotonic() + window_s,
        "steps": [],
        "comm": [],
        "host": [],
        "psum0": _psum_total(),
    }
    # Safety net: a loop that stops dispatching mid-window must not leave
    # the profiler slot held (the watchdog in profiling would eventually
    # force-stop it, but as an *abandoned* profile, which this is not).
    w["timer"] = None
    if window_s != float("inf"):
        t = threading.Timer(window_s * 4.0, _force_close, args=(seq,))
        t.daemon = True
        t.start()
        w["timer"] = t
    return w


def _discard_window(w: Dict[str, Any]) -> None:
    """Release a window that lost the install race (config changed while
    it was opening) without ingesting it."""
    timer = w.get("timer")
    if timer is not None:
        timer.cancel()
    if w["logdir"] is not None:
        profiling.stop_device_trace()


def _open_async(seq: int) -> None:
    """Open window ``seq`` off the dispatch path.  The first profiler start
    of a process initialises Kineto and CUPTI (up to seconds of wall
    time); run synchronously inside a dispatch it would stall the train
    loop — and with it heartbeat pumping, enough to churn a cohort.  The
    window simply becomes active a moment after its scheduling dispatch."""
    try:
        w = _open_window(seq)
    except Exception:  # noqa: BLE001 — telemetry must never kill the loop
        _M_ERRORS.inc()
        w = None
    with _lock:
        _state["opening"] = False
        install = (
            w is not None
            and _state["interval"] > 0
            and _state["window_seq"] == seq
            and _state["window"] is None
        )
        if install:
            _state["window"] = w
    if w is not None and not install:
        _discard_window(w)


def _force_close(window_id: int) -> None:
    with _lock:
        w = _state["window"]
        if w is None or w["id"] != window_id:
            return
        _state["window"] = None
    _finish_window(w)


def _finish_window(w: Dict[str, Any], sync: bool = False) -> Optional[Dict[str, Any]]:
    # End-of-window snapshot first: the stop below exports the capture
    # (up to seconds) and must not inflate the last step's wall time.
    w["end_ns"] = time.perf_counter_ns()
    w["psum_delta"] = max(0.0, _psum_total() - w["psum0"])
    timer = w.get("timer")
    if timer is not None:
        timer.cancel()
    if w["logdir"] is not None:
        res = profiling.stop_device_trace()
        if not res.get("ok"):
            _M_ERRORS.inc()
    if not w["steps"]:
        # A window that saw no dispatches (the loop idled or ended while it
        # was opening) carries no step attribution: release the slot but
        # don't ingest — an empty report must not clobber the last real one.
        return None
    if sync:
        return _ingest_thread(w)
    t = threading.Thread(
        target=_ingest_thread, args=(w,), name="timeline-ingest", daemon=True
    )
    t.start()
    return None


def _ingest_thread(w: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    try:
        slices = load_profiler_trace(w["logdir"])
    except Exception:  # noqa: BLE001 — a garbled capture is one error tick
        _M_ERRORS.inc()
        slices = []
    try:
        report = ingest_window(
            w["steps"],
            comm_spans=w["comm"],
            host_spans=w["host"],
            slices=slices,
            anchor=w["anchor"],
            window_end_ns=w["end_ns"],
            psum_host_seconds=w["psum_delta"],
        )
    except Exception:  # noqa: BLE001 — attribution must never kill the loop
        _M_ERRORS.inc()
        return None
    # The capture and the raw host records beside the attribution: where
    # the trace is, and the dispatches it was aligned against.
    report["logdir"] = w["logdir"]
    report["anchor"] = w["anchor"]
    report["dispatches"] = list(w["steps"])
    with _lock:
        _state["windows"] += 1
        _state["last_report"] = report
    return report


def begin_window(device: bool = True) -> bool:
    """Open an explicit window now, beside the periodic ones (they share the
    profiler slot): every instrumented dispatch records into it until
    :func:`end_window`.  Installs the dispatch hook for its lifetime.
    Returns False when a window is already open or the slot is busy."""
    from . import devmon

    with _lock:
        if _state["window"] is not None or _state["opening"]:
            return False
        _state["opening"] = True
        _state["window_seq"] += 1
        seq = _state["window_seq"]
        prev_device, _state["device"] = _state["device"], bool(device)
    try:
        w = _open_window(seq, window_s=float("inf"))
    finally:
        with _lock:
            _state["opening"] = False
            _state["device"] = prev_device
    if w is None:
        return False
    with _lock:
        _state["window"] = w
    devmon.set_dispatch_hook(on_dispatch)
    return True


def end_window() -> Optional[Dict[str, Any]]:
    """Close the explicit window (stopping its capture), ingest it on the
    caller's thread and return the report (with the capture's
    ``logdir``); None when no window was open or it saw no dispatch."""
    from . import devmon

    with _lock:
        w, _state["window"] = _state["window"], None
        hook = on_dispatch if _state["interval"] > 0 else None
    devmon.set_dispatch_hook(hook)
    if w is None:
        return None
    return _finish_window(w, sync=True)


def on_dispatch(name: str, t0_ns: int, t1_ns: int) -> None:
    """Devmon dispatch-hook target: count instrumented dispatches, record
    them into the active window, and open/close windows on schedule.
    Opening and closing both happen on short-lived background threads —
    this path runs inside every train-step dispatch and must never block
    on the profiler (the first start costs Kineto's init, a stop exports
    the capture)."""
    close = None
    open_seq = None
    with _lock:
        w = _state["window"]
        if w is not None:
            w["steps"].append((name, t0_ns, t1_ns))
            if time.monotonic() >= w["deadline"]:
                _state["window"] = None
                close = w
        elif _state["interval"] > 0 and not _state["opening"]:
            _state["calls"] += 1
            if _state["calls"] % _state["interval"] == 0:
                _state["opening"] = True
                _state["window_seq"] += 1
                open_seq = _state["window_seq"]
    if close is not None:
        threading.Thread(
            target=_finish_window, args=(close,), name="timeline-close",
            daemon=True,
        ).start()
    if open_seq is not None:
        threading.Thread(
            target=_open_async, args=(open_seq,), name="timeline-open",
            daemon=True,
        ).start()


class _PhaseSpan:
    """Records (name, t0_ns, t1_ns) into the active window's comm/host
    list; near-free when no window is open (one unlocked None check)."""

    __slots__ = ("_name", "_kind", "_t0")

    def __init__(self, name: str, kind: str):
        self._name = name
        self._kind = kind
        self._t0: Optional[int] = None

    def __enter__(self):
        if _state["window"] is not None:
            self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._t0 is not None:
            t1 = time.perf_counter_ns()
            with _lock:
                w = _state["window"]
                if w is not None:
                    w[self._kind].append((self._name, self._t0, t1))
        return False


def comm_span(name: str) -> "_PhaseSpan":
    """Mark the body as host-side collective communication for the active
    timeline window (the Accumulator's collective allreduce).  A
    no-op outside windows, so call sites wire it unconditionally."""
    return _PhaseSpan(name, "comm")


def host_span(name: str) -> "_PhaseSpan":
    """Mark the body as host-blocked device interaction (D2H fetch, infeed
    wait) for the active timeline window.  No-op outside windows."""
    return _PhaseSpan(name, "host")


def comm_mark() -> Optional[int]:
    """Timestamp (perf_counter_ns) for a later :func:`comm_interval`, or
    ``None`` when no window is open.  The pair exists for ASYNC comm whose
    begin/end straddle callbacks (the streaming gradient pipeline's
    per-bucket wire ops): the caller can't hold a ``comm_span`` context
    open across a launch→completion callback boundary, so it marks at
    launch and records retroactively at completion.  Keeps the clock choice
    inside telemetry (call sites never touch perf_counter directly)."""
    if _state["window"] is None:
        return None
    return time.perf_counter_ns()


def comm_interval(name: str, t0_ns: Optional[int],
                  t1_ns: Optional[int] = None) -> None:
    """Retroactively record ``[t0_ns, t1_ns]`` (``t1_ns`` defaults to now)
    as a comm span of the active window.  ``t0_ns=None`` (from a
    :func:`comm_mark` outside a window) is a no-op, so call sites wire the
    pair unconditionally.  Per-bucket spans may overlap each other and the
    step's compute — ``ingest_window`` unions comm spans before subtracting
    compute, so overlapping bucket ops count once, and the part concurrent
    with compute lands in ``overlapped_comm_seconds``, not exposed."""
    if t0_ns is None:
        return
    if t1_ns is None:
        t1_ns = time.perf_counter_ns()
    with _lock:
        w = _state["window"]
        if w is not None:
            w["comm"].append((name, int(t0_ns), int(t1_ns)))


def configure(
    interval: int,
    window_s: float = DEFAULT_WINDOW_S,
    device: bool = True,
) -> None:
    """Enable (interval > 0) or disable (0) periodic windows and install /
    remove the devmon dispatch hook accordingly."""
    from . import devmon

    with _lock:
        _state["interval"] = max(0, int(interval))
        _state["window_s"] = max(0.01, float(window_s))
        _state["device"] = bool(device)
        hook = on_dispatch if _state["interval"] > 0 else None
        _state["hooked"] = hook is not None
    devmon.set_dispatch_hook(hook)


def install_from_env() -> Dict[str, Any]:
    """Wire periodic windows per ``MOOLIB_TIMELINE_INTERVAL`` (dispatches
    between windows; unset/0 = off), ``MOOLIB_TIMELINE_WINDOW_S`` and
    ``MOOLIB_TIMELINE_DEVICE`` (``0`` skips the torch.profiler capture —
    host-only attribution).  Called by telemetry.init_from_env."""
    try:
        interval = int(os.environ.get("MOOLIB_TIMELINE_INTERVAL", "0") or 0)
    except ValueError:
        interval = 0
    try:
        window_s = float(
            os.environ.get("MOOLIB_TIMELINE_WINDOW_S", str(DEFAULT_WINDOW_S))
        )
    except ValueError:
        window_s = DEFAULT_WINDOW_S
    device = os.environ.get("MOOLIB_TIMELINE_DEVICE", "1") != "0"
    if interval > 0:
        configure(interval, window_s, device)
    return {"interval": interval, "window_s": window_s, "device": device}


def status() -> Dict[str, Any]:
    """Scheduler state for logs/consoles: {"interval", "window_s",
    "windows", "active", "last_report"}."""
    with _lock:
        return {
            "interval": _state["interval"],
            "window_s": _state["window_s"],
            "windows": _state["windows"],
            "active": _state["window"] is not None,
            "last_report": _state["last_report"],
        }


def reset_for_tests() -> None:
    """Close any open window without ingesting and drop scheduler state."""
    from . import devmon

    with _lock:
        w, _state["window"] = _state["window"], None
        _state.update(
            interval=0, window_s=DEFAULT_WINDOW_S, device=True, calls=0,
            opening=False, windows=0, last_report=None, hooked=False,
        )
    devmon.set_dispatch_hook(None)
    if w is not None:
        timer = w.get("timer")
        if timer is not None:
            timer.cancel()
        if w["logdir"] is not None:
            profiling.stop_device_trace()
