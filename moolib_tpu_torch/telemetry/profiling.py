"""On-demand ``torch.profiler`` trace windows, RPC- or signal-driven.

The port of the JAX package's ``telemetry/profiling.py``.  A device profile
is the one observability surface you cannot leave running: it costs memory
and perturbs timing.  This module makes it a *window* you open remotely on
a live process — over the ``__telemetry_profile`` RPC every scrapable peer
defines (:func:`moolib_tpu_torch.telemetry.aggregator.install_rpc_handlers`)
or a local signal toggle — and closes either explicitly or after a timed
duration.  A window captures with ``torch.profiler`` (CPU activity, plus
CUDA where there is a card) and writes a Chrome trace JSON
(``<logdir>/<host>_<pid>.pt.trace.json``) when it closes.

Torch's profiler is one slot per process, and Kineto ties start and stop
to the thread that registered it; the RPC handler, the timeline's opener
and the max-window guard all run on different threads.  So one dedicated
thread owns the profiler, and every start and stop is queued to it.  CPU
ops of every thread are recorded where torch supports it
(``profile_all_threads``); CUDA kernels are recorded device-wide.

Torch stamps trace events in µs on Kineto's clock, whose origin differs by
version.  Every window therefore emits ``record_function`` markers
(``CLOCK_MARKER.<i>``) at known ``perf_counter_ns`` right after it starts,
and writes ``moolib_anchor.json`` beside the trace: the window's
``(unix_time_ns, perf_counter_ns)`` start anchors, the tightest marker's
name and its host time.  ``telemetry.timeline.load_profiler_trace``
aligns on it.

Each window records a ``device_profile`` span in the host tracer when it
closes, on the same ``perf_counter_ns`` clock every other span uses.
Torch is imported inside the start path only.
"""

from __future__ import annotations

import json
import os
import queue
import signal as _signal
import socket
import threading
import time
from typing import Optional

from . import tracing
from .flightrec import flight_event

__all__ = [
    "CLOCK_MARKER",
    "start_device_trace",
    "stop_device_trace",
    "profile_status",
    "handle_command",
    "install_signal_toggle",
]

_lock = threading.Lock()
_active: Optional[dict] = None  # {"logdir", "t0_ns", "unix_ns", "timer", "guard", "prof"}

DEFAULT_WINDOW_S = 3.0
# Hard ceiling on any window's lifetime: a requester killed mid-window
# would otherwise leave the profiler armed forever.
# MOOLIB_PROFILE_MAX_WINDOW_S overrides; <= 0 disables the guard.
DEFAULT_MAX_WINDOW_S = 120.0
CLOCK_MARKER = "moolib_clock_anchor"
ANCHOR_FILE = "moolib_anchor.json"


class _Owner:
    """The one thread that starts and stops the profiler."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._tlock = threading.Lock()

    def _run(self) -> None:
        while True:
            fn, args, box = self._q.get()
            try:
                box.put((True, fn(*args)))
            except BaseException as e:  # noqa: BLE001 — handed to the caller
                box.put((False, e))

    def call(self, fn, *args):
        if threading.current_thread() is self._thread:
            return fn(*args)
        with self._tlock:
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="torch-profiler-owner", daemon=True)
                self._thread.start()
        box: "queue.Queue" = queue.Queue(1)
        self._q.put((fn, args, box))
        ok, val = box.get()
        if not ok:
            raise val
        return val


_owner = _Owner()


def _start_profiler():
    """On the owner thread: start a profiler and emit the clock markers.
    Returns ``(prof, marker_name, marker_perf_ns)``: of a few markers, the
    one whose host-clock bracket was tightest (a thread preempted inside
    one bracket would misplace it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    try:
        cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
        prof = profile(activities=acts, experimental_config=cfg)
    except (TypeError, AttributeError):  # a torch without profile_all_threads
        prof = profile(activities=acts)
    prof.start()
    with record_function(CLOCK_MARKER + ".warmup"):
        pass
    best = None
    for i in range(5):
        t0 = time.perf_counter_ns()
        with record_function(f"{CLOCK_MARKER}.{i}"):
            t1 = time.perf_counter_ns()
        if best is None or t1 - t0 < best[0]:
            best = (t1 - t0, f"{CLOCK_MARKER}.{i}", (t0 + t1) // 2)
    return prof, best[1], best[2]


def _stop_profiler(prof, logdir: str, anchors: dict) -> str:
    """On the owner thread: stop, export the Chrome trace and the anchors."""
    prof.stop()
    path = os.path.join(logdir, f"{socket.gethostname()}_{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(path)
    with open(os.path.join(logdir, ANCHOR_FILE), "w") as f:
        json.dump(anchors, f)
    return path


def _max_window_s() -> float:
    try:
        return float(
            os.environ.get("MOOLIB_PROFILE_MAX_WINDOW_S", str(DEFAULT_MAX_WINDOW_S))
        )
    except ValueError:
        return DEFAULT_MAX_WINDOW_S


def _arm_guard(logdir: str, max_s: float):
    """Watchdog-fed deadline that force-stops an abandoned window.  Returns
    the guard to close on a normal stop; a plain daemon Timer stands in if
    the Watchdog cannot be built."""

    def _expire(_section: str, timeout: float) -> None:
        with _lock:
            abandoned = _active is not None and _active["logdir"] == logdir
        if not abandoned:
            return  # the window was stopped (and maybe another opened) in time
        flight_event("profile.abandoned", logdir=logdir, max_window_s=timeout)
        tracing.get_tracer().event(
            "device_profile.abandoned", logdir=logdir, max_window_s=timeout
        )
        stop_device_trace()

    try:
        from ..watchdog import Watchdog

        wd = Watchdog(
            timeout=max_s, on_expire=_expire, name="profile-window", dump=False
        )
        wd.arm("device_profile", max_s)
        return wd
    except Exception:  # noqa: BLE001 — guard must not block the profile itself
        timer = threading.Timer(max_s, _expire, args=("device_profile", max_s))
        timer.daemon = True
        timer.start()
        return timer


def _close_guard(guard) -> None:
    if guard is None:
        return
    try:
        guard.close()  # Watchdog
    except AttributeError:
        guard.cancel()  # Timer fallback


def _default_logdir() -> str:
    base = os.environ.get("MOOLIB_PROFILE_DIR") or os.path.join(
        os.environ.get("TMPDIR", "/tmp"), "moolib_profiles"
    )
    return os.path.join(base, f"pid{os.getpid()}-{int(time.time())}")


def start_device_trace(logdir: Optional[str] = None) -> dict:
    """Open a ``torch.profiler`` trace window.  Returns ``{"ok": True,
    "logdir", "unix_time_ns", "perf_counter_ns"}`` (the anchors match the
    host tracer's clock) or ``{"ok": False, "error"}`` — never raises, so
    the RPC handler can always serialize the answer."""
    global _active
    with _lock:
        if _active is not None:
            return {"ok": False, "error": "profile already active", "logdir": _active["logdir"]}
        logdir = logdir or _default_logdir()
        try:
            os.makedirs(logdir, exist_ok=True)
            unix_ns, t0_ns = time.time_ns(), time.perf_counter_ns()
            prof, marker, marker_ns = _owner.call(_start_profiler)
        except ImportError:
            return {"ok": False, "error": "torch unavailable"}
        except Exception as e:  # noqa: BLE001 — report, don't kill the peer
            return {"ok": False, "error": f"start_trace failed: {e}"}
        _active = {
            "logdir": logdir,
            "t0_ns": t0_ns,
            "unix_ns": unix_ns,
            "marker": marker,
            "marker_ns": marker_ns,
            "prof": prof,
            "timer": None,
            "guard": None,
        }
        tracing.get_tracer().event("device_profile.start", logdir=logdir)
        anchors = {
            "ok": True,
            "logdir": logdir,
            "unix_time_ns": unix_ns,
            "perf_counter_ns": t0_ns,
        }
    # Outside the lock: the guard's expiry path calls stop_device_trace.
    max_s = _max_window_s()
    if max_s > 0:
        guard = _arm_guard(logdir, max_s)
        with _lock:
            if _active is not None and _active["logdir"] == logdir:
                _active["guard"] = guard
            else:  # stopped already (tiny window) — don't leak the monitor
                _close_guard(guard)
    return anchors


def stop_device_trace() -> dict:
    """Close the active window, write its trace; records the
    ``device_profile`` host span covering it."""
    global _active
    err = None
    path = None
    with _lock:
        if _active is None:
            return {"ok": False, "error": "no profile active"}
        state, _active = _active, None
        timer = state.get("timer")
        if timer is not None:
            timer.cancel()
        anchors = {
            "unix_time_ns": state["unix_ns"],
            "perf_counter_ns": state["t0_ns"],
            "marker": state["marker"],
            "marker_perf_ns": state["marker_ns"],
        }
        try:
            path = _owner.call(_stop_profiler, state["prof"], state["logdir"], anchors)
        except Exception as e:  # noqa: BLE001
            err = {"ok": False, "error": f"stop_trace failed: {e}", "logdir": state["logdir"]}
    # Outside the lock: closing the guard may join its monitor thread, whose
    # expiry path takes _lock.
    _close_guard(state.get("guard"))
    if err is not None:
        return err
    dur_ns = time.perf_counter_ns() - state["t0_ns"]
    tracing.get_tracer().record(
        "device_profile",
        state["t0_ns"],
        dur_ns,
        args={"logdir": state["logdir"]},
    )
    return {"ok": True, "logdir": state["logdir"], "trace": path,
            "duration_s": dur_ns / 1e9}


def profile_status() -> dict:
    with _lock:
        if _active is None:
            return {"active": False}
        return {"active": True, "logdir": _active["logdir"]}


def handle_command(
    action: str, logdir: Optional[str] = None, seconds: Optional[float] = None
) -> dict:
    """The ``__telemetry_profile`` RPC surface:

    - ``"start"`` — open a window (until an explicit stop).
    - ``"stop"`` — close it.
    - ``"status"`` — is one open, and where.
    - ``"window"`` — open and auto-close after ``seconds``
      (default :data:`DEFAULT_WINDOW_S`); the follow-up stop runs on a
      daemon timer, so the requesting client doesn't have to stay alive.
    """
    if action == "start":
        return start_device_trace(logdir)
    if action == "stop":
        return stop_device_trace()
    if action == "status":
        return profile_status()
    if action == "window":
        res = start_device_trace(logdir)
        if not res.get("ok"):
            return res
        delay = DEFAULT_WINDOW_S if seconds is None else max(0.1, float(seconds))
        timer = threading.Timer(delay, stop_device_trace)
        timer.daemon = True
        with _lock:
            if _active is not None:
                _active["timer"] = timer
        timer.start()
        res["window_s"] = delay
        return res
    return {"ok": False, "error": f"unknown action {action!r}"}


def install_signal_toggle(
    signum: int = _signal.SIGUSR2, logdir: Optional[str] = None
) -> bool:
    """Toggle a trace window on ``signum`` (default SIGUSR2 — the SIGUSR1
    slot belongs to the diagnostics dump).  Main thread only; returns False
    when the handler could not be installed.  The toggle runs on a helper
    thread: a start or stop waits on the profiler's owner thread, which a
    signal handler must not do."""

    def _toggle(sig, frame):
        def run():
            if profile_status()["active"]:
                stop_device_trace()
            else:
                start_device_trace(logdir)

        threading.Thread(target=run, name="profile-toggle", daemon=True).start()

    try:
        _signal.signal(signum, _toggle)
    except (ValueError, OSError):
        return False
    return True
