"""Run-loop deadman timer (docs/RESILIENCE.md): a copy of the JAX
package's ``watchdog.py``, which is stdlib plus telemetry.

A *wedged* distributed run is worse than a dead one: it burns accelerator
reservations while reporting nothing, and the scheduler has no reason to
restart it.  The reference moolib has no answer beyond operator attention;
here every training loop can arm a :class:`Watchdog` around each section it
executes (env step, reduce, train step)::

    wd = Watchdog(timeout=120.0)
    ...
    with wd.section("env_step"):
        obs = fut.result()

If a section overruns its deadline, a monitor thread

1. dumps the telemetry registry and the python stack of every live thread
   through the same path the SIGUSR1 handler uses
   (:func:`moolib_tpu_torch.telemetry.exporters.dump_diagnostics`) — the triage
   artifact for "where was it stuck";
2. either invokes the ``on_expire`` hook (e.g. "save a checkpoint, then
   exit") or raises :class:`WatchdogTimeout` *inside the armed thread* so
   the loop's ``finally`` blocks run and the run ends with a resumable
   checkpoint instead of hanging silently.

The in-thread raise uses CPython's async-exception channel
(``PyThreadState_SetAsyncExc``), which delivers when the target thread next
executes bytecode.  The framework's wait loops all poll with sub-second
timeouts, so delivery is prompt; a thread blocked indefinitely inside a C
call would only see the exception on return (the diagnostics dump has
already fired by then).  A ``timeout`` of ``None``/``0`` disables the
watchdog entirely — ``section()`` becomes a no-op — so loops can wire it
unconditionally and let a flag decide.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
import time
from typing import Callable, Iterator, List, Optional, Tuple

from . import telemetry, utils
from .telemetry.exporters import dump_diagnostics

__all__ = ["Watchdog", "WatchdogTimeout"]

_REG = telemetry.get_registry()
_M_EXPIRED = _REG.counter(
    "watchdog_expirations_total", "armed sections that exceeded their deadline"
)


class WatchdogTimeout(RuntimeError):
    """An armed watchdog section exceeded its deadline."""


def _raise_in_thread(tid: int) -> None:
    """Deliver WatchdogTimeout to ``tid`` via the async-exception channel.
    A target that no longer exists (res == 0) is just logged — the wedge
    resolved itself by dying, and interrupting some *other* healthy thread
    would turn a recovered run into a dead one.  The diagnostics dump has
    already happened by this point either way."""
    res = ctypes.pythonapi.PyThreadState_SetAsyncExc(
        ctypes.c_ulong(tid), ctypes.py_object(WatchdogTimeout)
    )
    if res == 1:
        return
    if res > 1:  # hit more than one thread state: undo (should not happen)
        ctypes.pythonapi.PyThreadState_SetAsyncExc(ctypes.c_ulong(tid), None)
    utils.log_error(
        "watchdog: could not deliver WatchdogTimeout to thread %d (res=%d)",
        tid, res,
    )


class Watchdog:
    """Deadman timer for training-loop sections.

    One watchdog instance serves a whole loop: ``section(name)`` arms a
    deadline for its body and disarms on exit; overlapping/nested sections
    are independent arms.  ``arm()``/``feed()``/``disarm()`` expose the same
    machinery for non-``with`` shapes (e.g. "whole iteration" deadlines fed
    once per pass).  The monitor thread starts lazily on the first arm and
    is a daemon — an idle watchdog costs nothing and never blocks exit.
    """

    def __init__(
        self,
        timeout: Optional[float] = None,
        on_expire: Optional[Callable[[str, float], None]] = None,
        name: str = "",
        run_dir: Optional[str] = None,
        dump: bool = True,
        poll_interval: Optional[float] = None,
    ):
        self._timeout = float(timeout) if timeout and timeout > 0 else None
        self._on_expire = on_expire
        self._name = name
        self._run_dir = run_dir
        self._dump = dump
        self._poll = poll_interval
        self._lock = threading.Lock()
        # token -> (section, deadline, thread_ident, timeout)
        self._arms: dict = {}
        # Tokens currently being fired (dump in progress): kept in _arms so
        # disarm() can still cancel the pending raise, but not re-collected.
        self._firing: set = set()
        self._next_token = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        #: (section, timeout) records of every expiry, oldest first.
        self.expired: List[Tuple[str, float]] = []

    @property
    def enabled(self) -> bool:
        return self._timeout is not None

    # ------------------------------------------------------------------ arms
    def arm(
        self,
        section: str = "",
        timeout: Optional[float] = None,
        thread_id: Optional[int] = None,
    ) -> Optional[int]:
        """Start a deadline; returns a token for feed()/disarm(), or None
        when the effective timeout is disabled."""
        t = self._timeout if timeout is None else (
            float(timeout) if timeout and timeout > 0 else None
        )
        if t is None:
            return None
        tid = thread_id if thread_id is not None else threading.get_ident()
        with self._lock:
            token = self._next_token
            self._next_token += 1
            self._arms[token] = (section, time.monotonic() + t, tid, t)
            self._ensure_thread()
        return token

    def feed(self, token: Optional[int]) -> None:
        """Push the deadline of an armed token back by its full timeout
        (per-iteration heartbeat for long-lived arms)."""
        if token is None:
            return
        with self._lock:
            a = self._arms.get(token)
            if a is not None:
                self._arms[token] = (a[0], time.monotonic() + a[3], a[2], a[3])

    def disarm(self, token: Optional[int]) -> None:
        if token is None:
            return
        with self._lock:
            self._arms.pop(token, None)

    @contextlib.contextmanager
    def section(self, name: str, timeout: Optional[float] = None) -> Iterator[None]:
        """Arm around a loop section; a no-op when the watchdog is disabled."""
        token = self.arm(name, timeout)
        try:
            yield
        finally:
            self.disarm(token)

    # --------------------------------------------------------------- monitor
    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run,
                name=f"watchdog-{self._name or 'loop'}",
                daemon=True,
            )
            self._thread.start()

    def _interval(self) -> float:
        if self._poll:
            return self._poll
        base = self._timeout if self._timeout is not None else 1.0
        return max(0.05, min(0.25, base / 4))

    def _run(self) -> None:
        while not self._stop.wait(self._interval()):
            now = time.monotonic()
            fired = []
            with self._lock:
                for token, (sec, deadline, tid, t) in list(self._arms.items()):
                    if now > deadline and token not in self._firing:
                        self._firing.add(token)  # fire once per arm
                        fired.append((token, sec, tid, t))
            for token, sec, tid, t in fired:
                self._fire(token, sec, tid, t)

    def _fire(self, token: int, section: str, tid: int, timeout: float) -> None:
        _M_EXPIRED.inc()
        self.expired.append((section, timeout))
        label = f"watchdog {self._name!r}" if self._name else "watchdog"
        reason = f"{label}: section {section!r} exceeded its {timeout:.1f}s deadline"
        utils.log_error("%s", reason)
        # Before the dump: the expiry itself must appear in the flight
        # recorder tail the dump prints.
        telemetry.flight_event("watchdog.expired", watchdog=self._name,
                               section=section, timeout_s=timeout)
        if self._dump:
            try:
                dump_diagnostics(reason=reason, run_dir=self._run_dir)
            except Exception:  # noqa: BLE001 — diagnostics must not mask the expiry
                pass
        # The dump above is slow (thread stacks, maybe a trace write): the
        # section may have legitimately finished in the meantime.  disarm()
        # wins that race — a raise delivered AFTER the section completed
        # would kill an arbitrary later bytecode (e.g. mid-teardown) of a
        # run that in fact recovered.
        with self._lock:
            still_armed = self._arms.pop(token, None) is not None
            self._firing.discard(token)
        if not still_armed:
            utils.log_error(
                "%s — but the section completed during diagnostics; not raising",
                reason,
            )
            return
        if self._on_expire is not None:
            try:
                self._on_expire(section, timeout)
            except Exception as e:  # noqa: BLE001
                utils.log_error("watchdog on_expire hook failed: %r", e)
            return
        _raise_in_thread(tid)

    def close(self) -> None:
        """Disarm everything and stop the monitor thread."""
        self._stop.set()
        with self._lock:
            self._arms.clear()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=1.0)
        self._thread = None

    def __enter__(self) -> "Watchdog":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
