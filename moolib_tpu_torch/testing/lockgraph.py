"""Runtime lock-order race tooling (the dynamic half of the analysis plane).

``mtlint``'s blocking-under-lock check sees single-function lock scopes;
what it *cannot* see is the cross-thread acquisition order — the ABBA pair
where the RPC IO thread takes ``group._lock`` then ``accumulator._lock``
while a user thread takes them in the other order.  Both an
epoch-push-skew wedge and every broker-failover timeout budget live or die
on that ordering, and the scale-out cycle (MPMD stage graphs, actor/learner
splits) only adds threads holding more locks.

This module records the order at runtime: opt in with ``MOOLIB_LOCKGRAPH=1``
(checked by ``moolib_tpu_torch/__init__`` *before* any submodule creates a lock)
and every ``threading.Lock()`` / ``threading.RLock()`` — and therefore every
``Condition`` and ``Event`` built on them — becomes an instrumented shim
that feeds a process-wide acquisition-order graph:

- **nodes** are lock instances, named by their creation site;
- an **edge** A→B is recorded the first time any thread acquires B while
  holding A, with the full acquisition stack and the thread name;
- a **cycle** in that graph is a potential ABBA deadlock *even if the run
  never deadlocked* — it is reported the moment the closing edge appears
  (flight-recorder event + ``lockgraph_cycles_total``), shows up in
  ``dump_diagnostics`` output (SIGUSR1 / watchdog expiry), and fails the
  process at teardown with both stacks (``MOOLIB_LOCKGRAPH_STRICT=0``
  downgrades the teardown gate to a report);
- a hold longer than ``MOOLIB_LOCKGRAPH_HOLD_S`` (default 1.0s) is a
  **long-hold outlier** — recorded with its release stack and counted on
  ``lockgraph_long_holds_total`` (the static lint flags *blocking calls*
  under a lock; this catches the slow ones it cannot classify).

The chaos/serve soak smokes export ``MOOLIB_LOCKGRAPH=1`` in CI, so the
thread-heaviest paths in the tree — failover, hot swap, epoch churn — run
under the detector every build (``scripts/ci.sh``).

``Condition.wait`` is handled correctly: the wait *releases* the underlying
lock (tracked through the ``_release_save``/``_acquire_restore`` protocol),
so parking on a condition never fabricates a hold edge.

Overhead: a thread-local list append per acquire plus one stack capture per
*new* edge — steady state adds nanoseconds, which is why the soaks can
afford to run under it.  Nodes are keyed by lock identity; see
``tests/test_lockgraph.py`` for the contract.
"""

from __future__ import annotations

import atexit
import os
import sys
import threading
import time
import traceback
import _thread
from typing import Any, Dict, List, Optional, Set, Tuple

__all__ = [
    "InstrumentedLock",
    "InstrumentedRLock",
    "LockGraph",
    "default_graph",
    "diagnostics_tail",
    "install",
    "install_from_env",
    "installed",
    "uninstall",
]

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_THIS_FILE = os.path.abspath(__file__)


def _thread_name() -> str:
    """Current thread's name WITHOUT threading.current_thread(): on a
    foreign thread (ctypes callback) that call constructs a _DummyThread,
    whose init sets an Event — whose Condition lock is instrumented —
    re-entering the graph forever.  A plain registry read can't recurse."""
    ident = _thread.get_ident()
    t = threading._active.get(ident)
    return t.name if t is not None else f"thread-{ident}"


def _creation_site() -> str:
    """file:line of the first caller frame outside this module."""
    frame = sys._getframe(1)
    while frame is not None:
        path = os.path.abspath(frame.f_code.co_filename)
        if path != _THIS_FILE:
            short = os.sep.join(path.split(os.sep)[-2:])
            return f"{short}:{frame.f_lineno}"
        frame = frame.f_back
    return "<unknown>"


class LockGraph:
    """The process-wide acquisition-order graph.

    Thread-safe; its own mutual exclusion uses a raw ``_thread`` lock so the
    graph never instruments itself.  Telemetry (flight events, counters) is
    emitted *outside* the internal lock and only on the rare events (new
    cycle, long hold), keeping the per-acquire path allocation-free.
    """

    def __init__(self, hold_threshold_s: Optional[float] = None):
        self._mu = _thread.allocate_lock()
        self._tls = threading.local()
        #: lock id -> creation-site name
        self._names: Dict[int, str] = {}
        #: (held id, acquired id) -> edge info (first stack wins)
        self._edges: Dict[Tuple[int, int], Dict[str, Any]] = {}
        self._cycles: List[Dict[str, Any]] = []
        self._cycle_keys: Set[Tuple[int, ...]] = set()
        self.long_holds: List[Dict[str, Any]] = []
        if hold_threshold_s is None:
            hold_threshold_s = float(os.environ.get("MOOLIB_LOCKGRAPH_HOLD_S", "1.0"))
        self.hold_threshold_s = hold_threshold_s

    # -- bookkeeping -----------------------------------------------------
    def _held(self) -> List[Tuple[int, float]]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def register(self, lock_id: int, name: str) -> None:
        with self._mu:
            if lock_id in self._names:
                # id() reuse after GC: the previous lock at this address is
                # dead (short-lived Future/Event locks churn constantly).
                # Its ordering edges are stale — left in place they alias
                # unrelated locks into false ABBA cycles.
                self._edges = {
                    k: v for k, v in self._edges.items() if lock_id not in k
                }
            self._names[lock_id] = name

    def name_of(self, lock_id: int) -> str:
        return self._names.get(lock_id, f"lock@{lock_id:#x}")

    def on_acquired(self, lock_id: int) -> None:
        held = self._held()
        if getattr(self._tls, "busy", False):
            # Re-entered from our own bookkeeping/emission (telemetry locks,
            # stack capture): keep the hold paired for release, record no edge.
            held.append((lock_id, time.monotonic()))
            return
        new_cycle = None
        if held:
            self._tls.busy = True
            try:
                stack = None
                thread = _thread_name()
                with self._mu:
                    for held_id, _t0 in held:
                        if held_id == lock_id:
                            continue  # re-entrant outer hold, not an ordering edge
                        key = (held_id, lock_id)
                        edge = self._edges.get(key)
                        if edge is None:
                            if stack is None:
                                stack = traceback.format_stack(sys._getframe(2))
                            self._edges[key] = {
                                "stack": stack,
                                "thread": thread,
                                "count": 1,
                            }
                            found = self._find_cycle_locked(lock_id)
                            if found is not None:
                                new_cycle = found
                        else:
                            edge["count"] += 1
                if new_cycle is not None:
                    self._emit_cycle(new_cycle)
            finally:
                self._tls.busy = False
        held.append((lock_id, time.monotonic()))

    def on_released(self, lock_id: int) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == lock_id:
                _, t0 = held.pop(i)
                dt = time.monotonic() - t0
                if dt >= self.hold_threshold_s and not getattr(self._tls, "busy", False):
                    self._tls.busy = True
                    try:
                        self._emit_long_hold(lock_id, dt)
                    finally:
                        self._tls.busy = False
                return
        # release of a lock acquired before instrumentation: ignore

    # -- cycles ----------------------------------------------------------
    def _adjacency_locked(self) -> Dict[int, List[int]]:
        adj: Dict[int, List[int]] = {}
        for a, b in self._edges:
            adj.setdefault(a, []).append(b)
        return adj

    def _find_cycle_locked(self, start: int) -> Optional[List[int]]:
        """DFS from ``start`` back to itself (the freshly closed edge is the
        only place a *new* cycle can pass through)."""
        adj = self._adjacency_locked()
        path: List[int] = [start]
        seen: Set[int] = set()

        def dfs(node: int) -> Optional[List[int]]:
            for nxt in adj.get(node, ()):
                if nxt == start:
                    return list(path)
                if nxt in seen:
                    continue
                seen.add(nxt)
                path.append(nxt)
                out = dfs(nxt)
                if out is not None:
                    return out
                path.pop()
            return None

        cyc = dfs(start)
        if cyc is None:
            return None
        key = tuple(sorted(cyc))
        if key in self._cycle_keys:
            return None
        self._cycle_keys.add(key)
        edges = []
        for i, a in enumerate(cyc):
            b = cyc[(i + 1) % len(cyc)]
            info = self._edges.get((a, b), {})
            edges.append(
                {
                    "from": self.name_of(a),
                    "to": self.name_of(b),
                    "thread": info.get("thread", "?"),
                    "stack": info.get("stack") or [],
                }
            )
        record = {"locks": [self.name_of(n) for n in cyc], "edges": edges}
        self._cycles.append(record)
        return record

    def _emit_cycle(self, cycle: Dict[str, Any]) -> None:
        try:
            from ..telemetry import flightrec, get_registry

            flightrec.flight_event(
                "lockgraph_cycle", locks=",".join(cycle["locks"])
            )
            get_registry().counter(
                "lockgraph_cycles_total",
                "lock-order cycles (potential ABBA deadlocks) detected",
            ).inc()
        except Exception:
            pass
        sys.stderr.write(
            "lockgraph: CYCLE detected: " + " -> ".join(cycle["locks"]) + "\n"
        )

    def _emit_long_hold(self, lock_id: int, seconds: float) -> None:
        entry = {
            "lock": self.name_of(lock_id),
            "seconds": seconds,
            "thread": _thread_name(),
            "stack": traceback.format_stack(sys._getframe(2)),
        }
        with self._mu:
            if len(self.long_holds) < 100:
                self.long_holds.append(entry)
        try:
            from ..telemetry import flightrec, get_registry

            flightrec.flight_event(
                "lockgraph_long_hold", lock=entry["lock"], seconds=round(seconds, 3)
            )
            get_registry().counter(
                "lockgraph_long_holds_total",
                "lock holds exceeding MOOLIB_LOCKGRAPH_HOLD_S",
            ).inc()
        except Exception:
            pass

    # -- public views ----------------------------------------------------
    def edges(self) -> List[Tuple[str, str, int]]:
        with self._mu:
            return [
                (self.name_of(a), self.name_of(b), info["count"])
                for (a, b), info in sorted(self._edges.items())
            ]

    def cycles(self) -> List[Dict[str, Any]]:
        with self._mu:
            return list(self._cycles)

    def clear(self) -> None:
        with self._mu:
            self._edges.clear()
            self._cycles.clear()
            self._cycle_keys.clear()
            self.long_holds = []

    def report(self) -> str:
        with self._mu:
            n_locks = len(self._names)
            n_edges = len(self._edges)
            cycles = list(self._cycles)
            holds = list(self.long_holds)
        parts = [
            f"lockgraph: locks={n_locks} edges={n_edges} "
            f"cycles={len(cycles)} long_holds={len(holds)}\n"
        ]
        for c in cycles:
            parts.append("lockgraph CYCLE: " + " -> ".join(c["locks"]) + "\n")
            for e in c["edges"]:
                parts.append(
                    f"  edge {e['from']} -> {e['to']} "
                    f"(first seen on thread {e['thread']!r}):\n"
                )
                parts.extend("    " + line for s in e["stack"] for line in s.splitlines(True))
        for h in holds[:10]:
            parts.append(
                f"lockgraph long hold: {h['lock']} held {h['seconds']:.3f}s "
                f"by thread {h['thread']!r}\n"
            )
        return "".join(parts)

    def assert_acyclic(self) -> None:
        """Raise with the full two-stack report when any acquisition-order
        cycle was observed (the soak teardown gate)."""
        if self.cycles():
            raise RuntimeError("lock acquisition graph has cycles:\n" + self.report())


_DEFAULT_GRAPH = LockGraph()


def default_graph() -> LockGraph:
    return _DEFAULT_GRAPH


class InstrumentedLock:
    """Drop-in ``threading.Lock`` feeding a :class:`LockGraph`."""

    def __init__(self, graph: Optional[LockGraph] = None, name: Optional[str] = None):
        self._inner = _REAL_LOCK()
        self._graph = graph or _DEFAULT_GRAPH
        self._graph.register(id(self), name or _creation_site())

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._graph.on_acquired(id(self))
        return ok

    def release(self) -> None:
        self._graph.on_released(id(self))
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def _at_fork_reinit(self) -> None:
        # stdlib callers (concurrent.futures, logging) re-init module locks
        # in the forked child via os.register_at_fork.
        self._inner._at_fork_reinit()

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<InstrumentedLock {self._graph.name_of(id(self))} {self._inner!r}>"


class InstrumentedRLock:
    """Drop-in ``threading.RLock``: only the outermost acquire/release is an
    ordering event, and the ``Condition`` save/restore protocol keeps
    ``cond.wait()`` from fabricating hold edges while parked."""

    def __init__(self, graph: Optional[LockGraph] = None, name: Optional[str] = None):
        self._inner = _REAL_RLOCK()
        self._graph = graph or _DEFAULT_GRAPH
        self._depth = 0
        self._graph.register(id(self), name or _creation_site())

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._depth += 1  # safe: we hold the lock
            if self._depth == 1:
                self._graph.on_acquired(id(self))
        return ok

    def release(self) -> None:
        depth_was = self._depth
        self._depth -= 1
        if depth_was == 1:
            self._graph.on_released(id(self))
        try:
            self._inner.release()
        except RuntimeError:
            self._depth = depth_was  # not owned: undo, propagate
            raise

    def _at_fork_reinit(self) -> None:
        self._inner._at_fork_reinit()
        self._depth = 0

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()

    # Condition protocol: wait() RELEASES the lock via _release_save and
    # re-takes it via _acquire_restore — mirror that in the graph.
    def _release_save(self):
        depth = self._depth
        self._depth = 0
        self._graph.on_released(id(self))
        return (self._inner._release_save(), depth)

    def _acquire_restore(self, state) -> None:
        inner_state, depth = state
        self._inner._acquire_restore(inner_state)
        self._depth = depth
        self._graph.on_acquired(id(self))

    def _is_owned(self) -> bool:
        return self._inner._is_owned()

    def __repr__(self) -> str:
        return f"<InstrumentedRLock {self._graph.name_of(id(self))} {self._inner!r}>"


# ---------------------------------------------------------------------------
# process-wide opt-in
# ---------------------------------------------------------------------------

_installed = False
_teardown_registered = False


def installed() -> bool:
    return _installed


def install() -> None:
    """Replace ``threading.Lock``/``RLock`` with instrumented shims feeding
    the default graph.  Must run before the instrumented modules create
    their locks — ``moolib_tpu_torch/__init__`` calls :func:`install_from_env`
    first thing, so ``MOOLIB_LOCKGRAPH=1 python ...`` covers every lock in
    the package (and everything else created after import)."""
    global _installed, _teardown_registered
    if _installed:
        return
    threading.Lock = InstrumentedLock  # type: ignore[misc]
    threading.RLock = InstrumentedRLock  # type: ignore[misc]
    _installed = True
    if not _teardown_registered:
        # Registered at install time (= very early), so with atexit's LIFO
        # order this runs AFTER the app's own handlers: the strict gate
        # cannot cut their cleanup short.
        atexit.register(_teardown)
        _teardown_registered = True


def uninstall() -> None:
    """Restore the real lock factories (tests).  Already-created
    instrumented locks keep working — they wrap real primitives."""
    global _installed
    threading.Lock = _REAL_LOCK  # type: ignore[misc]
    threading.RLock = _REAL_RLOCK  # type: ignore[misc]
    _installed = False


def install_from_env() -> bool:
    """Opt-in seam: a strict no-op unless ``MOOLIB_LOCKGRAPH`` is set to a
    non-empty, non-``0`` value."""
    if os.environ.get("MOOLIB_LOCKGRAPH", "") not in ("", "0"):
        install()
        return True
    return False


def _teardown() -> None:
    if not _installed:
        return
    g = _DEFAULT_GRAPH
    cycles = g.cycles()
    sys.stderr.write(g.report())
    try:
        sys.stderr.flush()
    except OSError:
        pass
    if cycles and os.environ.get("MOOLIB_LOCKGRAPH_STRICT", "1") not in ("", "0"):
        # The acyclic-at-teardown assert.  os._exit: every later-registered
        # atexit handler (the app's own) has already run by LIFO order.
        os._exit(86)


def diagnostics_tail() -> str:
    """The lockgraph section of ``dump_diagnostics`` output: empty when the
    shim is not installed and nothing was ever instrumented."""
    g = _DEFAULT_GRAPH
    if not _installed and not g.edges() and not g.cycles():
        return ""
    return "--- lockgraph ---\n" + g.report()
