"""Port of ``tests/test_lockgraph.py`` to ``moolib_tpu_torch``, plus a
four-peer port cohort (tree and ring) under ``MOOLIB_LOCKGRAPH=1``.

Lock-order race detection: a synthetic two-thread ABBA is reported as a
cycle with both acquisition stacks, a clean run's teardown assert passes,
re-entrant RLocks and ``Condition.wait`` don't fabricate edges, and long
holds are recorded with their release stacks.

These tests run against private :class:`LockGraph` instances (explicit
``graph=`` on the shims) so they never touch the process-wide default graph
or the ``threading.Lock`` patch — the monkeypatch path is covered once, in
a subprocess, where opt-in semantics and the strict teardown exit code can
be observed without instrumenting the test runner itself.
"""

import subprocess
import sys
import threading
import time

import pytest

from moolib_tpu_torch.testing.lockgraph import (
    InstrumentedLock,
    InstrumentedRLock,
    LockGraph,
)


def run_two_threads(fn_a, fn_b):
    ta = threading.Thread(target=fn_a)
    tb = threading.Thread(target=fn_b)
    # Sequential on purpose: the graph records *order*, not contention, so
    # an ABBA pair is detectable without ever constructing a real deadlock.
    ta.start(); ta.join()
    tb.start(); tb.join()


def test_abba_cycle_reported_with_both_stacks():
    g = LockGraph(hold_threshold_s=1e9)
    a = InstrumentedLock(g, name="lock-A")
    b = InstrumentedLock(g, name="lock-B")

    def thread_one():  # A then B
        with a:
            with b:
                pass

    def thread_two():  # B then A — closes the cycle
        with b:
            with a:
                pass

    run_two_threads(thread_one, thread_two)
    cycles = g.cycles()
    assert len(cycles) == 1
    (cyc,) = cycles
    assert set(cyc["locks"]) == {"lock-A", "lock-B"}
    # both edges carry the stack of the thread that first took them
    stacks = [("".join(e["stack"]), e) for e in cyc["edges"]]
    assert len(stacks) == 2
    one = [s for s, _ in stacks if "thread_one" in s]
    two = [s for s, _ in stacks if "thread_two" in s]
    assert one and two, [s[:200] for s, _ in stacks]
    report = g.report()
    assert "lock-A" in report and "lock-B" in report
    assert "thread_one" in report and "thread_two" in report
    with pytest.raises(RuntimeError, match="cycles"):
        g.assert_acyclic()


def test_consistent_order_is_acyclic():
    g = LockGraph(hold_threshold_s=1e9)
    a = InstrumentedLock(g, name="lock-A")
    b = InstrumentedLock(g, name="lock-B")

    def nested():
        with a:
            with b:
                pass

    run_two_threads(nested, nested)
    assert g.cycles() == []
    g.assert_acyclic()  # the teardown gate on a clean run
    # the edge exists exactly once, with a hit count of 2
    edges = [(x, y, n) for x, y, n in g.edges()]
    assert edges == [("lock-A", "lock-B", 2)]


def test_three_lock_cycle():
    g = LockGraph(hold_threshold_s=1e9)
    locks = [InstrumentedLock(g, name=f"L{i}") for i in range(3)]

    def take(i, j):
        with locks[i]:
            with locks[j]:
                pass

    for i in range(3):  # L0→L1, L1→L2, L2→L0
        take(i, (i + 1) % 3)
    assert len(g.cycles()) == 1
    assert set(g.cycles()[0]["locks"]) == {"L0", "L1", "L2"}


def test_rlock_reentrancy_is_not_an_edge():
    g = LockGraph(hold_threshold_s=1e9)
    r = InstrumentedRLock(g, name="R")
    other = InstrumentedLock(g, name="other")
    with r:
        with r:  # re-entrant: no self-edge
            with other:
                pass
    assert g.cycles() == []
    assert [(x, y) for x, y, _ in g.edges()] == [("R", "other")]


def test_condition_wait_releases_hold():
    """``cond.wait()`` releases the underlying lock; a lock taken by
    another thread while we are parked must NOT get a wait-holder edge."""
    g = LockGraph(hold_threshold_s=1e9)
    cond = threading.Condition(InstrumentedRLock(g, name="cond-lock"))
    other = InstrumentedLock(g, name="other")
    parked = threading.Event()

    def waiter():
        with cond:
            parked.set()
            cond.wait(timeout=5)

    def worker():
        parked.wait(timeout=5)
        with other:
            time.sleep(0.02)  # overlap the parked waiter
        with cond:
            cond.notify_all()

    tw = threading.Thread(target=waiter)
    tk = threading.Thread(target=worker)
    tw.start(); tk.start(); tw.join(); tk.join()
    # no edge cond-lock -> other: the waiter did not hold it while parked
    assert ("cond-lock", "other") not in [(x, y) for x, y, _ in g.edges()]
    assert g.cycles() == []


def test_long_hold_recorded():
    g = LockGraph(hold_threshold_s=0.02)
    lk = InstrumentedLock(g, name="slow")

    def hold():
        with lk:
            time.sleep(0.05)

    t = threading.Thread(target=hold, name="holder")
    t.start(); t.join()
    assert len(g.long_holds) == 1
    h = g.long_holds[0]
    assert h["lock"] == "slow" and h["seconds"] >= 0.02
    assert h["thread"] == "holder"
    assert "hold" in "".join(h["stack"])
    assert "long hold" in g.report()


def test_trylock_failure_records_nothing():
    g = LockGraph(hold_threshold_s=1e9)
    a = InstrumentedLock(g, name="A")
    b = InstrumentedLock(g, name="B")
    with a:
        assert a._inner.locked()
        got = b.acquire(blocking=False)
        assert got
        b.release()
    done = []

    def contender():
        done.append(a.acquire(blocking=False))

    with a:
        t = threading.Thread(target=contender)
        t.start(); t.join()
    assert done == [False]  # failed try-acquire: no hold, no edge, no crash
    assert ("A", "A") not in [(x, y) for x, y, _ in g.edges()]


def test_id_reuse_purges_stale_edges():
    """Short-lived locks (Future/Event churn) die and their id() is reused
    by new locks; the dead lock's edges must not alias the new occupants
    into a false cycle.  Driven at the graph API level with hand-picked
    ids — exactly what id() reuse produces."""
    g = LockGraph(hold_threshold_s=1e9)
    g.register(1, "A")
    g.register(2, "B")
    g.on_acquired(1); g.on_acquired(2)  # edge A->B
    g.on_released(2); g.on_released(1)
    # both die; fresh locks reuse the ids with roles swapped
    g.register(2, "C")
    g.register(1, "D")
    g.on_acquired(2); g.on_acquired(1)  # edge C->D: NOT a cycle with A->B
    g.on_released(1); g.on_released(2)
    assert g.cycles() == []
    g.assert_acyclic()


_SUBPROC = r"""
import os, sys, threading
import moolib_tpu_torch
from moolib_tpu_torch.testing import lockgraph
assert lockgraph.installed() == (os.environ.get("MOOLIB_LOCKGRAPH") == "1")
if not lockgraph.installed():
    assert threading.Lock is not lockgraph.InstrumentedLock
    sys.exit(0)
assert threading.Lock is lockgraph.InstrumentedLock
a = threading.Lock()
b = threading.Lock()
def one():
    with a:
        with b: pass
def two():
    with b:
        with a: pass
t = threading.Thread(target=one); t.start(); t.join()
t = threading.Thread(target=two); t.start(); t.join()
print("cycles:", len(lockgraph.default_graph().cycles()))
"""


def test_installed_process_fails_strict_teardown():
    """MOOLIB_LOCKGRAPH=1 + an ABBA pair: report at exit and exit code 86
    (the soak gate).  MOOLIB_LOCKGRAPH_STRICT=0 downgrades to report-only."""
    out = subprocess.run(
        [sys.executable, "-c", _SUBPROC],
        env={**__import__("os").environ, "MOOLIB_LOCKGRAPH": "1",
             "JAX_PLATFORMS": "cpu"},
        capture_output=True, text=True,
    )
    assert out.returncode == 86, out.stderr[-2000:]
    assert "cycles: 1" in out.stdout
    assert "CYCLE" in out.stderr

    lax = subprocess.run(
        [sys.executable, "-c", _SUBPROC],
        env={**__import__("os").environ, "MOOLIB_LOCKGRAPH": "1",
             "MOOLIB_LOCKGRAPH_STRICT": "0", "JAX_PLATFORMS": "cpu"},
        capture_output=True, text=True,
    )
    assert lax.returncode == 0, lax.stderr[-2000:]
    assert "CYCLE" in lax.stderr


def test_env_gate_defaults_off():
    env = {**__import__("os").environ, "JAX_PLATFORMS": "cpu"}
    env.pop("MOOLIB_LOCKGRAPH", None)
    out = subprocess.run(
        [sys.executable, "-c", _SUBPROC], env=env,
        capture_output=True, text=True,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "lockgraph" not in out.stderr  # no teardown report when not opted in


def test_diagnostics_tail_empty_when_idle():
    from moolib_tpu_torch.testing import lockgraph

    if not lockgraph.installed() and not lockgraph.default_graph().edges():
        assert lockgraph.diagnostics_tail() == ""


_COHORT = r"""
import socket, sys, threading, time
import numpy as np
import torch
import moolib_tpu_torch
from moolib_tpu_torch import Broker, Group, Rpc
from moolib_tpu_torch.testing import lockgraph
assert lockgraph.installed() and threading.Lock is lockgraph.InstrumentedLock
s = socket.socket(); s.bind(("127.0.0.1", 0)); addr = "127.0.0.1:%d" % s.getsockname()[1]; s.close()
broker = Broker(); broker.set_name("broker"); broker.listen(addr)
peers = []
for i in range(4):
    rpc = Rpc(); rpc.set_name("peer%d" % i); rpc.listen("127.0.0.1:0"); rpc.connect(addr)
    g = Group(rpc, "lg"); g.set_timeout(20); peers.append((rpc, g))
groups = [g for _, g in peers]
def pump(until):
    deadline = time.time() + 60
    while time.time() < deadline and not until():
        broker.update()
        for g in groups:
            g.update()
        time.sleep(0.005)
    assert until()
pump(lambda: all(g.active() and len(g.members()) == 4 for g in groups))
for r in range(3):
    for kw in (dict(bucketed=False, chunked=False), dict(bucketed=True), dict(chunked=True),
               dict(chunked=True, wire="q8")):
        vals = [{"w": torch.full((5000,), float(i + r))} for i in range(4)]
        futs = [g.all_reduce("x%d%s" % (r, sorted(kw.items())), v, **kw)
                for g, v in zip(groups, vals)]
        pump(lambda: all(f.done() for f in futs))
        for f in futs:
            assert abs(float(np.asarray(f.result(0)["w"])[0]) - (6 + 4 * r)) < 0.5
for rpc, _ in peers:
    rpc.close()
broker.close()
print("cycles:", len(lockgraph.default_graph().cycles()))
"""


def test_port_cohort_has_no_lock_cycle():
    """A four-peer port cohort (broker, tree, flat buckets, ring, q8 wire)
    under MOOLIB_LOCKGRAPH=1: every lock the port creates is instrumented
    (the install runs before any submodule), and the run reports no
    acquisition-order cycle — the strict teardown would exit 86."""
    out = subprocess.run(
        [sys.executable, "-c", _COHORT],
        env={**__import__("os").environ, "MOOLIB_LOCKGRAPH": "1",
             "JAX_PLATFORMS": "cpu"},
        capture_output=True, text=True, timeout=240,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    assert "cycles: 0" in out.stdout
    assert "CYCLE" not in out.stderr
