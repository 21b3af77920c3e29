"""Warm-rejoin recovery plane on the port (the port of
``tests/test_accumulator_rejoin.py``): chunked, resumable model sync under
the port's seeded fault plane, and the zero-byte warm-rejoin fast path.

- a joiner's model sync streams as version-keyed chunks; killing the LEADER
  mid-transfer (under RPC frame drop/dup chaos) must not restart the
  transfer — the new epoch's leader resumes from the last acked chunk and
  the joiner converges to the cohort version;
- a checkpoint-fresh peer that advertises the cohort's model version is
  synced with ZERO model-sync bytes on the wire (warm rejoin);
- recovery_info() reports the completed phase chain the soak decomposes.
"""

import time

import numpy as np
import pytest
import torch

from moolib_tpu_torch import Accumulator, Broker, telemetry
from moolib_tpu_torch.testing import FaultPlan

torch.set_num_threads(1)

LR = 0.1
STATE = {"opt": "shared-state"}  # identical on every peer: resume needs
# byte-identical blobs across leader changes


def pump_all(broker, accs):
    broker.update()
    for a in accs:
        a.update()
        if a.wants_state():
            a.set_state(dict(STATE))


def apply_step(a):
    g = a.gradients()
    p = a.parameters()
    a.set_parameters({"w": p["w"] - LR * g["w"]})
    a.zero_gradients()


def wait_until(broker, accs, seconds, cond):
    deadline = time.time() + seconds
    while time.time() < deadline:
        pump_all(broker, accs)
        if cond():
            return True
        time.sleep(0.01)
    return cond()


def make_acc(name, addr, w0, chunk_bytes=None):
    a = Accumulator("m", {"w": torch.from_numpy(np.array(w0, copy=True))})
    a._rpc.set_name(name)
    a._rpc.set_timeout(10)
    a._rpc.listen("127.0.0.1:0")
    a._group.set_timeout(8.0)
    if chunk_bytes is not None:
        a.set_model_chunk_bytes(chunk_bytes)
    a.connect(addr)
    return a


def run_rounds(broker, accs, n, seconds=60):
    """Drive n applied gradient rounds on every peer (version += n)."""
    start = {id(a): a.model_version() for a in accs}

    def all_done():
        done = True
        for a in accs:
            if a.has_gradients():
                apply_step(a)
            elif (
                a.model_version() - start[id(a)] < n and a.wants_gradients()
            ):
                a.reduce_gradients(1, {"w": a.parameters()["w"].clone()})
            if a.model_version() - start[id(a)] < n:
                done = False
        return done

    assert wait_until(broker, accs, seconds, all_done), (
        f"rounds stalled at versions {[a.model_version() for a in accs]}"
    )


def _counter(name):
    return telemetry.get_registry().counter_values().get(name, 0.0)


def test_leader_death_mid_transfer_resumes(free_port):
    """Kill the leader while a joiner's chunked model sync is in flight,
    under seeded frame drop/dup: the joiner must converge to the cohort
    version via chunk RESUME (not a from-scratch retransfer).

    Under heavy load this test and the JAX package's own
    ``tests/test_accumulator_rejoin.py`` have each failed with the same
    message ("joiner never converged ... in_transfer=True"): the failure
    belongs to the shared design of the resumable transfer, not to the
    port.  Eight copies of each at once on an 8-core CPU all passed; in a
    full run of the tier-1 suite on 6 workers this one failed once in two.

    Measured against the wait (8 loaded copies at once, the convergence
    wait stretched to 400 s and the joiner's chunk count traced): seven
    converged in 5.0-11.8 s at 172-406 chunks/s of the 2,049; the eighth
    stalled at 29 chunks, disconnected, for the whole 400 s.  A failure is
    a stalled resume, not a slow transfer that a longer (or
    progress-bounded) wait would see through, so the 90 s wait stays; the
    message reports the joiner's chunk count and how long it has not
    moved."""
    addr = f"127.0.0.1:{free_port}"
    broker = Broker()
    broker.set_name("broker")
    broker.set_timeout(4.0)
    broker.listen(addr)
    # ~2 MiB of parameters streamed as 1 KiB chunks -> ~2000 ack-paced
    # chunks, a seconds-long transfer: the mid-flight kill window is wide
    # enough to hit deterministically from the pump thread.
    w0 = np.arange(512 * 1024, dtype=np.float32) / 1e3
    plan = FaultPlan(3)
    resumes0 = _counter("accum_model_sync_resumes_total")
    # Default chunk size while the cohort forms (fast); the joiner's
    # transfer below is re-chunked small to widen the kill window.
    accs = [make_acc(f"p{i}", addr, w0) for i in range(3)]
    fresh = None
    try:
        assert wait_until(broker, accs, 40, lambda: all(a.connected() for a in accs))
        run_rounds(broker, accs, 3)
        version = max(a.model_version() for a in accs)
        assert version >= 3
        for a in accs:
            a.set_model_chunk_bytes(1024)
        # Chaos covers the transfer and the kill; it is lifted for the
        # convergence wait — post-kill peer DISCOVERY latency under
        # sustained frame loss is a transport property with a long tail,
        # and this test pins the resume protocol, not that tail.
        with plan.frame_faults(drop=0.03, dup=0.02):
            # A cold joiner (version 0, name sorted below every p*): its
            # sync must ride the chunk stream — under frame drop/dup chaos.
            fresh = make_acc("a_join", addr, np.zeros_like(w0), chunk_bytes=1024)
            accs.append(fresh)

            def mid_transfer():
                t = fresh._in_transfer
                if t is None:
                    return False
                got = len(t["chunks"])
                # Enough received that a resume is meaningfully partial,
                # well short of completion so the kill lands mid-stream.
                return 20 <= got < t["total"] - 200

            assert wait_until(broker, accs, 60, mid_transfer), (
                "joiner never entered a mid-transfer window "
                f"(in_transfer={fresh._in_transfer and len(fresh._in_transfer['chunks'])})"
            )
            # Kill the CURRENT leader mid-stream (it is one of p0..p2 — the
            # joiner holds version 0 and can never win the election).
            leader_name = fresh.get_leader() or accs[0].get_leader()
            victim = next(a for a in accs if a._rpc.get_name() == leader_name)
            assert victim is not fresh
            accs.remove(victim)
            victim.close()

        # Survivors re-elect; the new leader resumes the stream; the
        # joiner converges to the cohort version.
        progress = {"chunks": -1, "at": time.time()}

        def converged():
            t = fresh._in_transfer
            got = None if t is None else len(t["chunks"])
            if got != progress["chunks"]:
                progress.update(chunks=got, at=time.time())
            return fresh.connected() and fresh.model_version() == version

        assert wait_until(broker, accs, 90, converged), (
            f"joiner never converged: connected={fresh.connected()} "
            f"version={fresh.model_version()} (cohort {version}) "
            f"in_transfer={fresh._in_transfer is not None} "
            f"chunks={progress['chunks']} unchanged for "
            f"{time.time() - progress['at']:.1f} s"
        )
        np.testing.assert_allclose(
            np.asarray(fresh.parameters()["w"]),
            np.asarray(accs[0].parameters()["w"]),
            rtol=1e-6,
        )
        assert _counter("accum_model_sync_resumes_total") > resumes0, (
            "transfer was restarted from scratch, not resumed"
        )
        # The resumed transfer must not have re-shipped the whole blob.
        info = fresh.recovery_info()
        assert info["model_sync_bytes_rx"] < 2 * w0.nbytes, info
    finally:
        for a in accs:
            a.close()
        broker.close()


def test_warm_rejoin_zero_bytes(free_port):
    """A restarted peer that warm-loaded its checkpoint (same model version
    as the leader) is synced with zero model-sync bytes on the wire."""
    addr = f"127.0.0.1:{free_port}"
    broker = Broker()
    broker.set_name("broker")
    broker.set_timeout(4.0)
    broker.listen(addr)
    w0 = np.full((4096,), 2.0, np.float32)
    warm0 = _counter("accum_warm_rejoins_total")
    accs = [make_acc(f"p{i}", addr, w0) for i in range(2)]
    rejoiner = None
    try:
        assert wait_until(broker, accs, 40, lambda: all(a.connected() for a in accs))
        run_rounds(broker, accs, 3)
        version = accs[0].model_version()
        assert version >= 3

        # Simulate the warm restart: the peer restored its checkpoint
        # (identical params at the cohort version) and advertises it.
        # The name sorts below p* so it cannot win the election.
        rejoiner = make_acc("a_rejoin", addr, np.asarray(accs[0].parameters()["w"]))
        rejoiner.set_model_version(version)
        accs.append(rejoiner)
        assert wait_until(broker, accs, 40, rejoiner.connected), (
            f"warm rejoiner never synced (leader={rejoiner.get_leader()})"
        )
        info = rejoiner.recovery_info()
        assert info["warm_rejoin"] is True
        assert info["model_sync_bytes_rx"] == 0, info
        assert rejoiner.model_version() == version
        assert _counter("accum_warm_rejoins_total") > warm0
        # The rejoiner contributes normally afterwards, completing the
        # recovery chain recovery_info() decomposes.
        run_rounds(broker, accs, 1)
        info = rejoiner.recovery_info()
        assert info["complete"], info
        assert set(info["phases_s"]) >= {
            "reconnect", "re_elect", "model_sync", "first_compile",
            "first_contribution",
        }
        assert info["model_sync_bytes_rx"] == 0, info
    finally:
        for a in accs:
            a.close()
        broker.close()


def test_cold_join_syncs_in_chunks(free_port):
    """Baseline: a cold joiner's model arrives as multiple acked chunks and
    recovery_info() reports the received bytes."""
    addr = f"127.0.0.1:{free_port}"
    broker = Broker()
    broker.set_name("broker")
    broker.set_timeout(4.0)
    broker.listen(addr)
    w0 = np.arange(64 * 1024, dtype=np.float32)
    accs = [make_acc(f"p{i}", addr, w0, chunk_bytes=16384) for i in range(2)]
    joiner = None
    try:
        assert wait_until(broker, accs, 40, lambda: all(a.connected() for a in accs))
        run_rounds(broker, accs, 2)
        version = accs[0].model_version()
        joiner = make_acc("a_cold", addr, np.zeros_like(w0), chunk_bytes=16384)
        accs.append(joiner)
        assert wait_until(
            broker, accs, 60,
            lambda: joiner.connected() and joiner.model_version() == version,
        )
        info = joiner.recovery_info()
        # The blob (params + state) spans many 16 KiB chunks.
        assert info["model_sync_bytes_rx"] > w0.nbytes, info
        assert info["warm_rejoin"] is False
        np.testing.assert_allclose(
            np.asarray(joiner.parameters()["w"]),
            np.asarray(accs[0].parameters()["w"]),
            rtol=1e-6,
        )
    finally:
        for a in accs:
            a.close()
        broker.close()
