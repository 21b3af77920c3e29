"""Port of ``tests/test_group.py`` to ``moolib_tpu_torch``: the same
contracts held on the port's Broker and Group.

Broker/Group/AllReduce tests — the reference's multi-node-without-a-cluster
pattern (test/test_group.py, test/test_reduce.py): N real peers + a broker in
ONE process over loopback, driven by explicit update() pumping."""

import time

import numpy as np
import pytest

from moolib_tpu_torch import Broker, Group, Rpc, RpcError


def make_cohort(free_port, n, group_name="g", timeout=5.0):
    addr = f"127.0.0.1:{free_port}"
    broker = Broker()
    broker.set_name("broker")
    broker.set_timeout(timeout)
    broker.listen(addr)
    peers = []
    for i in range(n):
        rpc = Rpc()
        rpc.set_name(f"peer{i}")
        rpc.set_timeout(10)
        rpc.listen("127.0.0.1:0")
        rpc.connect(addr)
        g = Group(rpc, group_name)
        g.set_timeout(timeout)
        peers.append((rpc, g))
    return broker, peers


def pump(broker, groups, seconds, until=None):
    deadline = time.time() + seconds
    while time.time() < deadline:
        broker.update()
        for g in groups:
            g.update()
        if until is not None and until():
            return True
        time.sleep(0.02)
    return until() if until is not None else None


def close_all(broker, peers):
    for rpc, _ in peers:
        rpc.close()
    broker.close()


def test_group_membership(free_port):
    broker, peers = make_cohort(free_port, 4)
    try:
        groups = [g for _, g in peers]
        ok = pump(
            broker,
            groups,
            15,
            until=lambda: all(len(g.members()) == 4 and g.active() for g in groups),
        )
        assert ok, f"membership never converged: {[g.members() for g in groups]}"
        ms = groups[0].members()
        assert ms == sorted(ms)
        assert all(g.members() == ms for g in groups)
        assert all(g.sync_id() == groups[0].sync_id() for g in groups)
    finally:
        close_all(broker, peers)


def test_allreduce_sum_scalar_and_tree(free_port):
    broker, peers = make_cohort(free_port, 5)
    try:
        groups = [g for _, g in peers]
        assert pump(broker, groups, 15, until=lambda: all(g.active() for g in groups))
        futures = [g.all_reduce("x", i + 1) for i, g in enumerate(groups)]
        pump(broker, groups, 5, until=lambda: all(f.done() for f in futures))
        results = [f.result(5) for f in futures]
        assert results == [15] * 5  # 1+2+3+4+5
    finally:
        close_all(broker, peers)


def test_allreduce_arrays_and_ops(free_port):
    broker, peers = make_cohort(free_port, 4)
    try:
        groups = [g for _, g in peers]
        assert pump(broker, groups, 15, until=lambda: all(g.active() for g in groups))
        # sum of pytrees of arrays
        futs = [
            g.all_reduce("grads", {"w": np.full((2, 3), float(i)), "b": np.ones(2)})
            for i, g in enumerate(groups)
        ]
        pump(broker, groups, 5, until=lambda: all(f.done() for f in futs))
        for f in futs:
            out = f.result(5)
            np.testing.assert_allclose(out["w"], np.full((2, 3), 6.0))
            np.testing.assert_allclose(out["b"], 4 * np.ones(2))
        # max op
        futs = [g.all_reduce("m", float(i), op="max") for i, g in enumerate(groups)]
        pump(broker, groups, 5, until=lambda: all(f.done() for f in futs))
        assert all(f.result(5) == 3.0 for f in futs)
    finally:
        close_all(broker, peers)


def test_allreduce_repeated(free_port):
    broker, peers = make_cohort(free_port, 3)
    try:
        groups = [g for _, g in peers]
        assert pump(broker, groups, 15, until=lambda: all(g.active() for g in groups))
        for round_i in range(5):
            futs = [g.all_reduce("it", i + round_i) for i, g in enumerate(groups)]
            pump(broker, groups, 5, until=lambda: all(f.done() for f in futs))
            expected = sum(i + round_i for i in range(3))
            assert all(f.result(5) == expected for f in futs)
    finally:
        close_all(broker, peers)


def test_churn_join_and_leave(free_port):
    broker, peers = make_cohort(free_port, 3, timeout=2.0)
    try:
        groups = [g for _, g in peers]
        assert pump(broker, groups, 15, until=lambda: all(g.active() for g in groups))
        first_sync = groups[0].sync_id()

        # A peer leaves (stops pinging): broker evicts it, epoch bumps.
        gone_rpc, _ = peers.pop()
        groups.pop()
        gone_rpc.close()
        ok = pump(
            broker,
            groups,
            20,
            until=lambda: all(
                len(g.members()) == 2 and g.sync_id() != first_sync for g in groups
            ),
        )
        assert ok, f"eviction never happened: {[g.members() for g in groups]}"

        # Reduction still works with the survivors.
        futs = [g.all_reduce("after", 10 * (i + 1)) for i, g in enumerate(groups)]
        pump(broker, groups, 5, until=lambda: all(f.done() for f in futs))
        assert all(f.result(5) == 30 for f in futs)

        # A new peer joins mid-training.
        addr = f"127.0.0.1:{free_port}"
        rpc = Rpc()
        rpc.set_name("latecomer")
        rpc.set_timeout(10)
        rpc.listen("127.0.0.1:0")
        rpc.connect(addr)
        g_new = Group(rpc, "g")
        g_new.set_timeout(2.0)
        peers.append((rpc, g_new))
        groups.append(g_new)
        ok = pump(
            broker,
            groups,
            20,
            until=lambda: all(len(g.members()) == 3 and g.active() for g in groups),
        )
        assert ok, f"join never converged: {[g.members() for g in groups]}"
        futs = [g.all_reduce("with_new", 1) for g in groups]
        pump(broker, groups, 5, until=lambda: all(f.done() for f in futs))
        assert all(f.result(5) == 3 for f in futs)
    finally:
        close_all(broker, peers)


def test_inflight_cancelled_on_group_change(free_port):
    broker, peers = make_cohort(free_port, 3, timeout=2.0)
    try:
        groups = [g for _, g in peers]
        assert pump(broker, groups, 15, until=lambda: all(g.active() for g in groups))
        # Only 2 of 3 members contribute; then a member dies -> epoch change
        # must cancel the stuck reduction with an error.
        f0 = groups[0].all_reduce("stuck", 1.0)
        f1 = groups[1].all_reduce("stuck", 2.0)
        victim_rpc, _ = peers.pop()
        groups_alive = groups[:2]
        groups.pop()
        victim_rpc.close()
        pump(broker, groups_alive, 20, until=lambda: f0.done() and f1.done())
        for f in (f0, f1):
            assert f.done()
            with pytest.raises(RpcError):
                f.result(1)
    finally:
        close_all(broker, peers)


def test_broker_restart_stateless(free_port):
    """The broker is stateless-restartable (reference BrokerService design,
    src/broker.h:99-237): kill it, start a fresh one on the same address,
    and the cohort re-forms with a NEWER epoch and can reduce again."""
    broker, peers = make_cohort(free_port, 3)
    groups = [g for _, g in peers]
    broker2 = None
    try:
        assert pump(broker, groups, 30, until=lambda: all(len(g.members()) == 3 for g in groups))
        old_sync = groups[0].sync_id()
        futs = [g.all_reduce("before", i) for i, g in enumerate(groups)]
        assert pump(broker, groups, 10, until=lambda: all(f.done() for f in futs))
        assert all(f.result(0) == 3 for f in futs)

        broker.close()
        broker2 = Broker()
        broker2.set_name("broker")
        broker2.set_timeout(5.0)
        broker2.listen(f"127.0.0.1:{free_port}")
        # Peers reconnect (explicit connect), ping the new broker, and get a
        # fresh strictly-newer epoch with the full member list.
        assert pump(
            broker2,
            groups,
            60,
            until=lambda: all(
                len(g.members()) == 3 and g.sync_id() is not None and g.sync_id() > old_sync
                for g in groups
            ),
        ), f"cohort never re-formed: {[ (g.sync_id(), g.members()) for g in groups ]}"
        futs = [g.all_reduce("after_restart", 10 * (i + 1)) for i, g in enumerate(groups)]
        assert pump(broker2, groups, 15, until=lambda: all(f.done() for f in futs))
        assert all(f.result(0) == 60 for f in futs)
    finally:
        for rpc, _ in peers:
            rpc.close()
        if broker2 is not None:
            broker2.close()


def test_broker_process_restart(free_port):
    """The broker as a real PROCESS, SIGKILLed mid-run
    and restarted on the same address.  Clients keep pinging (redialing the
    remembered connect address), re-register with the fresh broker, and a
    strictly-newer epoch with the FULL membership forms — reductions work
    again.  The observed recovery window is printed and documented in
    docs/DESIGN.md §Broker restart."""
    import os
    import signal as _signal
    import subprocess
    import sys

    from conftest import subprocess_env

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    addr = f"127.0.0.1:{free_port}"

    def start_broker():
        return subprocess.Popen(
            [sys.executable, "-m", "moolib_tpu_torch.broker", "--address", addr],
            env=subprocess_env(root), cwd=root,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True,
        )

    def pump_groups(groups, seconds, until):
        deadline = time.time() + seconds
        while time.time() < deadline:
            for g in groups:
                g.update()
            if until():
                return True
            time.sleep(0.02)
        return until()

    proc = start_broker()
    peers = []
    proc2 = None
    try:
        for i in range(3):
            rpc = Rpc()
            rpc.set_name(f"peer{i}")
            rpc.set_timeout(10)
            rpc.listen("127.0.0.1:0")
            rpc.connect(addr)
            g = Group(rpc, "g")
            g.set_timeout(5.0)
            peers.append((rpc, g))
        groups = [g for _, g in peers]
        assert pump_groups(
            groups, 60,
            until=lambda: all(len(g.members()) == 3 and g.active() for g in groups),
        ), f"cohort never formed: {[g.members() for g in groups]}"
        old_sync = groups[0].sync_id()

        os.killpg(proc.pid, _signal.SIGKILL)
        proc.wait(timeout=30)
        t_restart = time.monotonic()
        proc2 = start_broker()
        recovered = pump_groups(
            groups, 90,
            until=lambda: all(
                len(g.members()) == 3
                and g.sync_id() is not None
                and g.sync_id() > old_sync
                for g in groups
            ),
        )
        window = time.monotonic() - t_restart
        assert recovered, (
            f"cohort never re-formed after broker process restart: "
            f"{[(g.sync_id(), g.members()) for g in groups]}"
        )
        print(f"broker process restart: recovery window {window:.1f}s", flush=True)
        assert window < 60, f"recovery took {window:.1f}s"

        futs = [g.all_reduce("after_restart", i + 1) for i, g in enumerate(groups)]
        assert pump_groups(groups, 20, until=lambda: all(f.done() for f in futs))
        assert all(f.result(0) == 6 for f in futs)
    finally:
        for rpc, _ in peers:
            rpc.close()
        for p in (proc, proc2):
            if p is not None and p.poll() is None:
                os.killpg(p.pid, _signal.SIGKILL)
                p.wait()


def test_single_member_group(free_port):
    broker, peers = make_cohort(free_port, 1)
    try:
        groups = [g for _, g in peers]
        assert pump(broker, groups, 15, until=lambda: groups[0].active())
        f = groups[0].all_reduce("solo", 42)
        assert f.result(5) == 42
    finally:
        close_all(broker, peers)


def test_future_epoch_contribution_parked():
    """Epoch pushes arrive with skew: a fast peer's first op under the NEW
    epoch can reach a peer still on the OLD one.  Dropping that frame wedges
    the sender's op (and the cohort's election) until the timeout sweep —
    it must be parked and fold once the local push lands."""
    rpc = Rpc()
    rpc.set_name("peer0")
    g = Group(rpc, "g")
    g.set_timeout(5.0)
    try:
        g._on_update(1, ["peer0", "peer1"])
        # peer1's contribution for epoch 2, which we haven't learned yet.
        g._on_reduce((2, "op", 0), 5)
        assert (2, "op", 0) in g._parked
        # A genuinely dead epoch still drops.
        g._on_reduce((0, "op", 0), 99)
        assert (0, "op", 0) not in g._parked
        # Our push lands: the raced-ahead frame survives into its epoch...
        g._on_update(2, ["peer0", "peer1"])
        assert (2, "op", 0) in g._parked
        # ...and folds into our own round: peer0 is root, so the parked
        # contribution completes the reduce with no timeout involved.
        fut = g.all_reduce("op", 1)
        assert fut.result(5) == 6
    finally:
        rpc.close()


def test_stale_parked_frames_swept():
    """Parked frames for an epoch that never gets adopted (e.g. this peer
    was evicted from it) age out on the op-timeout clock."""
    rpc = Rpc()
    rpc.set_name("peer0")
    g = Group(rpc, "g")
    g.set_timeout(5.0)
    try:
        g._on_update(1, ["peer0", "peer1"])
        g._on_reduce((7, "op", 0), 1)
        assert (7, "op", 0) in g._parked
        g._park_t[(7, "op", 0)] -= 10.0  # age past the 5 s timeout
        g._last_ping = time.monotonic()  # keep update() off the (absent) broker
        g.update()
        assert (7, "op", 0) not in g._parked
        assert (7, "op", 0) not in g._park_t
    finally:
        rpc.close()


def test_epoch_storm(free_port):
    """Rapid join/leave bursts.  Invariants: sync_id is
    strictly monotone cohort-wide, a graceful ``Group.leave`` bumps the
    epoch on the survivors in < 1 s (no ping-eviction wait — the broker
    timeout here is 30 s, so only the explicit ``__broker_leave`` can
    explain a fast bump), no allreduce left in flight across the
    transitions ever wedges, and the cohort still reduces afterward."""
    broker, peers = make_cohort(free_port, 3, timeout=30.0)
    churn_rpcs = []
    try:
        groups = [g for _, g in peers]
        assert pump(broker, groups, 15, until=lambda: all(g.active() for g in groups))
        addr = f"127.0.0.1:{free_port}"
        seen_syncs = [groups[0].sync_id()]
        inflight = []
        for cycle in range(3):
            # Reductions started now are keyed to the pre-join epoch; the
            # join/leave bumps below must cancel them, never strand them.
            inflight.extend(
                g.all_reduce(f"storm{cycle}", 1.0) for g in groups
            )
            rpc = Rpc()
            rpc.set_name(f"churn{cycle}")
            rpc.set_timeout(10)
            rpc.listen("127.0.0.1:0")
            rpc.connect(addr)
            churn_rpcs.append(rpc)
            gch = Group(rpc, "g")
            gch.set_timeout(5.0)
            all_g = groups + [gch]
            assert pump(
                broker, all_g, 20,
                until=lambda: gch.active()
                and all(len(g.members()) == 4 for g in all_g),
            ), f"cycle {cycle}: join never converged"
            seen_syncs.append(groups[0].sync_id())
            # These wait on a churner contribution that will never come;
            # the leave's epoch bump must cancel them.
            inflight.extend(
                g.all_reduce(f"stranded{cycle}", 1.0) for g in groups
            )
            # The leaver's own in-flight op: after leaving it receives no
            # more epoch pushes, so only leave() itself can cancel it.
            inflight.append(gch.all_reduce(f"churner{cycle}", 1.0))
            before = groups[0].sync_id()
            t0 = time.monotonic()
            assert gch.leave(), "broker did not ack the graceful leave"
            assert pump(
                broker, groups, 5,
                until=lambda: all(
                    g.sync_id() is not None and g.sync_id() != before
                    for g in groups
                ),
            ), f"cycle {cycle}: epoch never bumped after leave"
            bump_s = time.monotonic() - t0
            assert bump_s < 1.0, (
                f"graceful leave took {bump_s:.2f}s — fell back to eviction?"
            )
            assert not gch.active()
            seen_syncs.append(groups[0].sync_id())
        assert all(b > a for a, b in zip(seen_syncs, seen_syncs[1:])), (
            f"sync_id not strictly monotone across the storm: {seen_syncs}"
        )
        # Nothing wedged: every storm-era reduction settled one way or the
        # other (result or 'group changed' cancellation).
        assert pump(
            broker, groups, 15, until=lambda: all(f.done() for f in inflight)
        ), "a storm-era allreduce wedged (never completed nor cancelled)"
        # And the surviving cohort still reduces correctly.
        futs = [g.all_reduce("after_storm", i + 1) for i, g in enumerate(groups)]
        assert pump(broker, groups, 10, until=lambda: all(f.done() for f in futs))
        assert all(f.result(5) == 6 for f in futs)
    finally:
        for rpc in churn_rpcs:
            rpc.close()
        close_all(broker, peers)


def test_broker_concurrent_ping_update_hammer():
    """_on_ping/_on_resync run on the Rpc executor pool
    concurrently with update() on the caller thread; without the broker lock
    this raises 'dictionary changed size during iteration' and can lose the
    strictly-newer-epoch guarantee."""
    import threading

    from moolib_tpu_torch.broker import Broker

    broker = Broker.__new__(Broker)  # no Rpc: drive handlers directly
    broker._groups = {}
    broker._timeout = 0.05  # evict aggressively so update() mutates members
    broker._lock = threading.Lock()
    # HA state the ping/update paths read (a bare primary, no replication).
    broker._generation = 1
    broker._primary = True
    broker._peer_broker_addrs = []
    broker._replicate_interval = 0.5
    broker._last_replicate_tx = 0.0
    broker._last_replicate_rx = time.monotonic()
    broker._promote_grace = 3.0
    pushes = []
    broker._push_to = lambda *a: pushes.append(a)

    stop = threading.Event()
    errors = []

    def pinger(tid):
        i = 0
        try:
            while not stop.is_set():
                broker._on_ping("g", f"peer{tid}_{i % 50}", tid, None)
                i += 1
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=pinger, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    try:
        deadline = time.time() + 2.0
        last_sync = None
        while time.time() < deadline:
            broker.update()
            g = broker._groups.get("g")
            if g is not None:
                # Epoch must be monotonic under concurrency.
                if last_sync is not None:
                    assert g.sync_id >= last_sync
                last_sync = g.sync_id
    except Exception as e:  # noqa: BLE001
        errors.append(e)
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert not errors, errors


# --------------------------------------------------------------------------
# Broker high availability: replicated membership, hot-standby
# failover, partition-safe generations.


def make_ha_cohort(n, group_name="g", timeout=5.0, promote_grace=1.0,
                   replicate_interval=0.1, fail_after=1.5):
    """A primary + hot-standby broker pair with ``n`` peers that know BOTH
    broker addresses (``Group.set_brokers``)."""
    from conftest import grab_port

    addr0 = f"127.0.0.1:{grab_port()}"
    addr1 = f"127.0.0.1:{grab_port()}"
    b0 = Broker()
    b0.set_name("broker0")
    b1 = Broker(standby=True)
    b1.set_name("broker1")
    for b, addr, other in ((b0, addr0, addr1), (b1, addr1, addr0)):
        b.set_timeout(timeout)
        b.set_promote_grace(promote_grace)
        b.set_replicate_interval(replicate_interval)
        b.listen(addr)
        b.set_peer_brokers([other])
    peers = []
    for i in range(n):
        rpc = Rpc()
        rpc.set_name(f"peer{i}")
        rpc.set_timeout(10)
        rpc.listen("127.0.0.1:0")
        g = Group(rpc, group_name)
        g.set_timeout(timeout)
        g.set_broker_fail_after(fail_after)
        g.set_brokers([addr0, addr1])
        peers.append((rpc, g))
    return (b0, addr0), (b1, addr1), peers


def pump_ha(brokers, groups, seconds, until=None):
    deadline = time.time() + seconds
    while time.time() < deadline:
        for b in brokers:
            b.update()
        for g in groups:
            g.update()
        if until is not None and until():
            return True
        time.sleep(0.02)
    return until() if until is not None else None


def test_broker_failover_hot_standby():
    """Kill the primary: every peer scans the broker list, re-targets the
    promoted standby (higher generation), and the cohort reduces again —
    the tentpole invariant, measured as recovery_seconds{broker_failover}."""
    from moolib_tpu_torch import telemetry

    (b0, _), (b1, _), peers = make_ha_cohort(3)
    groups = [g for _, g in peers]
    failovers_before = (
        telemetry.get_registry()
        .counter("group_broker_failovers_total", "")
        .labels()
        .get()
    )
    try:
        assert pump_ha(
            [b0, b1], groups, 30,
            until=lambda: all(len(g.members()) == 3 and g.active() for g in groups),
        ), f"cohort never formed: {[g.members() for g in groups]}"
        assert b0.is_primary and not b1.is_primary
        old_sync = groups[0].sync_id()

        b0.close()  # primary dies; replication to the standby stops
        assert pump_ha(
            [b1], groups, 60,
            until=lambda: b1.is_primary and all(
                len(g.members()) == 3 and g.active()
                and g.sync_id() is not None and g.sync_id() > old_sync
                for g in groups
            ),
        ), (
            f"failover never converged: primary={b1.is_primary} "
            f"{[(g.sync_id(), g.members()) for g in groups]}"
        )
        # The takeover bumped the generation fence and every peer adopted it.
        assert b1.generation == 2
        assert all(g._broker_gen == 2 for g in groups)
        failovers_after = (
            telemetry.get_registry()
            .counter("group_broker_failovers_total", "")
            .labels()
            .get()
        )
        assert failovers_after > failovers_before
        futs = [g.all_reduce("after_failover", i + 1) for i, g in enumerate(groups)]
        assert pump_ha([b1], groups, 15, until=lambda: all(f.done() for f in futs))
        assert all(f.result(5) == 6 for f in futs)
        # Both transitions are in the flight recorder, as in the JAX package.
        events = telemetry.get_flight_recorder().events()
        assert any(n == "group.broker_failover" and a["generation"] == 2
                   for _, n, a in events)
        assert any(n == "group.epoch" and a["sync_id"] == groups[0].sync_id()
                   for _, n, a in events)
    finally:
        for rpc, _ in peers:
            rpc.close()
        b0.close()
        b1.close()


def test_partition_heals_single_generation():
    """Seeded FaultPlan.partition splits a 4-peer cohort
    2/2 mid-allreduce (a broker on each side).  Each side re-forms under its
    own broker; after the heal the zombie ex-primary demotes and the WHOLE
    cohort converges on one fenced generation — no duplicate leaders."""
    from moolib_tpu_torch.testing.faults import FaultPlan

    (b0, _), (b1, _), peers = make_ha_cohort(4, timeout=2.0)
    groups = [g for _, g in peers]
    plan = FaultPlan(seed=10)
    cut = plan.partition(
        [["broker0", "peer0", "peer1"], ["broker1", "peer2", "peer3"]]
    )
    try:
        assert pump_ha(
            [b0, b1], groups, 30,
            until=lambda: all(len(g.members()) == 4 and g.active() for g in groups),
        ), f"cohort never formed: {[g.members() for g in groups]}"

        # An allreduce that can never complete across the cut: the split
        # epochs must cancel it ("group changed"), not wedge it.
        stuck = [groups[0].all_reduce("stuck", 1.0), groups[3].all_reduce("stuck", 2.0)]
        with cut:
            cut.start()
            side_a, side_b = groups[:2], groups[2:]
            assert pump_ha(
                [b0, b1], groups, 60,
                until=lambda: (
                    all(g.members() == ["peer0", "peer1"] for g in side_a)
                    and all(g.members() == ["peer2", "peer3"] for g in side_b)
                    and b1.is_primary
                ),
            ), (
                f"sides never re-formed: {[g.members() for g in groups]} "
                f"primaries={b0.is_primary, b1.is_primary}"
            )
            # Transient split brain is expected mid-partition: the standby
            # promoted behind the cut while the old primary serves its side.
            assert b0.is_primary and b1.is_primary
            assert cut.dropped > 0
            for f in stuck:
                assert f.done()
                with pytest.raises(RpcError):
                    f.result(1)
            cut.heal()
            # Post-heal: replication exchange demotes the fence loser
            # (generation 1 zombie vs generation 2 standby-turned-primary),
            # its peers fail over, and ONE 4-member epoch forms.
            assert pump_ha(
                [b0, b1], groups, 60,
                until=lambda: (
                    not b0.is_primary and b1.is_primary
                    and all(
                        g.members() == ["peer0", "peer1", "peer2", "peer3"]
                        and g.active()
                        for g in groups
                    )
                    and len({g.sync_id() for g in groups}) == 1
                ),
            ), (
                f"cohort never converged after heal: "
                f"primaries={b0.is_primary, b1.is_primary} "
                f"{[(g.sync_id(), g.members()) for g in groups]}"
            )
        # Exactly one leader, one generation, everywhere.
        assert [b0.is_primary, b1.is_primary].count(True) == 1
        assert b0.generation == b1.generation == 2
        assert all(g._broker_gen == 2 for g in groups)
        futs = [g.all_reduce("after_heal", i + 1) for i, g in enumerate(groups)]
        assert pump_ha([b0, b1], groups, 15, until=lambda: all(f.done() for f in futs))
        assert all(f.result(5) == 10 for f in futs)
    finally:
        cut.uninstall()
        for rpc, _ in peers:
            rpc.close()
        b0.close()
        b1.close()


def test_split_brain_two_primaries_converge(free_port):
    """Two brokers that both believe they are primary (the post-heal zombie
    scenario, isolated): the replication exchange demotes exactly one of
    them — the (generation, name) fence picks a deterministic survivor."""
    from conftest import grab_port

    addr0 = f"127.0.0.1:{free_port}"
    addr1 = f"127.0.0.1:{grab_port()}"
    b0 = Broker()
    b0.set_name("broker0")
    b1 = Broker()
    b1.set_name("broker1")
    for b, addr, other in ((b0, addr0, addr1), (b1, addr1, addr0)):
        b.set_replicate_interval(0.05)
        b.listen(addr)
        b.set_peer_brokers([other])
    try:
        deadline = time.time() + 15
        while time.time() < deadline:
            b0.update()
            b1.update()
            if b0.is_primary != b1.is_primary:
                break
            time.sleep(0.02)
        # Equal generations: the name breaks the tie, broker1 survives.
        assert b1.is_primary and not b0.is_primary
        assert b0.generation == b1.generation
    finally:
        b0.close()
        b1.close()


def test_zombie_demotes_on_higher_generation_ping():
    """Generation fence, broker side: a peer already following a newer
    primary pings the zombie — it must stand down instantly (replicated
    deployments) or absorb the fence (legacy single broker, where demoting
    would wedge the cohort behind a broker that no longer exists)."""
    zombie = Broker()
    zombie.set_name("broker0")
    try:
        zombie._peer_broker_addrs = ["127.0.0.1:1"]  # replicated deployment
        r = zombie._on_ping("g", "peer0", 0, None, None, "member", 5)
        assert r["standby"] is True
        assert not zombie.is_primary
        assert zombie.generation == 5
    finally:
        zombie.close()

    solo = Broker()
    solo.set_name("broker0")
    try:
        r = solo._on_ping("g", "peer0", 0, None, None, "member", 5)
        assert not r.get("standby")
        assert solo.is_primary
        assert solo.generation == 5
        assert r["sync_id"] is not None
    finally:
        solo.close()


def test_stale_push_rejected():
    """Generation fence, peer side: a fenced ex-primary's epoch push is
    rejected even when its sync_id is HIGHER than ours — the fence, not the
    epoch number, decides; a higher generation is adopted as usual."""
    rpc = Rpc()
    rpc.set_name("peer0")
    g = Group(rpc, "g")
    try:
        g._on_update(5, ["peer0", "peer1"], None, 2)
        assert g.sync_id() == 5 and g._broker_gen == 2

        # Zombie push: generation 1 < 2 -> rejected despite sync_id 99.
        g._on_update(99, ["peer0"], None, 1)
        assert g.sync_id() == 5
        assert g.members() == ["peer0", "peer1"]

        # Newer generation adopted; epoch must still be strictly newer.
        g._on_update(6, ["peer0", "peer1", "peer2"], None, 3)
        assert g.sync_id() == 6 and g._broker_gen == 3

        # Legacy push without a generation passes the fence unchanged.
        g._on_update(7, ["peer0"])
        assert g.sync_id() == 7 and g._broker_gen == 3
    finally:
        rpc.close()


def test_standby_serves_discovery_from_replicated_state():
    """__broker_list answers from a standby's replicated snapshot: serving
    clients keep discovering replicas while the failover is still electing
    the next primary."""
    (b0, _), (b1, _), peers = make_ha_cohort(2)
    groups = [g for _, g in peers]
    try:
        assert pump_ha(
            [b0, b1], groups, 30,
            until=lambda: all(len(g.members()) == 2 and g.active() for g in groups),
        )
        # Let at least one replication snapshot land on the standby.
        assert pump_ha(
            [b0, b1], groups, 10,
            until=lambda: b1._groups.get("g") is not None
            and len(b1._groups["g"].active_members) == 2,
        ), "replication never reached the standby"
        listing = b1._on_list("g")
        assert listing["standby"] is True
        assert listing["members"] == ["peer0", "peer1"]
        assert listing["sync_id"] == groups[0].sync_id()
    finally:
        for rpc, _ in peers:
            rpc.close()
        b0.close()
        b1.close()


# ------------------------------------------------ torch leaves in the port
def test_own_torch_leaves():
    """_own keeps a tensor that owns its storage, clones a CPU view of
    another tensor's storage, and leaves numpy semantics as the JAX
    package has them."""
    import torch

    from moolib_tpu_torch.group import _own

    whole = torch.arange(12, dtype=torch.float32)
    view = whole[2:6]
    borrowed = np.frombuffer(np.arange(4, dtype=np.float32).tobytes(), np.float32)
    out = _own({"t": whole, "v": view, "n": borrowed, "s": 3})
    assert out["t"] is whole
    assert out["v"] is not view and torch.equal(out["v"], view)
    assert out["v"].untyped_storage().data_ptr() != whole.untyped_storage().data_ptr()
    assert out["n"] is not borrowed and out["n"].flags.writeable
    assert out["s"] == 3


def test_ops_min_max_with_torch_leaves():
    """min/max with a torch leaf on either side stay in torch (like + and
    *); numpy and python leaves take the numpy/builtin path unchanged."""
    import torch

    from moolib_tpu_torch.group import _OPS

    a = torch.tensor([1.0, 5.0, -2.0])
    b = np.array([3.0, 2.0, -1.0], np.float32)
    lo, hi = _OPS["min"](a, b), _OPS["max"](b, a)
    assert isinstance(lo, torch.Tensor) and isinstance(hi, torch.Tensor)
    assert lo.tolist() == [1.0, 2.0, -2.0] and hi.tolist() == [3.0, 5.0, -1.0]
    h = torch.tensor([1.5, -3.0], dtype=torch.bfloat16)
    assert _OPS["max"](h, h * 2).dtype == torch.bfloat16
    assert isinstance(_OPS["min"](b, b * 2), np.ndarray)
    assert _OPS["min"](2, 7) == 2 and _OPS["max"](2.5, 1.0) == 2.5


def test_tree_allreduce_torch_leaves(free_port):
    """The legacy tree with torch leaves: float32 tensors come back as host
    numpy arrays (the arithmetic is the JAX package's numpy), bfloat16
    tensors (which numpy lacks) reduce in torch and come back as bfloat16;
    sum, min and max."""
    import torch

    broker, peers = make_cohort(free_port, 3)
    try:
        groups = [g for _, g in peers]
        assert pump(broker, groups, 15, until=lambda: all(g.active() for g in groups))
        vals = [{"f": torch.full((2, 3), float(i)), "h": torch.tensor([i, -i], dtype=torch.bfloat16)}
                for i in range(3)]
        for op, f_want, h_want in (("sum", 3.0, [3.0, -3.0]), ("max", 2.0, [2.0, 0.0]),
                                   ("min", 0.0, [0.0, -2.0])):
            futs = [g.all_reduce("t" + op, v, op=op, bucketed=False)
                    for g, v in zip(groups, vals)]
            pump(broker, groups, 5, until=lambda: all(f.done() for f in futs))
            for f in futs:
                out = f.result(5)
                assert isinstance(out["f"], np.ndarray)
                np.testing.assert_array_equal(out["f"], np.full((2, 3), f_want, np.float32))
                assert out["h"].dtype == torch.bfloat16 and out["h"].tolist() == h_want
    finally:
        close_all(broker, peers)
