"""Port of ``tests/test_ring_allreduce.py`` to ``moolib_tpu_torch`` (the
Accumulator's ring case waits for the Accumulator), with torch CPU tensor
leaves where the port reads them through numpy.

Chunked ring allreduce (reduce-scatter + all-gather) over RPC.

Counterpart of the reference's benchmark-only chunked ring
(``test/test_multinode_allreduce.cc:16-150``), promoted here to a first-class
epoch-keyed Group op.  Uses the one-process
many-peers loopback pattern of the reference test suite (SURVEY §4).
"""

import time

import numpy as np
import pytest
import torch

from moolib_tpu_torch import Broker, Group, Rpc
from moolib_tpu_torch.rpc import RpcError
from moolib_tpu_torch.utils import nest

LEAVES = ["numpy", "torch"]


def _as(leaf, value):
    """The same payload as numpy arrays or as torch CPU tensors over them."""
    return nest.map(torch.from_numpy, value) if leaf == "torch" else value


def _make_cohort(free_port, n=4):
    """broker + n loopback peers, converged; returns (broker, peers, groups, pump)."""
    addr = f"127.0.0.1:{free_port}"
    broker = Broker()
    broker.set_name("broker")
    broker.listen(addr)
    peers = []
    for i in range(n):
        rpc = Rpc()
        rpc.set_name(f"rank{i}")
        rpc.listen("127.0.0.1:0")
        rpc.connect(addr)
        g = Group(rpc, "t")
        g.set_timeout(30)
        peers.append((rpc, g))
    groups = [g for _, g in peers]

    def pump():
        broker.update()
        for g in groups:
            g.update()

    deadline = time.time() + 30
    while not all(g.active() for g in groups) and time.time() < deadline:
        pump()
        time.sleep(0.01)
    assert all(g.active() for g in groups), "cohort never converged"
    return broker, peers, groups, pump


@pytest.fixture
def cohort(free_port):
    broker, peers, groups, pump = _make_cohort(free_port)
    try:
        yield groups, pump
    finally:
        for rpc, _ in peers:
            rpc.close()
        broker.close()


def _wait(futs, pump, timeout=30):
    deadline = time.time() + timeout
    while not all(f.done() for f in futs):
        assert time.time() < deadline, "allreduce did not complete"
        pump()
        time.sleep(0.002)


@pytest.mark.parametrize("leaf", LEAVES)
def test_ring_sum_matches_tree(cohort, leaf):
    groups, pump = cohort
    data = [np.random.randn(1000).astype(np.float32) + i for i in range(4)]
    ring = [g.all_reduce("r", _as(leaf, d), chunked=True) for g, d in zip(groups, data)]
    tree = [g.all_reduce("t", _as(leaf, d), chunked=False) for g, d in zip(groups, data)]
    _wait(ring + tree, pump)
    expect = tree[0].result(0)
    for f in ring:
        np.testing.assert_allclose(f.result(0), expect, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("leaf", LEAVES)
def test_ring_pytree_and_meta(cohort, leaf):
    groups, pump = cohort
    data = [
        {"w": np.full((3, 4), float(i + 1), np.float32), "b": np.arange(5, dtype=np.float32)}
        for i in range(4)
    ]
    futs = [
        g.all_reduce(
            "m", _as(leaf, d), chunked=True,
            meta={"n": 1, "bs": i + 1},
            meta_op=lambda a, b: {k: a[k] + b[k] for k in a},
        )
        for i, (g, d) in enumerate(zip(groups, data))
    ]
    _wait(futs, pump)
    for f in futs:
        value, meta = f.result(0)
        assert meta == {"n": 4, "bs": 10}
        np.testing.assert_allclose(value["w"], np.full((3, 4), 10.0, np.float32))
        np.testing.assert_allclose(value["b"], 4 * np.arange(5, dtype=np.float32))


def test_ring_skip_contributions(cohort):
    groups, pump = cohort
    tmpl = {"w": np.zeros((3, 4), np.float32)}
    futs = []
    for i, g in enumerate(groups):
        if i % 2 == 0:
            futs.append(g.all_reduce("s", {"w": np.full((3, 4), float(i + 1), np.float32)}, chunked=True))
        else:
            futs.append(g.all_reduce("s", None, chunked=True, template=tmpl))
    _wait(futs, pump)
    for f in futs:
        np.testing.assert_allclose(f.result(0)["w"], np.full((3, 4), 4.0, np.float32))
    # All-skip round resolves to None on every peer.
    futs = [g.all_reduce("s2", None, chunked=True, template=tmpl) for g in groups]
    _wait(futs, pump)
    assert all(f.result(0) is None for f in futs)


@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("wire", ["bfloat16", "q8"])
def test_ring_wire_compression_bit_consistent(cohort, wire, leaf):
    """Wire-compressed ring results must be bit-identical cohort-wide: every
    rank decodes the same encoded chunk bytes (the all-gather forwards wire
    bytes unchanged)."""
    groups, pump = cohort
    data = [np.random.randn(4096).astype(np.float32) for _ in range(4)]
    futs = [g.all_reduce("w" + wire, _as(leaf, d), chunked=True, wire=wire)
            for g, d in zip(groups, data)]
    _wait(futs, pump)
    r0 = futs[0].result(0)
    for f in futs[1:]:
        np.testing.assert_array_equal(f.result(0), r0)
    np.testing.assert_allclose(r0, sum(data), rtol=0.05, atol=0.5)


@pytest.mark.parametrize("leaf", LEAVES)
def test_ring_min_max_ops(cohort, leaf):
    groups, pump = cohort
    data = [np.arange(100, dtype=np.float32) + 10 * i for i in range(4)]
    mins = [g.all_reduce("mn", _as(leaf, d), chunked=True, op="min")
            for g, d in zip(groups, data)]
    maxs = [g.all_reduce("mx", _as(leaf, d), chunked=True, op="max")
            for g, d in zip(groups, data)]
    _wait(mins + maxs, pump)
    for f in mins:
        np.testing.assert_allclose(f.result(0), data[0])
    for f in maxs:
        np.testing.assert_allclose(f.result(0), data[3])


def test_ring_auto_threshold(cohort, monkeypatch):
    """ring_auto is environment-aware: payload over
    MOOLIB_RING_THRESHOLD auto-selects the ring only for a >=3-member cohort
    spanning more than one machine; same-host cohorts (memfd zero-copy —
    the tree wins wall-clock there) and small payloads keep the tree."""
    from moolib_tpu_torch.group import _Op, _RingOp

    groups, pump = cohort
    monkeypatch.setenv("MOOLIB_RING_THRESHOLD", str(1 << 12))
    big = [np.random.randn(2048).astype(np.float32) for _ in range(4)]  # 8 KiB
    small = [np.random.randn(16).astype(np.float32) for _ in range(4)]
    # This loopback cohort genuinely shares one boot id: big stays on the tree.
    futs = [g.all_reduce("auto0", d) for g, d in zip(groups, big)]
    kinds = {type(op) for g in groups for op in g._ops.values()}
    assert kinds <= {_Op}, kinds
    _wait(futs, pump)
    np.testing.assert_allclose(futs[0].result(0), sum(big), rtol=1e-4, atol=1e-4)
    # Simulate the broker having pushed distinct machines (a DCN cohort).
    for g in groups:
        g._member_hosts = {m: f"host{i}" for i, m in enumerate(g.members())}
    futs = [g.all_reduce("auto", d) for g, d in zip(groups, big)]
    kinds = {type(op) for g in groups for op in g._ops.values()}
    assert kinds <= {_RingOp}, kinds
    _wait(futs, pump)
    np.testing.assert_allclose(futs[0].result(0), sum(big), rtol=1e-4, atol=1e-4)
    futs = [g.all_reduce("auto", d) for g, d in zip(groups, small)]
    kinds = {type(op) for g in groups for op in g._ops.values()}
    assert kinds <= {_Op}, kinds
    _wait(futs, pump)
    np.testing.assert_allclose(futs[0].result(0), sum(small), rtol=1e-5, atol=1e-6)
    # Decision-only checks on the remaining inputs: a 2-member cohort moves
    # the same bytes per peer either way — tree; unknown hosts stay ring-
    # eligible (missing info must not silently disable the DCN optimization).
    g0 = groups[0]
    assert g0.ring_auto(1 << 20)
    with g0._lock:
        saved_m, saved_h = g0._members, g0._member_hosts
        g0._members = saved_m[:2]
        g0._member_hosts = {m: f"host{i}" for i, m in enumerate(saved_m[:2])}
    try:
        assert not g0.ring_auto(1 << 20)
    finally:
        with g0._lock:
            g0._members, g0._member_hosts = saved_m, saved_h


def test_member_hosts_pushed(cohort):
    """The broker's epoch push carries each member's machine identity, so
    every member shares one consistent host map (ring_auto's wire-protocol
    requirement)."""
    from moolib_tpu_torch.rpc.core import _boot_id

    groups, _ = cohort
    for g in groups:
        hosts = g.member_hosts()
        assert set(hosts) == set(g.members())
        assert set(hosts.values()) == {_boot_id()}


def test_ring_wire_load_invariant(cohort):
    """Pin the ring's falsifiable advantage: for an
    n-peer cohort and payload P, the busiest ring peer transmits
    ~2(n-1)/n * P while the tree's busiest peer transmits ~2P (the root
    shares the result with both children; inner nodes forward up + down).
    Counted from transport_stats() wire bytes — TCP-only listeners in this
    fixture, so the counters are the real wire truth."""
    groups, pump = cohort
    n = len(groups)
    elems = 131072  # 512 KiB of f32
    payload = elems * 4
    data = [np.random.randn(elems).astype(np.float32) for _ in range(n)]

    def max_tx(name, chunked):
        rpcs = [g._rpc for g in groups]
        before = [r.transport_stats()["tx_bytes"] for r in rpcs]
        futs = [g.all_reduce(name, d, chunked=chunked) for g, d in zip(groups, data)]
        _wait(futs, pump)
        for f in futs:
            f.result(0)
        after = [r.transport_stats()["tx_bytes"] for r in rpcs]
        return max(a - b for a, b in zip(after, before))

    # Warmup settles greetings/codec negotiation out of the counters.
    _wait([g.all_reduce("wl_w", d) for g, d in zip(groups, data)], pump)
    tree_max = max_tx("wl_t", False)
    ring_max = max_tx("wl_r", True)
    slack = 64 * 1024  # headers, chunk meta, broker pings during the op
    assert ring_max <= 2 * (n - 1) / n * payload + slack, (ring_max, payload)
    assert tree_max >= 1.8 * payload, (tree_max, payload)
    assert tree_max <= 2 * payload + slack, (tree_max, payload)
    # The headline inequality: the ring's busiest peer carries less wire.
    assert ring_max < tree_max, (ring_max, tree_max)


def test_ring_cancelled_on_membership_change(cohort, free_port):
    """Epoch change mid-ring cancels the op with "group changed" — the
    elasticity contract (reference cancel-on-change, src/group.h:453-460)."""
    groups, pump = cohort
    g0 = groups[0]
    # Start a ring op on ONE peer only: it sends its first chunk and parks
    # waiting for the others, which never contribute.
    fut = g0.all_reduce("c", np.ones(64, np.float32), chunked=True)
    pump()
    assert not fut.done()
    # A new peer joining bumps the membership epoch.
    rpc = Rpc()
    rpc.set_name("latecomer")
    rpc.listen("127.0.0.1:0")
    rpc.connect(f"127.0.0.1:{free_port}")
    g = Group(rpc, "t")
    try:
        deadline = time.time() + 30
        while not fut.done() and time.time() < deadline:
            pump()
            g.update()
            time.sleep(0.005)
        with pytest.raises(RpcError, match="group changed"):
            fut.result(0)
    finally:
        rpc.close()


def test_ring_rejects_bad_combinations(cohort):
    groups, _ = cohort
    g = groups[0]
    with pytest.raises(RpcError, match="skip"):
        g.all_reduce("b1", None, chunked=True, op="min", template=np.zeros(4, np.float32))
    with pytest.raises(RpcError, match="meta_op"):
        g.all_reduce("b2", np.zeros(4, np.float32), chunked=True, meta={"n": 1})
    with pytest.raises(RpcError, match="finalize"):
        g.all_reduce("b3", np.zeros(4, np.float32), chunked=True, finalize=lambda x: x)
    f = g.all_reduce("b4", None, chunked=True)
    with pytest.raises(RpcError, match="template"):
        f.result(0)
    f = g.all_reduce(
        "b5", {"a": np.zeros(4, np.float32), "b": np.zeros(4, np.float64)}, chunked=True
    )
    with pytest.raises(RpcError, match="uniform dtype"):
        f.result(0)


def test_ring_survives_dropped_and_duplicated_chunk_frames(free_port, monkeypatch):
    """Ring chunk messages ride the RPC reliability layer, so frame-level
    faults (drop + duplicate, the test_rpc_sim scenarios) must not change
    results: the dropped chunk is resent via poke/nack and the duplicate is
    deduped at-most-once.  Asyncio backend pinned for deterministic frame
    order, like test_rpc_sim."""
    monkeypatch.setenv("MOOLIB_TPU_NATIVE_TRANSPORT", "0")
    from moolib_tpu_torch.rpc import core as rpc_core

    from test_rpc_sim import FrameSim  # pytest puts tests/ on sys.path

    broker, peers, groups, pump = _make_cohort(free_port)
    try:
        data = [np.random.randn(2048).astype(np.float32) + i for i in range(4)]
        # Clean round first: establishes rank0's connection to its ring
        # neighbor (and the expected sum).
        futs = [g.all_reduce("warm", d, chunked=True) for g, d in zip(groups, data)]
        _wait(futs, pump)
        expect = futs[0].result(0)
        members = groups[0].members()
        me = peers[0][0].get_name()
        nxt = members[(members.index(me) + 1) % len(members)]
        conn = peers[0][0]._peers[nxt].best_connection(peers[0][0]._transport_order)
        # Drop rank0's first two chunk sends to its neighbor, duplicate the
        # next: reliability must resend the former and dedup the latter.
        policy = {rpc_core.KIND_REQUEST: ["drop", "drop", "dup"]}
        with FrameSim(conn, policy) as sim:
            futs = [g.all_reduce("faulty", d, chunked=True) for g, d in zip(groups, data)]
            _wait(futs, pump, timeout=60)
        assert any(a != "pass" for _, _, a in sim.log), sim.log
        for f in futs:
            np.testing.assert_allclose(f.result(0), expect, rtol=1e-6, atol=1e-6)
    finally:
        for rpc, _ in peers:
            rpc.close()
        broker.close()
