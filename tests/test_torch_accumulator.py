"""Accumulator tests on the port: an elastic DP cohort of port peers in one
process over loopback, with parameters and gradients as dicts of CPU
tensors (the port of ``tests/test_accumulator.py``, test for test), plus
the port's sorted-key flatten against ``jax.tree_util`` and
``checkpoint.canonical_tree``."""

import time

import collections

import numpy as np
import pytest
import torch

from moolib_tpu_torch import Accumulator, Broker

torch.set_num_threads(1)


def make_cohort(free_port, n, virtual_batch_size=None, versions=None):
    addr = f"127.0.0.1:{free_port}"
    broker = Broker()
    broker.set_name("broker")
    broker.set_timeout(5.0)
    broker.listen(addr)
    accs = []
    for i in range(n):
        params = {"w": torch.zeros(2, 2), "b": torch.zeros(2)}
        acc = Accumulator("model", params, buffers=None)
        acc._rpc.set_name(f"peer{i}")
        acc._rpc.set_timeout(10)
        acc._rpc.listen("127.0.0.1:0")
        if versions:
            acc.set_model_version(versions[i])
        if virtual_batch_size:
            acc.set_virtual_batch_size(virtual_batch_size)
        acc.connect(addr)
        accs.append(acc)
    return broker, accs


def pump(broker, accs, seconds, until=None):
    deadline = time.time() + seconds
    while time.time() < deadline:
        broker.update()
        for a in accs:
            a.update()
            if a.wants_state():
                a.set_state({"opt": "state-of-" + a._rpc.get_name(), "v": a.model_version()})
        if until is not None and until():
            return True
        time.sleep(0.02)
    return until() if until is not None else None


def close_all(broker, accs):
    for a in accs:
        a.close()
    broker.close()


def test_election_and_model_sync(free_port):
    broker, accs = make_cohort(free_port, 3, versions=[5, 2, 0])
    # Give peer0 distinctive params: everyone should converge to them.
    accs[0].set_parameters({"w": torch.full((2, 2), 7.0), "b": torch.ones(2)})
    try:
        ok = pump(broker, accs, 30, until=lambda: all(a.connected() for a in accs))
        assert ok, "cohort never connected"
        assert accs[0].is_leader()  # highest model_version wins
        assert all(a.get_leader() == "peer0" for a in accs)
        assert all(a.model_version() == 5 for a in accs)
        for a in accs[1:]:
            np.testing.assert_allclose(a.parameters()["w"], 7.0)
            assert a.has_new_state() or a.state() is not None
    finally:
        close_all(broker, accs)


def test_gradient_reduction_mean(free_port):
    broker, accs = make_cohort(free_port, 3)
    try:
        assert pump(broker, accs, 30, until=lambda: all(a.connected() for a in accs))
        for i, a in enumerate(accs):
            assert a.wants_gradients()
            g = {"w": torch.full((2, 2), float(i + 1)), "b": torch.zeros(2)}
            a.reduce_gradients(8, g)
        assert pump(broker, accs, 10, until=lambda: all(a.has_gradients() for a in accs))
        for a in accs:
            grads = a.gradients()
            np.testing.assert_allclose(np.asarray(grads["w"]), 2.0)  # mean of 1,2,3
            stats = a.get_gradient_stats()
            assert stats == {"num_gradients": 3, "num_skipped": 0, "batch_size": 24}
            a.zero_gradients()
            assert not a.has_gradients() and a.wants_gradients()
        assert all(a.model_version() == 1 for a in accs)
    finally:
        close_all(broker, accs)


def test_skip_gradients(free_port):
    broker, accs = make_cohort(free_port, 2)
    try:
        assert pump(broker, accs, 30, until=lambda: all(a.connected() for a in accs))
        g = {"w": torch.ones(2, 2), "b": torch.ones(2)}
        accs[0].reduce_gradients(4, g)
        accs[1].skip_gradients()
        assert pump(broker, accs, 10, until=lambda: all(a.has_gradients() for a in accs))
        for a in accs:
            np.testing.assert_allclose(np.asarray(a.gradients()["w"]), 1.0)
            assert a.get_gradient_stats() == {
                "num_gradients": 1,
                "num_skipped": 1,
                "batch_size": 4,
            }
    finally:
        close_all(broker, accs)


def test_virtual_batch_size(free_port):
    broker, accs = make_cohort(free_port, 2, virtual_batch_size=16)
    try:
        assert pump(broker, accs, 30, until=lambda: all(a.connected() for a in accs))
        g1 = {"w": torch.ones(2, 2), "b": torch.zeros(2)}
        # Round 1: total batch 8 < 16 -> no gradients yet.
        for a in accs:
            a.reduce_gradients(4, g1)
        assert pump(
            broker, accs, 10, until=lambda: all(not a._inflight for a in accs)
        )
        assert not any(a.has_gradients() for a in accs)
        assert all(a.wants_gradients() for a in accs)
        # Round 2: another 8 reaches the virtual batch -> fires.
        for a in accs:
            a.reduce_gradients(4, g1)
        assert pump(broker, accs, 10, until=lambda: all(a.has_gradients() for a in accs))
        for a in accs:
            stats = a.get_gradient_stats()
            assert stats["batch_size"] == 16 and stats["num_gradients"] == 4
            # 4 gradient contributions of all-ones, averaged -> 1.
            np.testing.assert_allclose(np.asarray(a.gradients()["w"]), 1.0)
    finally:
        close_all(broker, accs)


def test_late_joiner_gets_model(free_port):
    broker, accs = make_cohort(free_port, 2, versions=[3, 3])
    try:
        assert pump(
            broker, accs, 90, until=lambda: all(a.connected() for a in accs)
        ), "initial cohort never connected"
        leader = [a for a in accs if a.is_leader()][0]
        leader.set_parameters({"w": torch.full((2, 2), 9.0), "b": torch.zeros(2)})

        late = Accumulator(
            "model", {"w": torch.zeros(2, 2), "b": torch.zeros(2)}
        )
        late._rpc.set_name("late")
        late._rpc.set_timeout(10)
        late._rpc.listen("127.0.0.1:0")
        late.connect(f"127.0.0.1:{free_port}")
        accs.append(late)
        # Generous deadline: the suite runs on heavily-loaded single-core
        # CI-style machines where broker epochs + model sync take a while.
        ok = pump(broker, accs, 90, until=lambda: late.connected())
        assert ok, (
            f"late joiner never connected: leader={late.get_leader()} "
            f"synced={late._epoch_synced} members={late._group.members()}"
        )
        np.testing.assert_allclose(np.asarray(late.parameters()["w"]), 9.0)
        assert late.model_version() == leader.model_version()
        # And the cohort can still reduce together — once every member has
        # re-synced for the new epoch (an established peer takes the full
        # transfer too; a contribution made before that is dropped, so the
        # JAX test's immediate round races it and flakes).
        assert pump(broker, accs, 90, until=lambda: all(a.connected() for a in accs))
        g = {"w": torch.ones(2, 2), "b": torch.zeros(2)}
        for a in accs:
            a.reduce_gradients(2, g)
        assert pump(broker, accs, 10, until=lambda: all(a.has_gradients() for a in accs))
        assert all(a.get_gradient_stats()["num_gradients"] == 3 for a in accs)
    finally:
        close_all(broker, accs)


def test_parallel_gradients_pipelined(free_port):
    """With set_parallel_gradients(2) two rounds overlap on the wire; results
    are applied in issue order and the second is held until zero_gradients."""
    broker, accs = make_cohort(free_port, 2)
    try:
        for a in accs:
            a.set_parallel_gradients(2)
        assert pump(broker, accs, 30, until=lambda: all(a.connected() for a in accs))
        # peer0 contributes two rounds back-to-back; peer1 holds back its
        # second contribution, so round 2 cannot complete yet (deterministic:
        # allreduce needs every member).
        first, second = accs
        for round_val in (1.0, 5.0):
            g = {
                "w": torch.full((2, 2), round_val),
                "b": torch.zeros(2),
            }
            first.reduce_gradients(4, g)
        second.reduce_gradients(4, {"w": torch.ones(2, 2), "b": torch.zeros(2)})
        # Both of peer0's slots are used (round 1 may have completed already —
        # then has_gradients blocks; otherwise the pipeline is full).
        assert not first.wants_gradients()
        with pytest.raises(Exception, match="in flight|unconsumed"):
            first.reduce_gradients(4, {"w": torch.ones(2, 2), "b": torch.zeros(2)})
        # First round lands first, in order, on every peer.
        assert pump(broker, accs, 10, until=lambda: all(a.has_gradients() for a in accs))
        for a in accs:
            np.testing.assert_allclose(np.asarray(a.gradients()["w"]), 1.0)
            a.zero_gradients()
        # peer1 contributes its second round; peer0's was pipelined and needs
        # no new contribution.
        second.reduce_gradients(4, {"w": torch.full((2, 2), 5.0), "b": torch.zeros(2)})
        assert pump(broker, accs, 10, until=lambda: all(a.has_gradients() for a in accs))
        for a in accs:
            np.testing.assert_allclose(np.asarray(a.gradients()["w"]), 5.0)
            a.zero_gradients()
        assert all(a.model_version() == 2 for a in accs)
    finally:
        close_all(broker, accs)


def test_leader_death_reelection(free_port):
    broker, accs = make_cohort(free_port, 3, versions=[9, 4, 4])
    broker.set_timeout(2.0)
    try:
        assert pump(broker, accs, 30, until=lambda: all(a.connected() for a in accs))
        leader = [a for a in accs if a.is_leader()][0]
        assert leader._rpc.get_name() == "peer0"
        survivors = [a for a in accs if a is not leader]
        leader.close()
        accs.remove(leader)
        ok = pump(
            broker,
            survivors,
            40,
            until=lambda: all(
                a.connected() and a.get_leader() != "peer0" for a in survivors
            ),
        )
        assert ok, "re-election never happened"
        leaders = {a.get_leader() for a in survivors}
        assert len(leaders) == 1
    finally:
        close_all(broker, accs)


def test_stale_buffers_push_rejected(free_port):
    """Buffers pushes are epoch+version stamped; a
    delayed push from a previous epoch's leader must not overwrite newer
    buffers."""
    broker, accs = make_cohort(free_port, 2)
    try:
        assert pump(broker, accs, 30, until=lambda: all(a.connected() for a in accs))
        follower = [a for a in accs if not a.is_leader()][0]
        follower.set_buffers({"bn": torch.ones(2)})
        epoch = follower._group.sync_id()
        # Stale epoch: dropped.
        assert follower._on_buffers_update(epoch - 1, 7, {"bn": np.zeros(2)}) is False
        np.testing.assert_allclose(follower.buffers()["bn"], 1.0)
        # Fresh push: applied (guard tracks the last APPLIED buffers version,
        # not our model version — the follower's counter can transiently run
        # ahead of the leader's after consuming a result first).
        follower._model_version = 99
        assert follower._on_buffers_update(epoch, 7, {"bn": np.full(2, 3.0, np.float32)}) is True
        np.testing.assert_allclose(follower.buffers()["bn"], 3.0)
        # Older than the applied one: dropped.
        assert follower._on_buffers_update(epoch, 6, {"bn": np.zeros(2)}) is False
        np.testing.assert_allclose(follower.buffers()["bn"], 3.0)
        # Same-version periodic re-push: applied (leader re-sends every 12 s).
        assert follower._on_buffers_update(epoch, 7, {"bn": np.full(2, 4.0, np.float32)}) is True
        np.testing.assert_allclose(follower.buffers()["bn"], 4.0)
    finally:
        close_all(broker, accs)


def test_two_phase_with_pipelined_contributions(free_port):
    """Virtual batching composed with set_parallel_gradients(2): count
    rounds overlap on the wire, local contributions fold in issue order,
    and the single gradient allreduce fires with the right totals."""
    broker, accs = make_cohort(free_port, 2, virtual_batch_size=16)
    try:
        for a in accs:
            a.set_parallel_gradients(2)
        assert pump(broker, accs, 30, until=lambda: all(a.connected() for a in accs))
        # Two back-to-back contributions per peer (both slots used), then a
        # final pair that crosses the 16 threshold.
        for v in (1.0, 3.0):
            g = {"w": torch.full((2, 2), v), "b": torch.zeros(2)}
            for a in accs:
                a.reduce_gradients(3, g)
        assert pump(broker, accs, 15, until=lambda: all(not a._inflight for a in accs))
        assert not any(a.has_gradients() for a in accs)  # 12 < 16
        g = {"w": torch.full((2, 2), 5.0), "b": torch.zeros(2)}
        for a in accs:
            a.reduce_gradients(2, g)
        assert pump(broker, accs, 15, until=lambda: all(a.has_gradients() for a in accs))
        for a in accs:
            stats = a.get_gradient_stats()
            assert stats == {"num_gradients": 6, "num_skipped": 0, "batch_size": 16}, stats
            # mean of (1, 3, 5) per peer, same on both peers
            np.testing.assert_allclose(np.asarray(a.gradients()["w"]), 3.0)
            a.zero_gradients()
        # Wire-level: exactly ONE gradient allreduce went out.
        sid = accs[0]._group.sync_id()
        assert accs[0]._group._seq[(sid, "__accum_grad:model")] == 1
        assert accs[0]._group._seq[(sid, "__accum_count:model")] == 3
    finally:
        close_all(broker, accs)


def test_ici_plane_switches_across_eligibility_churn(free_port):
    """The collective backend requires the cohort to span exactly the
    process group (here none: a world of 1).  A solo cohort rides
    ICI; when a second member joins, members != process_count and reductions
    must transparently fall back to the RPC tree; when it leaves, back to
    ICI.  No round may strand across the switches, and debug_info() must
    report the plane each round took."""
    import torch.distributed as dist

    assert not dist.is_initialized()  # no process group: a world of 1
    broker, accs = make_cohort(free_port, 1)
    a0 = accs[0]
    a0.set_ici_backend(True)
    try:
        assert pump(broker, accs, 30, until=lambda: a0.connected())
        g = {"w": torch.ones(2, 2), "b": torch.ones(2)}

        # Solo cohort: eligible -> psum plane.
        assert a0.debug_info()["ici_eligible"]
        a0.reduce_gradients(4, g)
        assert pump(broker, accs, 15, until=a0.has_gradients)
        np.testing.assert_allclose(np.asarray(a0.gradients()["w"]), 1.0)
        a0.zero_gradients()
        dbg = a0.debug_info()
        assert dbg["last_plane"] == "ici" and dbg["ici_reduces"] == 1, dbg
        assert dbg["reduce_bytes"]["ici"] > 0

        # A second member joins: 2 members != 1 process -> RPC tree.
        a1 = Accumulator(
            "model",
            {"w": torch.zeros(2, 2), "b": torch.zeros(2)},
            buffers=None,
        )
        a1._rpc.set_name("late-joiner")
        a1._rpc.set_timeout(10)
        a1._rpc.listen("127.0.0.1:0")
        a1.set_ici_backend(True)
        a1.connect(f"127.0.0.1:{free_port}")
        accs.append(a1)
        assert pump(
            broker, accs, 30,
            until=lambda: a0.connected() and a1.connected()
            and len(a0._group.members()) == 2,
        )
        assert not a0.debug_info()["ici_eligible"]
        for a in (a0, a1):
            a.reduce_gradients(4, g)
        assert pump(broker, accs, 15, until=lambda: a0.has_gradients() and a1.has_gradients())
        for a in (a0, a1):
            np.testing.assert_allclose(np.asarray(a.gradients()["w"]), 1.0)
            a.zero_gradients()
            dbg = a.debug_info()
            assert dbg["last_plane"] == "rpc" and dbg["rpc_reduces"] >= 1, dbg
        assert a0.debug_info()["reduce_bytes"]["rpc"] > 0

        # The joiner leaves: solo again -> back on ICI, nothing stranded.
        a1.close()
        accs.remove(a1)
        assert pump(
            broker, accs, 30,
            until=lambda: a0.connected() and len(a0._group.members()) == 1,
        )
        assert a0.debug_info()["ici_eligible"]
        a0.reduce_gradients(4, g)
        assert pump(broker, accs, 15, until=a0.has_gradients)
        np.testing.assert_allclose(np.asarray(a0.gradients()["w"]), 1.0)
        a0.zero_gradients()
        dbg = a0.debug_info()
        assert dbg["last_plane"] == "ici" and dbg["ici_reduces"] == 2, dbg
        assert not a0._inflight, "stranded round after churn"
    finally:
        close_all(broker, accs)


def test_ici_progress_bound_adapts_to_round_duration():
    """The wedged-peer heartbeat's effective bound stretches with observed
    round cost (4x last + 5s, floored at the configured bound) so a
    legitimately slow collective is never proposed for abort — the formula
    the wedge tests rely on, pinned directly."""
    acc = Accumulator("t", {"w": torch.zeros(2)})
    try:
        assert acc._ici_progress_bound_now() == acc._ici_progress_bound == 20.0
        acc.set_ici_progress_bound(6.0)
        assert acc._ici_progress_bound_now() == 6.0
        acc._ici_last_round_s = 10.0  # slow but healthy rounds observed
        assert acc._ici_progress_bound_now() == 4 * 10.0 + 5.0
        acc._ici_last_round_s = 0.1
        assert acc._ici_progress_bound_now() == 6.0  # configured floor wins
    finally:
        acc.close()


# --------------------------------------------------- wire-protocol helpers
NT = collections.namedtuple("NT", "a b")
TREES = [
    {"w": 1, "b": 2},
    {"z": {"y": 1, "a": [2, 3]}, "a": (4, None, 5)},
    [NT(1, {"q": 2, "p": 3}), None],
    collections.OrderedDict([("z", 1), ("a", 2)]),
    (1, (2, [3, {"b": 4, "a": 5}])),
]


@pytest.mark.parametrize("tree", TREES)
def test_tree_flatten_order_matches_jax(tree):
    """The flatten order is wire protocol: sorted dict keys, None a node
    without leaves, sequences and namedtuples by position — as
    ``jax.tree_util`` flattens on a JAX peer."""
    import jax

    from moolib_tpu_torch.utils import nest

    leaves, treedef = nest.tree_flatten(tree)
    assert leaves == jax.tree_util.tree_leaves(tree)
    assert nest.tree_unflatten(treedef, leaves) == tree
    assert treedef == nest.tree_flatten(tree)[1]
    assert hash(treedef) == hash(nest.tree_flatten(tree)[1])
    doubled = nest.tree_map(lambda x, y: x + y, tree, tree)
    assert nest.tree_leaves(doubled) == [2 * x for x in leaves]


def test_canonical_tree_and_sync_blob_match_the_jax_package():
    """A port leader and a JAX leader pickle the same model-sync blob (and
    so advertise the same sha) for the same values, whatever the insertion
    order of the dicts."""
    import pickle

    from moolib_tpu import Accumulator as JaxAccumulator
    from moolib_tpu import checkpoint as jax_checkpoint
    from moolib_tpu_torch import checkpoint

    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 2)).astype(np.float32)
    b = rng.standard_normal(2).astype(np.float32)
    state = {"steps": 7, "opt": [None, {"nu": np.ones(3, np.float32)}]}
    tree = {"w": w, "b": b, "s": state}
    assert pickle.dumps(checkpoint.canonical_tree(tree)) == pickle.dumps(
        jax_checkpoint.canonical_tree(tree))
    port = Accumulator("m", {"w": torch.from_numpy(w), "b": torch.from_numpy(b)})
    ref = JaxAccumulator("m", {"b": b, "w": w})
    try:
        port_state = {"steps": 7, "opt": [None, {"nu": torch.ones(3)}]}
        chunks, sha = port._sync_chunks(3, port.parameters(), None, port_state)
        ref_chunks, ref_sha = ref._sync_chunks(3, ref.parameters(), None, state)
        assert sha == ref_sha and b"".join(chunks) == b"".join(ref_chunks)
    finally:
        port.close()
        ref.close()


def test_out_of_slice_planes_say_so():
    from moolib_tpu_torch import buckets, checkpoint

    acc = Accumulator("t", {"w": torch.zeros(2)})
    try:
        with pytest.raises(NotImplementedError, match=r"not yet ported \(slice 9\)"):
            acc.set_sharded_allreduce(True)
        with pytest.raises(NotImplementedError, match=r"not yet ported \(slice 7\)"):
            acc.enable_distributed_checkpoint(object())
        stream = buckets.GradientStream(None, [(2,)], [np.float32])
        with pytest.raises(NotImplementedError, match=r"not yet ported \(slice 9\)"):
            acc.reduce_gradients(1, stream)
    finally:
        acc.close()
    with pytest.raises(ImportError, match=r"not yet ported \(slice 7\)"):
        checkpoint.Checkpointer  # noqa: B018


def test_results_come_back_as_tensors_with_the_callers_dtypes(free_port):
    """gradients() hands the cohort mean back as tensors on the device the
    gradients came from (here the CPU), each leaf in its own dtype: bf16
    leaves reduce in f32 on the bf16 wire and are restored."""
    broker, accs = make_cohort(free_port, 2)
    try:
        for a in accs:
            a.set_wire_dtype(torch.bfloat16)
        assert pump(broker, accs, 30, until=lambda: all(a.connected() for a in accs))
        for i, a in enumerate(accs):
            a.reduce_gradients(1, {"w": torch.full((2, 2), float(i + 1)).to(torch.bfloat16),
                                   "b": torch.full((2,), 2.0 * (i + 1))})
        assert pump(broker, accs, 10, until=lambda: all(a.has_gradients() for a in accs))
        for a in accs:
            g = a.gradients()
            assert isinstance(g["w"], torch.Tensor) and g["w"].dtype == torch.bfloat16
            assert g["b"].dtype == torch.float32
            assert torch.equal(g["w"].float(), torch.full((2, 2), 1.5))
            assert torch.equal(g["b"], torch.full((2,), 3.0))
    finally:
        close_all(broker, accs)


def test_count_path_copies_the_contribution(free_port):
    """A contributed tensor may be overwritten in place by the next
    backward; the virtual-batch path keeps its own copy."""
    broker, accs = make_cohort(free_port, 2, virtual_batch_size=8)
    try:
        assert pump(broker, accs, 30, until=lambda: all(a.connected() for a in accs))
        grads = [{"w": torch.ones(2, 2), "b": torch.zeros(2)} for _ in accs]
        for a, g in zip(accs, grads):
            a.reduce_gradients(2, g)
        for g in grads:
            g["w"].fill_(100.0)  # after the count round was issued
        assert pump(broker, accs, 10, until=lambda: all(not a._inflight for a in accs))
        for a, g in zip(accs, grads):
            g["w"].fill_(1.0)
            a.reduce_gradients(2, g)
        assert pump(broker, accs, 10, until=lambda: all(a.has_gradients() for a in accs))
        for a in accs:
            np.testing.assert_array_equal(a.gradients()["w"].numpy(), 1.0)
    finally:
        close_all(broker, accs)


def test_cohort_peer_answers_the_cohort_aggregator(free_port):
    """Every Accumulator installs the aggregator's scrape endpoints on its
    Rpc (as the JAX package's does): a CohortAggregator finds the cohort
    through the broker and pulls each peer's registry snapshot."""
    from moolib_tpu_torch.rpc import Rpc
    from moolib_tpu_torch.telemetry import CohortAggregator

    broker, accs = make_cohort(free_port, 2)
    scraper = Rpc()
    scraper.set_name("scraper")
    try:
        assert pump(broker, accs, 30, until=lambda: all(a.connected() for a in accs))
        scraper.connect(f"127.0.0.1:{free_port}")
        agg = CohortAggregator(scraper, "broker", group="model", scrape_timeout=10.0)
        fused = {"peers": {}}
        deadline = time.time() + 20
        while len(fused["peers"]) < 2 and time.time() < deadline:
            broker.update()
            for a in accs:
                a.update()
            fused = agg.scrape()
        assert sorted(fused["peers"]) == ["peer0", "peer1"], fused["errors"]
        for name, row in fused["peers"].items():
            assert row["name"] == name and row["role"] == "member"
            assert "accum_reduces_total" in row["metrics"]
        snap = scraper.sync("peer0", "__telemetry_snapshot")
        assert snap["name"] == "peer0" and "metrics" in snap
    finally:
        scraper.close()
        close_all(broker, accs)


def test_result_of_a_dead_epoch_is_dropped_unapplied(free_port):
    """A result still unconsumed when its epoch dies (here a peer leaves) is
    dropped by has_gradients() instead of applied: the survivors keep the
    same parameters under the same version, and the next epoch's round
    applies on every one of them alike."""
    broker, accs = make_cohort(free_port, 3)
    broker.set_timeout(2.0)
    try:
        assert pump(broker, accs, 30, until=lambda: all(a.connected() for a in accs))
        for i, a in enumerate(accs):
            a.reduce_gradients(4, {"w": torch.full((2, 2), float(i + 1)), "b": torch.ones(2)})
        assert pump(broker, accs, 10, until=lambda: all(a._has_gradients for a in accs))
        epoch = accs[0]._group.sync_id()
        leaver = accs.pop()
        leaver.close()
        assert pump(broker, accs, 40, until=lambda: all(
            a.connected() and a._group.sync_id() != epoch and len(a._group.members()) == 2
            for a in accs))
        for a in accs:
            assert not a.has_gradients() and a.wants_gradients()
            assert a.model_version() == 0
            np.testing.assert_array_equal(a.parameters()["w"], 0.0)
        for i, a in enumerate(accs):
            a.reduce_gradients(4, {"w": torch.full((2, 2), float(i + 1)), "b": torch.ones(2)})
        assert pump(broker, accs, 10, until=lambda: all(a.has_gradients() for a in accs))
        for a in accs:
            np.testing.assert_allclose(np.asarray(a.gradients()["w"]), 1.5)  # mean of 1, 2
            a.zero_gradients()
            assert a.model_version() == 1
    finally:
        close_all(broker, accs)
