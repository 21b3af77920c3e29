"""The port's sharded hierarchical allreduce: reduce-scatter between hosts
plus the owners' redistribution, a loopback cohort in one process.  Case
for case the port of ``tests/test_sharded_allreduce.py``:

- ``shard_ranges`` / ``from_shardings`` are pure functions of protocol
  values (and the JAX package's own functions give the same answers);
- a sharded cohort produces the legacy full-tree cohort's averages bit for
  bit, each host shipping (N-1)/N of the flat payload;
- three-peer mean, a skipping peer, virtual batches, a single peer;
- a mid-run sharding change raises ``GradientShardingError``;
- ``debug_info`` reports the plane.

Plus one mixed cohort: JAX and port peers, all sharded, under either
package's Broker, bitwise equal to an all-JAX sharded cohort on
integer-valued gradients (sums exact in any order).
"""

import time

import numpy as np
import pytest
import torch

import moolib_tpu
import moolib_tpu_torch
from moolib_tpu import buckets as jax_buckets
from moolib_tpu_torch import Accumulator, Broker, GradientShardingError, buckets, telemetry
from moolib_tpu_torch.parallel import NamedSharding, PartitionSpec as P
from moolib_tpu_torch.utils import nest

torch.set_num_threads(1)


# --------------------------------------------------------------- unit layer
@pytest.mark.parametrize("total,n,align", [
    (100, 2, 1), (100, 3, 8), (1024, 4, 64), (7, 3, 1), (5, 8, 1),
    (4096, 5, 512), (1, 1, 1), (10, 2, 4),
])
def test_shard_ranges_cover_align_and_match_jax(total, n, align):
    ranges = buckets.shard_ranges(total, n, align)
    assert ranges == jax_buckets.shard_ranges(total, n, align)
    assert len(ranges) == n
    assert ranges[0][0] == 0 and ranges[-1][1] == total
    for (a0, a1), (b0, b1) in zip(ranges, ranges[1:]):
        assert a1 == b0 and a0 <= a1 and b0 <= b1
    if align * n <= total:
        for _, e in ranges[:-1]:
            assert e % align == 0


def test_shard_ranges_small_payload_falls_back_to_elements():
    ranges = buckets.shard_ranges(10, 3, align=1024)
    assert ranges[0][0] == 0 and ranges[-1][1] == 10
    assert all(e > s for s, e in ranges)


def test_shard_ranges_rejects_bad_n():
    with pytest.raises(ValueError):
        buckets.shard_ranges(100, 0)


def test_from_shardings_plain_tensors():
    tree = {"w": torch.zeros(4, 4), "b": torch.zeros(4)}
    leaves, treedef = nest.tree_flatten(tree)
    shapes = [tuple(l.shape) for l in leaves]
    layout = buckets.BucketLayout.from_shardings(treedef, shapes, [None] * len(leaves))
    plain = buckets.BucketLayout(shapes, np.float32)
    assert layout.shard_cuts == ()
    assert layout.bounds == plain.bounds
    assert layout.signature()[: len(plain.signature())] == plain.signature()


def test_from_shardings_pins_bucket_boundaries_as_jax_does():
    import jax
    from jax.sharding import Mesh, NamedSharding as JNamed, PartitionSpec as JP

    sh = NamedSharding({"dp": 2}, P("dp"))
    shapes = [(64,), (32,)]
    layout = buckets.BucketLayout.from_shardings(None, shapes, [sh, sh], bucket_bytes_=1 << 20)
    assert layout.shard_cuts == (32, 80)
    edges = {s for s, _ in layout.bounds} | {e for _, e in layout.bounds}
    assert {32, 80} <= edges
    assert buckets.sharding_signature((64,), NamedSharding({"dp": 2}, P())) is None
    assert buckets.sharding_signature((64,), sh) == ("PartitionSpec('dp',)", (2,))
    # The JAX package's signature and cuts on the same layout.
    devs = jax.devices()
    if len(devs) >= 2:
        jsh = JNamed(Mesh(np.array(devs[:2]), ("dp",)), JP("dp"))
        assert buckets.sharding_signature((64,), sh) == \
            jax_buckets.sharding_signature((64,), jsh)
        jl = jax_buckets.BucketLayout.from_shardings(
            jax.tree_util.tree_structure([0, 0]), shapes, [jsh, jsh], bucket_bytes_=1 << 20)
        assert jl.bounds == layout.bounds
    assert buckets.sharding_signature((8, 6), NamedSharding({"dp": 2}, P(None, "dp"))) == \
        ("PartitionSpec(None, 'dp')", (1, 2))


# ------------------------------------------------------------- cohort layer
def make_cohort(free_port, n, sharded=False, virtual_batch_size=None, kinds=None,
                broker_kind="port"):
    pkgs = {"jax": moolib_tpu, "port": moolib_tpu_torch}
    kinds = kinds or ["port"] * n
    addr = f"127.0.0.1:{free_port}"
    broker = pkgs[broker_kind].Broker()
    broker.set_name("broker")
    broker.set_timeout(5.0)
    broker.listen(addr)
    accs = []
    for i, kind in enumerate(kinds):
        if kind == "port":
            p = {"w": torch.zeros(8, 8), "b": torch.zeros(8)}
        else:
            p = {"w": np.zeros((8, 8), np.float32), "b": np.zeros(8, np.float32)}
        acc = pkgs[kind].Accumulator("model", p, buffers=None)
        acc._rpc.set_name(f"peer{i}")
        acc._rpc.set_timeout(10)
        acc._rpc.listen("127.0.0.1:0")
        if sharded:
            acc.set_sharded_allreduce(True)
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
                a.set_state({"opt": "s"})
        if until is not None and until():
            return True
        time.sleep(0.02)
    return until() if until is not None else None


def close_all(broker, accs):
    for a in accs:
        a.close()
    broker.close()


def _interhost(kind):
    for m in telemetry.get_registry().collect():
        if m.name == "accum_interhost_bytes_total":
            for labels, value in m.samples():
                if labels.get("kind") == kind:
                    return value
    return 0.0


def _grad_trees(n, shape=(8, 8)):
    """Integer-valued f32 trees: sums and means of n of them stay exactly
    representable, so bit-exactness assertions are strict."""
    rng = np.random.RandomState(7)
    return [{"w": rng.randint(-8, 9, size=shape).astype(np.float32),
             "b": rng.randint(-8, 9, size=(shape[0],)).astype(np.float32)}
            for _ in range(n)]


def _as(kind, tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()} if kind == "port" else tree


def _run_cohort_round(free_port, n, sharded, kinds=None, broker_kind="port"):
    kinds = kinds or ["port"] * n
    broker, accs = make_cohort(free_port, n, sharded=sharded, kinds=kinds,
                               broker_kind=broker_kind)
    trees = _grad_trees(n)
    try:
        assert pump(broker, accs, 30, until=lambda: all(a.connected() for a in accs))
        b0 = _interhost("grad")
        for a, g, kind in zip(accs, trees, kinds):
            assert a.wants_gradients()
            a.reduce_gradients(4, _as(kind, g))
        assert pump(broker, accs, 20, until=lambda: all(a.has_gradients() for a in accs))
        results = [{k: np.array(v) for k, v in a.gradients().items()} for a in accs]
        stats = [a.get_gradient_stats() for a in accs]
        return results, stats, _interhost("grad") - b0
    finally:
        close_all(broker, accs)


def test_sharded_bit_exact_vs_legacy(free_port):
    from conftest import grab_port

    legacy, lstats, lbytes = _run_cohort_round(free_port, 2, sharded=False)
    sharded, sstats, sbytes = _run_cohort_round(grab_port(), 2, sharded=True)
    assert lstats == sstats
    for st in sstats:
        assert st == {"num_gradients": 2, "num_skipped": 0, "batch_size": 8}
    ref = {k: sum(np.asarray(t[k], np.float64) for t in _grad_trees(2)) / 2.0
           for k in ("w", "b")}
    for tree in legacy + sharded:
        for k in ("w", "b"):
            np.testing.assert_array_equal(tree[k], legacy[0][k])
            np.testing.assert_array_equal(tree[k], ref[k].astype(np.float32))
    # Each sharded host contributes (N-1)/N of the payload.
    assert lbytes > 0 and sbytes > 0
    assert sbytes <= 0.55 * lbytes, (sbytes, lbytes)


@pytest.mark.parametrize("broker_kind", ["jax", "port"])
def test_mixed_cohort_sharded_bitwise_equal_to_all_jax(free_port, broker_kind):
    from conftest import grab_port

    ref, rstats, _ = _run_cohort_round(free_port, 3, True, kinds=["jax"] * 3,
                                       broker_kind="jax")
    mixed, mstats, _ = _run_cohort_round(grab_port(), 3, True,
                                         kinds=["jax", "port", "port"],
                                         broker_kind=broker_kind)
    assert mstats == rstats
    for tree in mixed:
        for k in ("w", "b"):
            assert tree[k].tobytes() == ref[0][k].tobytes()


def test_sharded_three_peer_mean(free_port):
    broker, accs = make_cohort(free_port, 3, sharded=True)
    try:
        assert pump(broker, accs, 30, until=lambda: all(a.connected() for a in accs))
        for i, a in enumerate(accs):
            a.reduce_gradients(8, {"w": torch.full((8, 8), float(i + 1)), "b": torch.zeros(8)})
        assert pump(broker, accs, 20, until=lambda: all(a.has_gradients() for a in accs))
        for a in accs:
            np.testing.assert_allclose(np.asarray(a.gradients()["w"]), 2.0)
            assert a.get_gradient_stats() == {
                "num_gradients": 3, "num_skipped": 0, "batch_size": 24}
    finally:
        close_all(broker, accs)


def test_sharded_skip_composes(free_port):
    broker, accs = make_cohort(free_port, 2, sharded=True)
    try:
        assert pump(broker, accs, 30, until=lambda: all(a.connected() for a in accs))
        accs[0].reduce_gradients(4, {"w": torch.ones(8, 8), "b": torch.ones(8)})
        accs[1].skip_gradients()
        assert pump(broker, accs, 20, until=lambda: all(a.has_gradients() for a in accs))
        for a in accs:
            np.testing.assert_allclose(np.asarray(a.gradients()["w"]), 1.0)
            assert a.get_gradient_stats() == {
                "num_gradients": 1, "num_skipped": 1, "batch_size": 4}
    finally:
        close_all(broker, accs)


def test_sharded_vbatch_composes(free_port):
    broker, accs = make_cohort(free_port, 2, sharded=True, virtual_batch_size=16)
    try:
        assert pump(broker, accs, 30, until=lambda: all(a.connected() for a in accs))
        g1 = {"w": torch.ones(8, 8), "b": torch.zeros(8)}
        for a in accs:
            a.reduce_gradients(4, g1)
        assert pump(broker, accs, 20, until=lambda: all(not a._inflight for a in accs))
        assert not any(a.has_gradients() for a in accs)
        for a in accs:
            a.reduce_gradients(4, g1)
        assert pump(broker, accs, 20, until=lambda: all(a.has_gradients() for a in accs))
        for a in accs:
            stats = a.get_gradient_stats()
            assert stats["batch_size"] == 16 and stats["num_gradients"] == 4
            np.testing.assert_allclose(np.asarray(a.gradients()["w"]), 1.0)
    finally:
        close_all(broker, accs)


def test_sharded_single_peer_degenerates(free_port):
    broker, accs = make_cohort(free_port, 1, sharded=True)
    try:
        assert pump(broker, accs, 30, until=lambda: accs[0].connected())
        accs[0].reduce_gradients(4, {"w": torch.full((8, 8), 3.0), "b": torch.zeros(8)})
        assert pump(broker, accs, 20, until=lambda: accs[0].has_gradients())
        np.testing.assert_allclose(np.asarray(accs[0].gradients()["w"]), 3.0)
    finally:
        close_all(broker, accs)


def _sharded_stream(tree, sharding):
    leaves, treedef = nest.tree_flatten(tree)
    stream = buckets.GradientStream(treedef, [tuple(l.shape) for l in leaves],
                                    [l.dtype for l in leaves],
                                    shardings=[sharding] * len(leaves))
    stream.deliver(0, leaves)
    return stream


def test_sharding_change_raises_typed_error(free_port):
    """The first round declares its leaves sharded over a 2-way ``dp`` axis
    (a mesh host's stream); the same tree as plain tensors is a different
    wire layout, refused loudly.  (The DTensor barrier path keys the same
    cache: ``tests/test_torch_hierarchical_dp.py``.)"""
    sh = NamedSharding({"dp": 2}, P("dp"))
    broker, accs = make_cohort(free_port, 2, sharded=True)
    try:
        assert pump(broker, accs, 30, until=lambda: all(a.connected() for a in accs))
        for a in accs:
            a.reduce_gradients(4, _sharded_stream({"w": torch.ones(8, 8), "b": torch.ones(8)}, sh))
        assert pump(broker, accs, 20, until=lambda: all(a.has_gradients() for a in accs))
        for a in accs:
            np.testing.assert_allclose(np.asarray(a.gradients()["w"]), 1.0)
            a.zero_gradients()
        with pytest.raises(GradientShardingError):
            accs[0].reduce_gradients(4, {"w": torch.ones(8, 8), "b": torch.ones(8)})
        assert isinstance(GradientShardingError("x"), RuntimeError)
    finally:
        close_all(broker, accs)


def test_debug_info_reports_sharded(free_port):
    broker, accs = make_cohort(free_port, 2, sharded=True)
    try:
        info = accs[0].debug_info()
        assert info["sharded"] is True
        assert "sharded_layouts" in info
    finally:
        close_all(broker, accs)


def test_sharded_share_down_observes_accum_psum_seconds(free_port):
    """The share-down of a sharded round is timed into accum_psum_seconds,
    the histogram the timeline's comm_vs_psum_ratio reads."""
    from moolib_tpu_torch.telemetry import timeline

    def count():
        fam = telemetry.get_registry().snapshot().get("accum_psum_seconds") or {}
        return sum(s["value"]["count"] for s in fam.get("series", ()))

    c0, t0 = count(), timeline._psum_total()
    broker, accs = make_cohort(free_port, 2, sharded=True)
    try:
        assert pump(broker, accs, 30, until=lambda: all(a.connected() for a in accs))
        for a in accs:
            a.reduce_gradients(4, {"w": torch.ones(8, 8), "b": torch.ones(8)})
        assert pump(broker, accs, 20, until=lambda: all(a.has_gradients() for a in accs))
    finally:
        close_all(broker, accs)
    assert count() == c0 + 2 and timeline._psum_total() > t0
