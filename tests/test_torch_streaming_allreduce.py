"""The port's streaming gradient pipeline: buckets launch onto the
inter-host wire while the producer is still delivering, via
``buckets.GradientStream`` -> ``Accumulator.reduce_gradients``.  The port
of ``tests/test_streaming_allreduce.py``, case for case:

- a streaming contribution is bit-identical to the barrier contribution
  (tree, q8 wire, sharded plane, and the materializing fallbacks: chunked
  ring, virtual batching), and every bucket staged before the last one
  launches early;
- the per-bucket callback, a single member, a membership-epoch bump with
  buckets in flight (a loud ``RpcError``), a producer failure, a mid-run
  sharding change (``GradientShardingError``);
- ``make_train_step(overlap_grads=True)``: the stream equals the plain
  autograd gradients; the guards.

The JAX test's D2H-ordering case is the port's
``tests/test_torch_buckets.py::test_gradient_stream_stages_and_waits_per_chunk``.
Two more cases: the hook-streamed step delivers its runs during the
backward, in the hooks' order, and equals the barrier step bit for bit;
and a mixed cohort in which the port peers stream and the JAX peer takes
the barrier path is bitwise equal to an all-JAX cohort.
"""

import threading
import time

import numpy as np
import pytest
import torch

import moolib_tpu
from moolib_tpu_torch import GradientShardingError, buckets
from moolib_tpu_torch import parallel
from moolib_tpu_torch.parallel import NamedSharding, PartitionSpec as P
from moolib_tpu_torch.rpc import RpcError
from moolib_tpu_torch.utils import nest

from test_torch_sharded_allreduce import close_all, make_cohort, pump

torch.set_num_threads(1)


def test_coverage_merging():
    c = buckets.Coverage()
    assert c.covers(5, 5)
    assert not c.covers(0, 1)
    c.add(0, 10)
    c.add(20, 30)
    assert c.covers(0, 10) and c.covers(2, 7) and not c.covers(5, 25)
    c.add(10, 20)
    assert c.covers(0, 30)
    c.add(5, 15)
    assert c.covers(0, 30) and not c.covers(0, 31)


def test_gradient_stream_protocol():
    leaves, treedef = nest.tree_flatten({"b": torch.zeros(4), "w": torch.zeros(4, 4)})
    s = buckets.GradientStream(treedef, [tuple(l.shape) for l in leaves],
                               [l.dtype for l in leaves])
    assert s.n_leaves == 2 and not s.complete
    s.deliver(1, [leaves[1]])
    with pytest.raises(ValueError):
        s.deliver(1, [leaves[1]])
    with pytest.raises(ValueError):
        s.deliver(5, [leaves[0]])
    s.deliver(0, [leaves[0]])
    assert s.complete
    got = {}
    while True:
        c = s.next_chunk(1.0)
        if c is None:
            break
        got[c[0]] = c[1]
    assert set(got) == {0, 1}


def test_gradient_stream_timeout_and_fail():
    _, treedef = nest.tree_flatten([torch.zeros(4)])
    s = buckets.GradientStream(treedef, [(4,)], [np.float32])
    with pytest.raises(TimeoutError):
        s.next_chunk(0.05)
    s.fail(RuntimeError("producer died"))
    with pytest.raises(RuntimeError, match="producer died"):
        s.next_chunk(1.0)


def _int_trees(n, shape=(64, 64), seed=7):
    rng = np.random.RandomState(seed)
    return [{"b": rng.randint(-8, 9, size=(shape[0],)).astype(np.float32),
             "w": rng.randint(-8, 9, size=shape).astype(np.float32)} for _ in range(n)]


def _tensors(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _stream_of(tree, on_bucket=None, shardings=None):
    leaves, treedef = nest.tree_flatten(tree)
    return (buckets.GradientStream(treedef, [tuple(l.shape) for l in leaves],
                                   [l.dtype for l in leaves], shardings=shardings,
                                   on_bucket=on_bucket), leaves)


def _reduce_streaming(accs, trees, stagger=0.15):
    """Each tree as a stream: the tail leaf ("w", the bulk) at once, the
    head leaf ("b") ``stagger`` seconds later from a producer thread."""
    threads = []
    for a, t in zip(accs, trees):
        s, leaves = _stream_of(_tensors(t), shardings=[None] * 2)
        s.deliver(1, [leaves[1]])

        def _late(s=s, leaves=leaves):
            time.sleep(stagger)
            s.deliver(0, [leaves[0]])

        threading.Thread(target=_late, daemon=True).start()
        th = threading.Thread(target=a.reduce_gradients, args=(4, s))
        th.start()
        threads.append(th)
    for th in threads:
        th.join(30)
        assert not th.is_alive()


def _collect(accs):
    return [{k: np.array(v) for k, v in a.gradients().items()} for a in accs]


def _ref_mean(trees):
    return {k: (sum(np.asarray(t[k], np.float64) for t in trees) / len(trees)).astype(np.float32)
            for k in trees[0]}


@pytest.fixture
def small_buckets():
    buckets.set_bucket_bytes(1 << 12)  # 1024 f32 elems: multi-bucket trees
    moolib_tpu.buckets.set_bucket_bytes(1 << 12)
    yield
    buckets.set_bucket_bytes(buckets._DEFAULT_BUCKET_BYTES)
    moolib_tpu.buckets.set_bucket_bytes(moolib_tpu.buckets._DEFAULT_BUCKET_BYTES)


def _wire(accs, q8):
    if q8:
        for a in accs:
            a.set_wire_dtype("int8")


def _run_barrier_round(port, n, trees, sharded=False, q8=False):
    broker, accs = make_cohort(port, n, sharded=sharded)
    try:
        _wire(accs, q8)
        assert pump(broker, accs, 30, until=lambda: all(a.connected() for a in accs))
        for a, t in zip(accs, trees):
            a.reduce_gradients(4, _tensors(t))
        assert pump(broker, accs, 20, until=lambda: all(a.has_gradients() for a in accs))
        return _collect(accs)
    finally:
        close_all(broker, accs)


def _run_streaming_round(port, n, trees, sharded=False, q8=False):
    broker, accs = make_cohort(port, n, sharded=sharded)
    try:
        _wire(accs, q8)
        assert pump(broker, accs, 30, until=lambda: all(a.connected() for a in accs))
        done = threading.Event()
        pumper = threading.Thread(target=lambda: pump(broker, accs, 30, until=done.is_set),
                                  daemon=True)
        pumper.start()
        try:
            _reduce_streaming(accs, trees)
            assert pump(broker, accs, 20, until=lambda: all(a.has_gradients() for a in accs))
        finally:
            done.set()
            pumper.join(5)
        return _collect(accs), [a._last_launch_leads for a in accs]
    finally:
        close_all(broker, accs)


def test_streaming_bit_exact_vs_barrier_and_numpy(free_port, small_buckets):
    from conftest import grab_port

    trees = _int_trees(2)
    barrier = _run_barrier_round(free_port, 2, trees)
    streamed, leads = _run_streaming_round(grab_port(), 2, trees)
    ref = _ref_mean(trees)
    for tree in barrier + streamed:
        for k in ("w", "b"):
            np.testing.assert_array_equal(tree[k], ref[k])
            np.testing.assert_array_equal(tree[k], barrier[0][k])
    for peer_leads in leads:
        assert peer_leads is not None and len(peer_leads) >= 2
        assert max(peer_leads) > 0.05
        assert min(peer_leads) == 0.0


def test_streaming_q8_bit_exact_vs_barrier(free_port, small_buckets):
    from conftest import grab_port

    trees = _int_trees(2, seed=11)
    barrier = _run_barrier_round(free_port, 2, trees, q8=True)
    streamed, _ = _run_streaming_round(grab_port(), 2, trees, q8=True)
    for b, s in zip(barrier, streamed):
        for k in ("w", "b"):
            np.testing.assert_array_equal(s[k], b[k])
            np.testing.assert_array_equal(s[k], barrier[0][k])


def test_streaming_sharded_bit_exact(free_port, small_buckets):
    from conftest import grab_port

    trees = _int_trees(3, seed=13)
    barrier = _run_barrier_round(free_port, 3, trees, sharded=True)
    streamed, _ = _run_streaming_round(grab_port(), 3, trees, sharded=True)
    ref = _ref_mean(trees)
    for tree in barrier + streamed:
        for k in ("w", "b"):
            np.testing.assert_array_equal(tree[k], ref[k])


@pytest.mark.parametrize("fallback", ["ring", "vbatch"])
def test_streaming_materializes_on_ring_and_vbatch(free_port, small_buckets, fallback):
    broker, accs = make_cohort(free_port, 2,
                               virtual_batch_size=8 if fallback == "vbatch" else None)
    try:
        if fallback == "ring":
            for a in accs:
                a.set_chunked_allreduce(True)  # the ring: the stream must materialize
        assert pump(broker, accs, 30, until=lambda: all(a.connected() for a in accs))
        trees = _int_trees(2, seed=17)
        _reduce_streaming(accs, trees)
        assert pump(broker, accs, 20, until=lambda: all(a.has_gradients() for a in accs))
        ref = _ref_mean(trees)
        for tree in _collect(accs):
            for k in ("w", "b"):
                np.testing.assert_array_equal(tree[k], ref[k])
        assert all(a._last_launch_leads == [] for a in accs)  # never streamed
    finally:
        close_all(broker, accs)


def test_streaming_single_member_degenerates(free_port, small_buckets):
    broker, accs = make_cohort(free_port, 1)
    try:
        assert pump(broker, accs, 30, until=lambda: accs[0].connected())
        tree = _int_trees(1, seed=19)[0]
        s, leaves = _stream_of(_tensors(tree))
        s.deliver(0, leaves)
        accs[0].reduce_gradients(4, s)
        assert pump(broker, accs, 20, until=lambda: accs[0].has_gradients())
        got = _collect(accs)[0]
        for k in ("w", "b"):
            np.testing.assert_array_equal(got[k], tree[k])
    finally:
        close_all(broker, accs)


def test_on_bucket_callback_fires_per_bucket(free_port, small_buckets):
    broker, accs = make_cohort(free_port, 2)
    try:
        assert pump(broker, accs, 30, until=lambda: all(a.connected() for a in accs))
        trees = _int_trees(2, seed=23)
        hits, streams = [], []
        for a, t in zip(accs, trees):
            cb = (lambda lo, hi: hits.append((lo, hi))) if a is accs[0] else None
            s, leaves = _stream_of(_tensors(t), on_bucket=cb)
            s.deliver(0, leaves)
            streams.append(s)
        ths = [threading.Thread(target=a.reduce_gradients, args=(4, s))
               for a, s in zip(accs, streams)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(30)
        assert pump(broker, accs, 20, until=lambda: all(a.has_gradients() for a in accs))
        total = sum(v.size for v in trees[0].values())
        assert sorted(hits) == sorted(set(hits)) and len(hits) >= 2
        assert min(lo for lo, _ in hits) == 0
        assert max(hi for _, hi in hits) == total
    finally:
        close_all(broker, accs)


def test_epoch_bump_with_buckets_in_flight_errors_loudly(free_port, small_buckets):
    broker, accs = make_cohort(free_port, 2)
    try:
        assert pump(broker, accs, 30, until=lambda: all(a.connected() for a in accs))
        g = accs[0]._group
        handle = g.bucketed_stream("__stream_test", np.zeros(4096, np.float32))
        assert len(handle.bounds) >= 2
        handle.launch(0)
        with g._lock:
            g._sync_id += 1
        with pytest.raises(RpcError, match="group changed"):
            handle.launch(1)
        assert handle.future.exception() is not None
        with pytest.raises(RpcError, match="already failed"):
            handle.launch(1)
    finally:
        close_all(broker, accs)


def test_producer_failure_aborts_round(free_port, small_buckets):
    broker, accs = make_cohort(free_port, 2)
    try:
        assert pump(broker, accs, 30, until=lambda: all(a.connected() for a in accs))
        tree = _int_trees(1)[0]
        s, leaves = _stream_of(_tensors(tree), shardings=[None] * 2)
        s.deliver(1, [leaves[1]])
        s.fail(RuntimeError("backward blew up"))
        with pytest.raises((RuntimeError, RpcError)):
            accs[0].reduce_gradients(4, s)
        assert pump(broker, accs, 20, until=lambda: not accs[0]._inflight)
        accs[1].close()
        accs.pop(1)
        assert pump(broker, accs, 30, until=lambda: len(accs[0]._group.members()) == 1)
        accs[0].reduce_gradients(4, _tensors(tree))
        assert pump(broker, accs, 20, until=lambda: accs[0].has_gradients())
        np.testing.assert_array_equal(_collect(accs)[0]["w"], tree["w"])
    finally:
        close_all(broker, accs)


def test_streaming_sharding_change_raises_typed_error(free_port, small_buckets):
    sh = NamedSharding({"dp": 2}, P("dp"))
    broker, accs = make_cohort(free_port, 2, sharded=True)
    try:
        assert pump(broker, accs, 30, until=lambda: all(a.connected() for a in accs))
        tree = {"b": torch.ones(8), "w": torch.ones(8, 8)}
        for a in accs:  # the first round keys the layout on a 2-way dp sharding
            s, leaves = _stream_of(tree, shardings=[sh, sh])
            s.deliver(0, leaves)
            a.reduce_gradients(4, s)
        assert pump(broker, accs, 20, until=lambda: all(a.has_gradients() for a in accs))
        for a in accs:
            a.zero_gradients()
        s, leaves = _stream_of(tree, shardings=[None, None])
        s.deliver(0, leaves)
        with pytest.raises(GradientShardingError):
            accs[0].reduce_gradients(4, s)
    finally:
        close_all(broker, accs)


def _mlp():
    g = torch.Generator().manual_seed(3)
    params = {"w1": torch.nn.Parameter(torch.randn(8, 32, generator=g)),
              "w2": torch.nn.Parameter(torch.randn(32, 4, generator=g)),
              "w3": torch.nn.Parameter(torch.randn(4, 4, generator=g))}
    batch = {"x": torch.randn(16, 8, generator=g), "y": torch.zeros(16, 4)}

    def loss_fn(p, b, r):
        out = torch.tanh(b["x"] @ p["w1"]) @ p["w2"] @ p["w3"]
        return ((out - b["y"]) ** 2).mean(), {"n": out.shape[0]}

    return params, batch, loss_fn


def _drain(stream):
    got = {}
    while True:
        c = stream.next_chunk(5.0)
        if c is None:
            return got
        lo, leaves = c
        for i, leaf in enumerate(leaves, start=lo):
            got[i] = np.array(leaf)


def test_make_train_step_overlap_grads_end_to_end(free_port, small_buckets):
    params, batch, loss_fn = _mlp()
    loss_ref, _ = loss_fn(params, batch, None)
    g_ref = torch.autograd.grad(loss_ref, list(params.values()))
    step = parallel.make_train_step(loss_fn, overlap_grads=True)
    loss, aux, stream = step(params, batch, None)
    assert isinstance(stream, buckets.GradientStream)
    assert float(loss) == float(loss_ref.detach())
    broker, accs = make_cohort(free_port, 1)
    try:
        assert pump(broker, accs, 30, until=lambda: accs[0].connected())
        accs[0].reduce_gradients(16, stream)
        assert pump(broker, accs, 20, until=lambda: accs[0].has_gradients())
        got = _collect(accs)[0]
        for k, g in zip(params, g_ref):
            np.testing.assert_allclose(got[k], g.numpy(), rtol=1e-6, atol=1e-7)
    finally:
        close_all(broker, accs)


def test_overlap_step_delivers_during_backward_and_equals_barrier(small_buckets):
    """Leaves of 256 f32 cut into runs at the 1024-element grid: the hooks
    hand out each run while the backward still runs (the order is the
    backward's: the last layers first), and the streamed gradients are the
    plain backward's bit for bit."""
    g = torch.Generator().manual_seed(5)
    params = {f"l{i}": torch.nn.Parameter(torch.randn(16, 16, generator=g) / 4)
              for i in range(8)}
    x = torch.randn(4, 16, generator=g)

    def loss_fn(p, b, r):
        h = b
        for i in range(8):
            h = torch.tanh(h @ p[f"l{i}"])
        return (h ** 2).sum(), None

    step = parallel.make_train_step(loss_fn, overlap_grads=True)
    _, _, stream = step(params, x, None)
    log = step.inner.log
    assert len(log) == 2 and all(in_bwd for _, _, in_bwd, _ in log)
    assert [(lo, hi) for lo, hi, _, _ in log] == [(4, 8), (0, 4)]  # tail first
    got = _drain(stream)
    for p in params.values():
        p.grad = None
    loss_fn(params, x, None)[0].backward()
    for i, k in enumerate(sorted(params)):
        assert got[i].tobytes() == params[k].grad.numpy().tobytes(), k
    # A backward outside the step leaves the hooks inert.
    assert len(step.inner.log) == 2


def test_make_train_step_overlap_guards():
    params, batch, loss_fn = _mlp()
    with pytest.raises(ValueError, match="does not compose with optimizer"):
        parallel.make_train_step(loss_fn, optimizer=torch.optim.SGD(params.values(), 0.1),
                                 overlap_grads=True)
    with pytest.raises(ValueError, match="requires mesh"):
        parallel.make_train_step(loss_fn, grad_spec="replicated")
    with pytest.raises(ValueError, match="needs an optimizer"):
        parallel.make_train_step(loss_fn)
    assert parallel.make_train_step(loss_fn, overlap_grads=True) is not None


@pytest.mark.parametrize("broker_kind", ["jax", "port"])
def test_mixed_cohort_port_streams_jax_barrier_bitwise(free_port, small_buckets, broker_kind):
    from conftest import grab_port

    trees = _int_trees(3, seed=29)
    ref_b, ref = make_cohort(free_port, 3, kinds=["jax"] * 3, broker_kind="jax")
    try:
        assert pump(ref_b, ref, 30, until=lambda: all(a.connected() for a in ref))
        for a, t in zip(ref, trees):
            a.reduce_gradients(4, t)
        assert pump(ref_b, ref, 20, until=lambda: all(a.has_gradients() for a in ref))
        want = _collect(ref)
    finally:
        close_all(ref_b, ref)
    broker, accs = make_cohort(grab_port(), 3, kinds=["jax", "port", "port"],
                               broker_kind=broker_kind)
    try:
        assert pump(broker, accs, 30, until=lambda: all(a.connected() for a in accs))
        done = threading.Event()
        pumper = threading.Thread(target=lambda: pump(broker, accs, 30, until=done.is_set),
                                  daemon=True)
        pumper.start()
        try:
            accs[0].reduce_gradients(4, trees[0])  # the JAX peer: barrier
            _reduce_streaming(accs[1:], trees[1:])
            assert pump(broker, accs, 20, until=lambda: all(a.has_gradients() for a in accs))
        finally:
            done.set()
            pumper.join(5)
        got = _collect(accs)
        assert all(len(a._last_launch_leads) >= 2 for a in accs[1:])
        for tree in got:
            for k in ("w", "b"):
                assert tree[k].tobytes() == want[0][k].tobytes()
    finally:
        close_all(broker, accs)
