"""Port of ``tests/test_buckets.py`` to ``moolib_tpu_torch`` (the
Accumulator cases wait for the Accumulator), plus the port's card seam:
``BucketLayout.fill``, ``lease(pinned=True)``, ``stage`` and
``GradientStream`` with torch tensors and a fake CUDA event.

Flat-bucket gradient data plane (docs/DESIGN.md "Gradient data plane").

Covers the contracts:
- zero payload-byte copies through serialize -> pack -> unpack ->
  deserialize(borrow=True) (buffer identity via ``memoryview.obj``);
- bucket-layout determinism (same treedef/shapes/dtype => identical layout,
  the cross-process golden);
- bit-exactness of the f32 bucketed allreduce vs a numpy reference and vs
  the legacy per-leaf tree path;
- EF-q8 on the flat buffer: quantize-once semantics, residual carry,
  non-finite reset;
- the refcount-guarded buffer pool;
- rpc inline handlers (borrowed views) and memfd-multicast broadcast.
"""

import socket
import time

import numpy as np
import pytest

from moolib_tpu_torch import Broker, Group, Rpc, buckets
from moolib_tpu_torch.rpc import serialization


# --------------------------------------------------------------- zero copy
def test_borrow_deserialize_zero_payload_copies():
    """serialize->pack->unpack->deserialize(borrow=True) must not copy a
    single payload byte: every array leaf is a view whose backing buffer IS
    the packed wire blob (asserted via the memoryview.obj chain)."""
    payload = {
        "b": np.arange(4096, dtype=np.float32),
        "nested": [np.ones((16, 16), np.float64), {"k": np.arange(7, dtype=np.int32)}],
        "m": {"num_gradients": 3},
    }
    sp = serialization._py_serialize(payload)  # force the portable codec
    buf = serialization.pack_bytes(sp)
    out = serialization.deserialize(serialization.unpack(buf), borrow=True)
    flat_buf = np.frombuffer(buf, np.uint8)
    leaves = [out["b"], out["nested"][0], out["nested"][1]["k"]]
    for leaf in leaves:
        assert not leaf.flags.owndata
        assert not leaf.flags.writeable  # borrowed views are read-only
        assert np.shares_memory(leaf, flat_buf)
        # Buffer identity: the view's memory chain bottoms out at `buf`.
        mv = leaf.base
        while isinstance(mv, np.ndarray):
            mv = mv.base
        assert isinstance(mv, memoryview) and mv.obj is buf
    np.testing.assert_array_equal(out["b"], payload["b"])
    # The copying default stays for user-facing RPC.
    owned = serialization.deserialize(serialization.unpack(buf))
    assert owned["b"].flags.owndata and owned["b"].flags.writeable


def test_borrow_deserialize_native_codec():
    if not serialization.native_available():
        pytest.skip("native codec unavailable")
    payload = {"b": np.arange(100_000, dtype=np.float32)}
    sp = serialization.serialize(payload)
    buf = serialization.pack_bytes(sp)
    out = serialization.loads(buf, borrow=True)
    assert not out["b"].flags.owndata
    assert np.shares_memory(out["b"], np.frombuffer(buf, np.uint8))
    np.testing.assert_array_equal(out["b"], payload["b"])
    owned = serialization.loads(buf)
    assert owned["b"].flags.owndata


# ------------------------------------------------------------------ layout
def test_bucket_layout_golden():
    """Same shapes/dtype/bucket size => identical layout on any process:
    the layout is wire protocol (each bucket is its own allreduce op)."""
    shapes = [(512, 256), (256,), (1024, 64), (3,)]
    a = buckets.BucketLayout(shapes, np.float32, bucket_bytes_=1 << 20)
    b = buckets.BucketLayout(list(shapes), "float32", bucket_bytes_=1 << 20)
    assert a.signature() == b.signature()
    # Golden values: 512*256 + 256 + 1024*64 + 3 = 196867 elems; 1 MiB of
    # f32 = 262144 elems per bucket => one bucket.
    assert a.total == 196867
    assert a.bucket_elems == 262144
    assert a.n_buckets == 1
    c = buckets.BucketLayout(shapes, np.float32, bucket_bytes_=1 << 18)
    assert c.bucket_elems == 65536
    assert c.n_buckets == 4  # ceil(196867 / 65536)
    assert c.bounds[0] == (0, 65536)
    assert c.bounds[3] == (3 * 65536, 196867)
    # fill + unflatten round-trips leaves bit-exactly through the flat.
    rng = np.random.default_rng(0)
    leaves = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    flat = np.empty(c.total, np.float32)
    c.fill(flat, leaves)
    for orig, view in zip(leaves, c.unflatten(flat)):
        np.testing.assert_array_equal(orig, view)


# ------------------------------------------------------------------- pool
def test_pool_refcount_guard():
    arr = buckets.lease(1000, np.float32)
    buckets.release(arr)
    view = None
    # An aliased buffer must never be handed out again while the alias lives.
    with buckets._pool_lock:
        pass
    held = arr[10:20]  # alias
    del arr
    again = buckets.lease(1000, np.float32)
    assert not np.shares_memory(again, held)
    del held, view
    addr = again.__array_interface__["data"][0]
    buckets.release(again)
    del again  # the freelist must hold the ONLY reference to recycle
    reused = buckets.lease(1000, np.float32)
    assert reused.__array_interface__["data"][0] == addr  # recycled
    buckets.release(reused)


# ------------------------------------------------------------------- EF-q8
def test_ef_quantize_flat_once_with_residual():
    rng = np.random.default_rng(3)
    g = rng.standard_normal(4096).astype(np.float32)
    layout = buckets.BucketLayout([(4096,)], np.float32, bucket_bytes_=1 << 12)
    assert layout.n_buckets == 4
    flat = g.copy()
    res = buckets.ef_quantize_flat(flat, None, layout.bounds)
    # Grid values: exact multiples of each bucket's scale; <1% rel error.
    np.testing.assert_allclose(flat, g, atol=np.abs(g).max() / 100)
    np.testing.assert_allclose(res, g - flat, atol=1e-6)
    # Quantize-once: re-encoding the grid values with a fresh per-bucket
    # absmax scale reproduces the identical int8 payload (what the wire
    # codec does per hop), so quantization noise enters exactly once.
    for s, e in layout.bounds:
        scale = float(np.max(np.abs(flat[s:e]))) / 127.0
        q = np.round(flat[s:e] / scale).astype(np.int8)
        np.testing.assert_array_equal(q.astype(np.float32) * np.float32(scale), flat[s:e])
    # Error feedback: two rounds average closer than round one alone.
    flat2 = g.copy()
    res2 = buckets.ef_quantize_flat(flat2, res, layout.bounds)
    err1 = np.abs(flat - g).mean()
    err2 = np.abs((flat + flat2) / 2 - g).mean()
    assert err2 < err1 * 0.75, (err1, err2)
    assert res2.shape == g.shape
    # Non-finite bucket: zero contribution, residual reset.
    bad = g.copy()
    bad[0] = np.nan
    resb = buckets.ef_quantize_flat(bad, None, layout.bounds)
    s, e = layout.bounds[0]
    assert (bad[s:e] == 0).all() and (resb[s:e] == 0).all()
    assert (bad[e:] != 0).any()  # other buckets unaffected


# ------------------------------------------------------- cohort helpers
def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _Cohort:
    def __init__(self, n):
        addr = f"127.0.0.1:{_free_port()}"
        self.broker = Broker()
        self.broker.set_name("broker")
        self.broker.listen(addr)
        self.peers = []
        for i in range(n):
            rpc = Rpc()
            rpc.set_name(f"p{i}")
            rpc.listen(":0")
            rpc.connect(addr)
            g = Group(rpc, "g")
            g.set_timeout(30)
            self.peers.append((rpc, g))
        self.groups = [g for _, g in self.peers]
        deadline = time.time() + 60
        while time.time() < deadline:
            self.pump()
            if all(g.active() and len(g.members()) == n for g in self.groups):
                return
            time.sleep(0.01)
        raise AssertionError("cohort never converged")

    def pump(self):
        self.broker.update()
        for g in self.groups:
            g.update()

    def wait(self, futs, bound=30):
        t0 = time.time()
        while not all(f.done() for f in futs):
            self.pump()
            time.sleep(0.002)
            assert time.time() - t0 < bound, "allreduce hung"

    def close(self):
        for rpc, _ in self.peers:
            rpc.close()
        self.broker.close()


# ------------------------------------------------------------ bit-exactness
def test_bucketed_tree_bit_exact_vs_numpy_and_legacy():
    """f32 bucketed allreduce: bit-exact vs a numpy reference sum on
    exactly-representable values (order-independent), bit-identical across
    peers on random values, and bit-identical to the legacy tree path."""
    c = _Cohort(4)
    try:
        rng = np.random.default_rng(11)
        ints = [rng.integers(-1000, 1000, 300_000).astype(np.float32)
                for _ in c.groups]
        ref = np.sum(np.stack(ints), axis=0, dtype=np.float64).astype(np.float32)
        futs = [g.all_reduce("bx", d, bucketed=True) for g, d in zip(c.groups, ints)]
        c.wait(futs)
        for f in futs:
            np.testing.assert_array_equal(np.asarray(f.result(0)), ref)
        futs = [g.all_reduce("lx", d, bucketed=False, chunked=False)
                for g, d in zip(c.groups, ints)]
        c.wait(futs)
        for f in futs:
            np.testing.assert_array_equal(np.asarray(f.result(0)), ref)
        # Random payload: all peers must decode the exact same result bytes.
        rnd = [rng.standard_normal(2_000_000).astype(np.float32) for _ in c.groups]
        futs = [g.all_reduce("rx", d) for g, d in zip(c.groups, rnd)]  # auto path
        c.wait(futs)
        outs = [np.asarray(f.result(0)) for f in futs]
        for o in outs[1:]:
            assert o.tobytes() == outs[0].tobytes()
        np.testing.assert_allclose(outs[0], sum(rnd), rtol=1e-5, atol=1e-5)
    finally:
        c.close()


def test_bucketed_multi_bucket_pytree_meta_skip():
    """Multiple buckets + pytree payload + meta + a skip contribution."""
    buckets.set_bucket_bytes(1 << 14)  # 4096 f32 elems per bucket
    try:
        c = _Cohort(3)
        try:
            rng = np.random.default_rng(5)
            trees = [
                {"w": rng.integers(-50, 50, (100, 180)).astype(np.float32),
                 "b": rng.integers(-50, 50, 37).astype(np.float32)}
                for _ in range(2)
            ]
            meta_op = lambda a, b: {"n": a["n"] + b["n"]}  # noqa: E731
            tmpl = {"w": np.zeros((100, 180), np.float32), "b": np.zeros(37, np.float32)}
            futs = []
            for i, g in enumerate(c.groups):
                if i == 2:
                    futs.append(g.all_reduce(
                        "mb", None, bucketed=True, meta={"n": 1}, meta_op=meta_op,
                        template=tmpl))
                else:
                    futs.append(g.all_reduce(
                        "mb", trees[i], bucketed=True, meta={"n": 1}, meta_op=meta_op))
            c.wait(futs)
            exp_w = trees[0]["w"] + trees[1]["w"]
            for f in futs:
                v, m = f.result(0)
                assert m == {"n": 3}
                np.testing.assert_array_equal(v["w"], exp_w)
                np.testing.assert_array_equal(v["b"], trees[0]["b"] + trees[1]["b"])
        finally:
            c.close()
    finally:
        buckets.set_bucket_bytes(buckets._DEFAULT_BUCKET_BYTES)


def test_ring_chunk_align_on_bucket_boundaries():
    c = _Cohort(4)
    try:
        rng = np.random.default_rng(9)
        data = [rng.integers(-100, 100, 70_000).astype(np.float32) for _ in c.groups]
        ref = np.sum(np.stack(data), axis=0, dtype=np.float64).astype(np.float32)
        futs = [g.all_reduce("ra", d, chunked=True, chunk_align=16384)
                for g, d in zip(c.groups, data)]
        c.wait(futs)
        for f in futs:
            np.testing.assert_array_equal(np.asarray(f.result(0)), ref)
        # Alignment larger than total/n: clamped to the even split's
        # granularity (no empty chunks), boundaries still cohort-identical.
        futs = [g.all_reduce("rb", d, chunked=True, chunk_align=65536)
                for g, d in zip(c.groups, data)]
        c.wait(futs)
        for f in futs:
            np.testing.assert_array_equal(np.asarray(f.result(0)), ref)
    finally:
        c.close()


# ---------------------------------------------------------- rpc primitives
def test_inline_handler_gets_borrowed_views():
    """define(..., inline=True): the handler runs with zero-copy views and
    its return value round-trips like a normal call."""
    a, b = Rpc(), Rpc()
    try:
        seen = {}

        def handler(arr):
            seen["owndata"] = arr.flags.owndata
            seen["writeable"] = arr.flags.writeable
            return float(arr.sum())

        a.set_name("a")
        b.set_name("srv")
        b.define("probe", handler, inline=True)
        b.listen(":0")
        addr = next(x for x in b._listen_addrs if x.startswith("ipc://"))
        a.connect(addr)
        payload = np.ones(200_000, np.float32)  # big enough to stay a view
        out = a.sync("srv", "probe", payload)
        assert out == 200_000.0
        assert seen["owndata"] is False  # borrowed, not copied
    finally:
        a.close()
        b.close()


def test_async_broadcast_multicast():
    """async_broadcast: one rid fans out to several peers (memfd multicast
    when same-host ipc is up), future resolves when all respond."""
    hub = Rpc()
    spokes = []
    try:
        hub.set_name("hub")
        hub.listen(":0")
        hits = []
        for i in range(3):
            r = Rpc()
            r.set_name(f"s{i}")
            r.define("take", lambda arr, i=i: hits.append((i, float(arr[0]))))
            r.listen(":0")
            addr = next(x for x in r._listen_addrs if x.startswith("ipc://"))
            hub.connect(addr)
            spokes.append(r)
        deadline = time.time() + 20
        names = [f"s{i}" for i in range(3)]
        while time.time() < deadline and not all(
            n in hub._peers and hub._peers[n].connections for n in names
        ):
            time.sleep(0.02)
        payload = np.full(600_000, 7.0, np.float32)  # > memfd threshold
        fut = hub.async_broadcast(names, "take", payload)
        fut.result(20)
        assert sorted(i for i, _ in hits) == [0, 1, 2]
        assert all(v == 7.0 for _, v in hits)
        assert hub.multicast_ready(names) in (True, False)  # probe is callable
    finally:
        hub.close()
        for r in spokes:
            r.close()


# ------------------------------------------------------- path disagreement
def test_bucketed_vs_legacy_mismatch_errors_loudly():
    """Peers disagreeing on the allreduce path (bucketed vs legacy tree)
    must fail with a loud RpcError well before the op timeout — the same
    contract the ring/tree mismatch already has — in both directions:
    a legacy frame reaching a bucketed round's parent-key sentinel, and a
    parked bucketed bucket-0 frame discovered when a legacy op starts."""
    from moolib_tpu_torch import RpcError

    c = _Cohort(2)
    try:
        for g in c.groups:
            g.set_timeout(60)  # loud detection must beat this by far
        d = np.ones(300_000, np.float32)

        # Legacy contribution arrives at the bucketed root's parent key.
        f0 = c.groups[0].all_reduce("mm", d, bucketed=True)
        c.groups[1].all_reduce("mm", d, bucketed=False, chunked=False)
        t0 = time.time()
        while not f0.done():
            c.pump()
            time.sleep(0.002)
            assert time.time() - t0 < 20, "mismatch not detected loudly"
        with pytest.raises(RpcError, match="disagree"):
            f0.result(0)

        # Bucketed child frame parks at the legacy root before its op starts.
        c.groups[1].all_reduce("mm2", d, bucketed=True)
        t0 = time.time()
        while time.time() - t0 < 2:  # let the bucket-0 frame land and park
            c.pump()
            time.sleep(0.002)
        f0 = c.groups[0].all_reduce("mm2", d, bucketed=False, chunked=False)
        t0 = time.time()
        while not f0.done():
            c.pump()
            time.sleep(0.002)
            assert time.time() - t0 < 20, "parked-frame mismatch not detected"
        with pytest.raises(RpcError, match="disagree"):
            f0.result(0)
    finally:
        c.close()


# ------------------------------------------------------------ card seam
class _FakeEvent:
    """torch.cuda.Event for the CPU: counts records and waits."""

    log = []

    def __init__(self, *a, **k):
        self.recorded = self.waited = False

    def record(self, stream=None):
        self.recorded = True
        _FakeEvent.log.append(("record", self))

    def synchronize(self):
        assert self.recorded, "waited on an event that was never recorded"
        self.waited = True
        _FakeEvent.log.append(("wait", self))


@pytest.fixture
def fake_card(monkeypatch):
    """Every torch tensor reads as a CUDA leaf; pinned memory is plain host
    memory and events are _FakeEvent.  Returns the log of copy_ calls (the
    staging copies) and events."""
    import torch

    copies = []
    orig_copy = torch.Tensor.copy_

    def spy_copy(self, src, non_blocking=False):
        copies.append(non_blocking)
        return orig_copy(self, src, non_blocking=non_blocking)

    _FakeEvent.log = []
    monkeypatch.setattr(buckets, "on_card", lambda x: isinstance(x, torch.Tensor))
    monkeypatch.setattr(buckets, "_pinned_empty",
                        lambda n, dtype: torch.empty(int(n), dtype=dtype))
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(torch.Tensor, "copy_", spy_copy)

    def no_sync_copy(*a, **k):
        raise AssertionError("synchronous .cpu() on the staging path")

    monkeypatch.setattr(torch.Tensor, "cpu", no_sync_copy)
    return copies, _FakeEvent.log


def test_np_dtype_and_host_view():
    import torch

    assert buckets.np_dtype(torch.float32) == np.float32
    assert buckets.np_dtype(torch.int8) == np.int8
    assert buckets.np_dtype("float16") == np.float16
    with pytest.raises(TypeError):
        buckets.np_dtype(torch.bfloat16)
    t = torch.arange(6, dtype=torch.float32)
    v = buckets.host_view(t)
    assert isinstance(v, np.ndarray) and np.shares_memory(v, t.numpy())
    assert not buckets.on_card(t)


def test_fill_stages_card_leaves_with_one_event(fake_card):
    """fill: one non-blocking copy_ per CUDA leaf into its slice of the flat
    buffer, one event per fill, host leaves copied by numpy."""
    import torch

    copies, log = fake_card
    rng = np.random.default_rng(3)
    leaves = [torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32)),
              rng.standard_normal(11).astype(np.float32),
              torch.from_numpy(rng.standard_normal(4).astype(np.float64))]
    layout = buckets.BucketLayout([(5, 7), (11,), (4,)], np.float32, 64)
    flat = buckets.lease(layout.total, np.float32, pinned=True)
    event = layout.fill(flat, leaves)
    assert isinstance(event, _FakeEvent) and event.recorded
    assert [e for e, _ in log] == ["record"]
    assert copies == [True, True]
    want = np.concatenate([np.asarray(leaves[0]).ravel(), leaves[1],
                           np.asarray(leaves[2], np.float32)])
    np.testing.assert_array_equal(flat, want)
    # All-host leaves: no event, nothing to wait on.
    assert layout.fill(flat, [np.asarray(x) for x in leaves]) is None


def test_pinned_lease_recycles_under_refcount_guard(fake_card):
    a = buckets.lease(1000, np.float32, pinned=True)
    assert a.base is not None  # a view of the pinned tensor
    ptr = a.__array_interface__["data"][0]
    view = a[10:20]
    buckets.release(a)
    del a
    b = buckets.lease(1000, np.float32, pinned=True)
    assert b.__array_interface__["data"][0] != ptr  # still aliased by `view`
    buckets.release(b)
    del view
    # pageable and pinned buffers never stand in for each other
    c = buckets.lease(1000, np.float32)
    assert c.base is None
    d = buckets.lease(1000, np.float32, pinned=True)
    assert d.base is not None
    # A user's own tensor-backed array is not the pool's to recycle.
    import torch

    mine = torch.zeros(1000).numpy()
    buckets.release(mine)
    assert buckets.lease(1000, np.float32, pinned=True) is not mine


def test_bucketed_allreduce_stages_card_leaves(fake_card):
    """A bucketed round with CUDA leaves stages each peer's payload with one
    fill event, waits on it before the wire reads the buffer, and gives the
    numpy path's exact bytes."""
    import torch

    copies, log = fake_card
    buckets.set_bucket_bytes(1 << 14)
    c = _Cohort(3)
    try:
        rng = np.random.default_rng(8)
        # Integer values: exact sums, so the bytes cannot depend on the
        # order the eager folds meet the children's contributions in.
        trees = [{"w": rng.integers(-500, 500, (90, 70)).astype(np.float32),
                  "b": rng.integers(-500, 500, 33).astype(np.float32)} for _ in c.groups]
        ref = [g.all_reduce("host", t, bucketed=True) for g, t in zip(c.groups, trees)]
        c.wait(ref)
        del log[:]
        card = [{k: torch.from_numpy(v) for k, v in t.items()} for t in trees]
        futs = [g.all_reduce("card", t, bucketed=True) for g, t in zip(c.groups, card)]
        c.wait(futs)
        events = [e for kind, e in log if kind == "record"]
        assert len(events) == 3 and all(e.waited for e in events)
        assert all(copies)
        for f, r in zip(futs, ref):
            got, want = f.result(0), r.result(0)
            for k in want:
                assert isinstance(got[k], np.ndarray)
                assert got[k].tobytes() == want[k].tobytes()
        # The ring and the legacy tree stage the same way.
        for kw in (dict(chunked=True), dict(bucketed=False, chunked=False)):
            del log[:]
            futs = [g.all_reduce("c" + str(kw), t, **kw) for g, t in zip(c.groups, card)]
            c.wait(futs)
            assert [k for k, _ in log].count("record") == 3, kw
            for f in futs:
                np.testing.assert_array_equal(f.result(0)["w"], ref[0].result(0)["w"])
    finally:
        c.close()
        buckets.set_bucket_bytes(buckets._DEFAULT_BUCKET_BYTES)


def test_failed_pinned_allocation_propagates(fake_card, monkeypatch):
    """No synchronous fallback: a failed pinned allocation raises to the
    caller (the fixture's .cpu() trap would fire on any retry)."""
    import torch

    def boom(n, dtype):
        raise RuntimeError("pinned allocation failed")

    monkeypatch.setattr(buckets, "_pinned_empty", boom)
    layout = buckets.BucketLayout([(4,)], np.float32)
    with pytest.raises(RuntimeError, match="pinned allocation failed"):
        buckets.lease(layout.total, np.float32, pinned=True)
    with pytest.raises(RuntimeError, match="pinned allocation failed"):
        buckets.stage([torch.ones(4)])


def test_gradient_stream_stages_and_waits_per_chunk(fake_card):
    """deliver: non-blocking copies of the chunk's CUDA leaves into pinned
    staging, one event per chunk; next_chunk hands out host views only after
    waiting on it.  Host leaves pass through unchanged."""
    import torch

    copies, log = fake_card
    shapes = [(3, 2), (4,), (5,)]
    gs = buckets.GradientStream(None, shapes, [torch.float32, np.float32, "float32"])
    leaves = [torch.arange(6, dtype=torch.float32).reshape(3, 2),
              np.arange(4, dtype=np.float32), torch.full((5,), 2.0)]
    gs.deliver(1, leaves[1:])
    gs.deliver(0, leaves[:1])
    assert [k for k, _ in log] == ["record", "record"] and copies == [True, True]
    lo, got = gs.next_chunk(timeout=1)
    assert lo == 1 and log[-1][0] == "wait"
    assert got[0] is leaves[1]
    assert isinstance(got[1], np.ndarray) and (got[1] == 2.0).all()
    lo, got = gs.next_chunk(timeout=1)
    assert lo == 0 and got[0].shape == (3, 2)
    np.testing.assert_array_equal(got[0], np.arange(6, dtype=np.float32).reshape(3, 2))
    assert gs.next_chunk(timeout=1) is None
    with pytest.raises(ValueError, match="delivered twice"):
        gs.deliver(0, leaves[:1])


def test_gradient_stream_host_leaves_unchanged():
    import torch

    gs = buckets.GradientStream(None, [(2,)], [np.float32])
    t = torch.ones(2)
    gs.deliver(0, [t])
    lo, got = gs.next_chunk(timeout=1)
    assert lo == 0 and got[0] is t


def test_sharded_layouts_take_plain_tensors_only():
    shapes = [(8, 4), (6,)]
    lay = buckets.BucketLayout.from_shardings(None, shapes, [None, None], np.float32, 64)
    plain = buckets.BucketLayout(shapes, np.float32, 64)
    assert lay.bounds == plain.bounds and lay.shard_cuts == ()
    # A sharding is a parallel.NamedSharding or a DTensor; anything else is
    # refused, never guessed at.
    with pytest.raises(TypeError, match="neither a NamedSharding nor a DTensor"):
        buckets.BucketLayout.from_shardings(None, shapes, [object(), None], np.float32)
    with pytest.raises(TypeError, match="neither a NamedSharding nor a DTensor"):
        buckets.sharding_signature((8, 4), object())
    from moolib_tpu_torch.parallel import NamedSharding, PartitionSpec as P

    sh = NamedSharding({"dp": 2}, P("dp"))
    assert buckets.sharding_signature((8, 4), sh) == ("PartitionSpec('dp',)", (2, 1))
    lay = buckets.BucketLayout.from_shardings(None, shapes, [sh, None], np.float32, 64)
    assert lay.shard_cuts == (16,)
