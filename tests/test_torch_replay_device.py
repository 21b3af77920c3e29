"""The port's device-resident replay shard against the JAX package's and the
numpy reference, both on the CPU.

Tolerances: trees and indices are compared bitwise.  The priority
transform ``max(p, 1e-6)**alpha`` and the importance weights
``(N * P)**-beta / max`` go through a ``pow`` whose last ulp differs between
XLA and torch: the transform is held within 1 ulp of the JAX shard's, the
weights within 2 ulps (the pow's ulp plus the normalizing division by a
maximum that carries one of its own).  Trees are bitwise across packages
given the same transformed leaves: at ``alpha=1`` (a pow both libraries
compute exactly) the two shards' trees are equal, and at the default alpha
the JAX shard's leaf level rebuilt by the port's sum-tree equals the JAX
tree.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from moolib_tpu.replay import DeviceReplayShard as JaxShard
from moolib_tpu_torch import Rpc
from moolib_tpu_torch.replay import (DeviceReplayShard, DeviceSumTree, ReplayShardService,
                                     SumTree)
from moolib_tpu_torch.replay.device import _draw

torch.set_num_threads(1)


def _shard(capacity, **kw):
    return DeviceReplayShard(capacity, device="cpu", **kw)


def _ulps(a, b) -> int:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.max(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32))))


def _tf(shard):
    def tf(p):
        return shard.priority_transform(np.asarray(p, np.float32)).numpy()

    return tf


def test_device_sumtree_bitexact_set_and_sample():
    """Same leaf writes, f32 -> the in-place level rebuild gives the tree the
    reference's touched-path walk does, and the lockstep descent picks the
    same leaves for the same targets."""
    dev = DeviceSumTree(64, device="cpu")
    ref = SumTree(64, dtype=np.float32)
    rng = np.random.default_rng(3)
    for _ in range(50):
        idx = rng.choice(64, size=8, replace=False)
        vals = (rng.random(8) * 5).astype(np.float32)
        dev.set(idx, vals)
        ref.set(idx, vals)
        assert np.array_equal(dev.tree.numpy(), ref.tree)
    targets = (rng.random(500) * ref.total()).astype(np.float32)
    assert np.array_equal(dev.sample(targets).numpy(), ref.sample(targets))
    assert dev.total().item() == ref.total()


def _schedule(shards, rng, ops=500, on_op=None):
    """The reference's seeded add/update/sample schedule, applied to every
    store in ``shards`` (port shards, JAX shards, or numpy SumTree refs
    given as (SumTree, transform))."""
    for op in range(ops):
        kind = op % 5
        if kind in (0, 1):
            items = [{"x": rng.normal(size=6).astype(np.float32)} for _ in range(8)]
            prios = (rng.random(8) * 4).astype(np.float32)
            idxs = None
            for s in shards:
                if isinstance(s, tuple):
                    s[0].set(np.asarray(idxs), s[1](prios))
                else:
                    got = s.add(items, prios)
                    assert idxs is None or got == idxs
                    idxs = got
        elif kind == 2 and len(shards[0]) >= 16:
            idxs = rng.choice(len(shards[0]), size=16, replace=False)
            prios = (rng.random(16) * 3).astype(np.float32)
            for s in shards:
                if isinstance(s, tuple):
                    s[0].set(idxs, s[1](prios))
                else:
                    s.update_priorities(idxs.astype(np.int32), prios)
        elif len(shards[0]) > 0:
            for s in shards:
                if not isinstance(s, tuple):
                    s.sample(16)  # draws must not perturb the tree
        if on_op is not None:
            on_op(op)


@pytest.mark.parametrize("alpha", [1.0, 0.6])
def test_500_op_schedule_against_jax_and_numpy(alpha):
    """The 500-op schedule on the port shard, the JAX shard and the numpy
    reference fed the port shard's own transform: the port tree bitwise
    equal to the reference at every 25th op; across packages the tree
    bitwise given the same transformed leaves, the transform within 1 ulp."""
    port = _shard(128, alpha=alpha, seed=11)
    jx = JaxShard(128, alpha=alpha, seed=11, name="t_port_sched")
    ref = SumTree(128, dtype=np.float32)

    def check(op):
        if op % 25 == 0:
            assert np.array_equal(port.tree.numpy(), ref.tree), op

    _schedule([port, jx, (ref, _tf(port))], np.random.default_rng(11), on_op=check)
    assert np.array_equal(port.tree.numpy(), ref.tree)
    assert port.total_host() == ref.total()
    assert np.array_equal(port.leaf_priorities().numpy(), ref.tree[ref.capacity:][:128])
    jtree = np.asarray(jx.tree)
    if alpha == 1.0:
        assert np.array_equal(port.tree.numpy(), jtree)
    else:
        p = (np.random.default_rng(0).random(4096) * 5).astype(np.float32)
        assert _ulps(port.priority_transform(p).numpy(), jx.priority_transform(p)) <= 1
    rebuilt = DeviceSumTree(128, device="cpu")
    rebuilt.set(np.arange(128), jtree[128:])
    assert np.array_equal(rebuilt.tree.numpy(), jtree)


def test_shard_default_priority_path_bitexact():
    """Adds without explicit priorities fill with the running max RAW
    priority — the reference store's rule, exactly."""
    shard = _shard(32, seed=0)
    ref = SumTree(32, dtype=np.float32)
    tf = _tf(shard)
    idxs = shard.add([{"x": np.float32(i)} for i in range(4)])
    ref.set(np.asarray(idxs), tf(np.full(4, 1.0, np.float32)))
    shard.update_priorities(np.arange(4, dtype=np.int32), np.full(4, 7.0, np.float32))
    ref.set(np.arange(4), tf(np.full(4, 7.0, np.float32)))
    idxs = shard.add([{"x": np.float32(i)} for i in range(4, 8)])
    ref.set(np.asarray(idxs), tf(np.full(4, 7.0, np.float32)))
    assert np.array_equal(shard.tree.numpy(), ref.tree)
    # The JAX shard at alpha=1 lands on the same tree by the same rule.
    port, jx = _shard(32, alpha=1.0), JaxShard(32, alpha=1.0, name="t_port_default")
    for s in (port, jx):
        s.add([{"x": np.float32(i)} for i in range(4)])
        s.update_priorities(np.arange(4, dtype=np.int32), np.full(4, 7.0, np.float32))
        s.add([{"x": np.float32(i)} for i in range(4)])
    assert np.array_equal(port.tree.numpy(), np.asarray(jx.tree))


@pytest.mark.parametrize("size_override,total_override", [(0, 0.0), (4096, 512.0),
                                                          (300, 77.7)])
def test_sample_matches_jax_given_its_uniforms(size_override, total_override):
    """The same tree and the uniforms the JAX shard drew (``fold_in`` of its
    key on the draw count): the port's draw returns the JAX indices exactly
    and its weights within 2 ulps, never outside the local ring."""
    port = _shard(128, alpha=1.0, seed=3)
    jx = JaxShard(128, alpha=1.0, seed=3, name="t_port_draw")
    rng = np.random.default_rng(0)
    for _ in range(10):
        items = [{"x": rng.normal(size=3).astype(np.float32)} for _ in range(8)]
        prios = (rng.random(8) * 4).astype(np.float32)
        port.add(items, prios)
        jx.add(items, prios)
    assert np.array_equal(port.tree.numpy(), np.asarray(jx.tree))
    for _ in range(5):
        key = jax.random.fold_in(jx._base_key, jx._draws)
        u = np.array(jax.random.uniform(key, (64,), jnp.float32))
        _, jidx, jw = jx.sample(64, size_override=size_override, total_override=total_override)
        idx, w = _draw(torch.from_numpy(u), port.tree, 128, len(port), size_override,
                       total_override, port.beta)
        assert idx.dtype == torch.int64
        assert np.array_equal(idx.numpy(), np.asarray(jidx))
        assert _ulps(w.numpy(), jw) <= 2
        assert ((idx >= 0) & (idx < len(port))).all()


def test_draws_depend_only_on_seed_and_draw_count():
    """The seeding contract: two shards with one seed and one history draw
    the same batches; the next draw of the same shard differs."""
    a, b = _shard(64, seed=5), _shard(64, seed=5)
    items = [{"x": np.float32(i)} for i in range(32)]
    prios = np.linspace(0.1, 3, 32).astype(np.float32)
    for s in (a, b):
        s.add(items, prios)
    first, again = a.sample(16), b.sample(16)
    assert torch.equal(first[1], again[1]) and torch.equal(first[2], again[2])
    assert not torch.equal(first[1], a.sample(16)[1])  # draw 1 is not draw 0
    c = _shard(64, seed=6)
    c.add(items, prios)
    assert not torch.equal(first[1], c.sample(16)[1])


def test_cohort_overrides_never_sample_outside_local_ring():
    """The cohort-wide N only rescales importance weights: indices clip
    against the LOCAL occupancy."""
    shard = _shard(16, seed=3)
    shard.add([{"x": np.float32(i)} for i in range(6)], np.ones(6, np.float32))
    for _ in range(10):
        _, idx, w = shard.sample(8, size_override=4096, total_override=512.0)
        assert ((0 <= idx) & (idx < 6)).all()
        assert w.max().item() == pytest.approx(1.0)
        assert w.min().item() == pytest.approx(1.0)


def test_update_priorities_duplicate_indices_last_wins_bitexact():
    """Stratified draws return duplicate indices routinely; the write-back
    resolves them last-wins, like the reference's ``tree[pos] = value`` and
    the JAX shard's ``dup_later`` mask.  int32 (a JAX peer's) and int64
    indices both pass."""
    for dtype in (np.int32, np.int64):
        shard = _shard(32, seed=9)
        jx = JaxShard(32, alpha=1.0, name="t_port_dup")
        port1 = _shard(32, alpha=1.0)
        ref = SumTree(32, dtype=np.float32)
        tf = _tf(shard)
        prios0 = np.ones(8, np.float32)
        items = [{"x": np.float32(i)} for i in range(8)]
        idxs = shard.add(items, prios0)
        jx.add(items, prios0)
        port1.add(items, prios0)
        ref.set(np.asarray(idxs), tf(prios0))
        dup = np.asarray([3, 5, 3, 3, 7, 5, 0, 3], dtype)
        prios = np.asarray([0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8], np.float32)
        shard.update_priorities(dup, prios)
        ref.set(dup, tf(prios))
        assert np.array_equal(shard.tree.numpy(), ref.tree)
        assert shard.leaf_priorities()[3].item() == tf(prios)[7]
        jx.update_priorities(dup.astype(np.int32), prios)
        port1.update_priorities(torch.from_numpy(dup), torch.from_numpy(prios))
        assert np.array_equal(port1.tree.numpy(), np.asarray(jx.tree))


def test_width_growth_is_an_error():
    shard = _shard(16)
    shard.add([{"x": np.float32(0)}, {"x": np.float32(1)}])
    with pytest.raises(ValueError, match="insert width grew"):
        shard.add([{"x": np.float32(i)} for i in range(3)])
    shard.update_priorities(np.asarray([0, 1]), np.ones(2, np.float32))
    with pytest.raises(ValueError, match="priority-update width grew"):
        shard.update_priorities(np.asarray([0, 1, 0]), np.ones(3, np.float32))
    with pytest.raises(IndexError, match="out of range"):
        shard.update_priorities(np.asarray([16]), np.ones(1, np.float32))


def test_short_batch_writes_only_its_lanes():
    """A batch shorter than the latched width writes its n rows and leaves:
    nothing past them (the reference pads and drops the padding)."""
    shard = _shard(16, alpha=1.0)
    shard.add([{"x": np.full(2, 1.0, np.float32)} for _ in range(8)], np.full(8, 2.0, np.float32))
    shard.add([{"x": np.full(2, 5.0, np.float32)} for _ in range(3)], np.full(3, 4.0, np.float32))
    ring = shard._ring[0]
    assert torch.equal(ring[8:11], torch.full((3, 2), 5.0))
    assert torch.equal(ring[11:], torch.zeros(5, 2))
    leaves = shard.leaf_priorities().numpy()
    assert np.array_equal(leaves, np.r_[np.full(8, 2.0), np.full(3, 4.0), np.zeros(5)])
    assert len(shard) == 11


def test_drain_splits_stripes_wider_than_latched_width():
    """drain() splits stripes wider than the latched width into
    latched-width chunks, priorities sliced in lockstep."""
    r = Rpc()
    try:
        shard = _shard(64, alpha=1.0)
        svc = ReplayShardService(r, "replay_split", shard)
        svc._on_ingest([{"x": np.float32(i)} for i in range(4)], np.full(4, 2.0, np.float32))
        assert svc.drain() == 4
        assert shard.insert_width == 4
        svc._on_ingest([{"x": np.float32(10 + i)} for i in range(11)],
                       (np.arange(11) + 1.0).astype(np.float32))
        svc._on_ingest([{"x": np.float32(30)}], np.full(1, 5.0, np.float32))
        assert svc.drain() == 12
        assert len(shard) == 16
        leaves = shard.leaf_priorities().numpy()[:16]
        expect = np.concatenate([np.full(4, 2.0), np.arange(11) + 1.0, [5.0]]).astype(np.float32)
        assert np.array_equal(leaves, expect)
        ring = shard._ring[0].numpy()[:16]
        assert np.array_equal(ring, np.r_[np.arange(4), 10 + np.arange(11), 30].astype(np.float32))
    finally:
        r.close()


def test_storage_stays_in_place_over_500_ops():
    """torch has no donation: the tree, the ring leaves and the running max
    are written in place, so no data_ptr() moves over the schedule (the
    JAX package's compiles-exactly-once contract, in torch's terms)."""
    shard = _shard(64, seed=0)
    rng = np.random.default_rng(0)
    ptrs = None
    for i in range(500):
        n = 8 if i % 3 == 0 else 5
        items = [{"x": rng.normal(size=4).astype(np.float32), "c": (np.zeros(2, np.float32),)}
                 for _ in range(n)]
        shard.add(items, (rng.random(n) + 0.1).astype(np.float32))
        if ptrs is None:
            ptrs = [shard.tree.data_ptr(), shard._maxp.data_ptr()] + [
                t.data_ptr() for t in shard._ring]
        if len(shard) >= 16 and i % 2:
            batch, idx, w = shard.sample(16)
            assert batch["c"][0].shape == (16, 2)
            shard.update_priorities(idx, w + 0.5)
    assert ptrs == [shard.tree.data_ptr(), shard._maxp.data_ptr()] + [
        t.data_ptr() for t in shard._ring]
    assert len(shard) == 64 and shard.tree.shape == (128,)
    assert shard.ring_bytes() == 64 * (4 + 2) * 4


def test_in_place_insert_sample_roundtrip():
    """Insert -> sample -> update in a tight loop over the in-place buffers
    keeps serving correct contents."""
    shard = _shard(32, seed=2)
    for i in range(8):
        shard.add([{"v": np.full(3, 4 * i + j, np.float32)} for j in range(4)],
                  np.full(4, 1e-6, np.float32))
    shard.update_priorities(np.asarray([13], np.int32), np.asarray([1e6], np.float32))
    batch, idx, w = shard.sample(8)
    assert (idx == 13).all()
    assert torch.equal(batch["v"], torch.full((8, 3), 13.0))
    assert w.max().item() == pytest.approx(1.0)
    assert shard.total_host() == pytest.approx(1e6**0.6, rel=0.01)


def test_local_cohort_weights_use_global_correction():
    """With an inflated cohort total the weights are relabeled to the global
    distribution; the heavy slot gets the smallest weight in both draws."""
    shard = _shard(16, alpha=1.0, beta=1.0, seed=0)
    shard.add([{"x": np.float32(i)} for i in range(8)],
              np.asarray([1, 1, 1, 1, 1, 1, 1, 9], np.float32))
    for kw in ({}, {"size_override": 32, "total_override": 64.0}):
        _, idx, w = shard.sample(8, **kw)
        assert w.max().item() == pytest.approx(1.0)
        if (idx == 7).any() and (idx != 7).any():
            assert w[idx == 7].max() < w[idx != 7].min()


def test_concurrent_add_sample_update_is_serialized():
    """Add, sample and the priority write-back hammered from three threads:
    no errors, and a root that equals its leaf sum.  Bounded by progress,
    not a clock: it runs until the ring holds 64 items and each sampler has
    done 20 rounds, under a 30 s deadline.  The reference's version stops
    after a fixed 0.5 s, a window its first compiles can fill on a loaded
    machine (it then fails with a ring of 32, not 64); progress is what the
    assertions need."""
    shard = _shard(64, seed=4)
    shard.add([{"x": np.zeros(4, np.float32)} for _ in range(8)], np.ones(8, np.float32))
    errs, rounds = [], [0, 0]
    stop = threading.Event()

    def adder():
        rng = np.random.default_rng(4)
        try:
            while not stop.is_set():
                shard.add([{"x": np.zeros(4, np.float32)} for _ in range(8)],
                          (rng.random(8) + 0.1).astype(np.float32))
        except Exception as e:  # noqa: BLE001 - the assertion payload
            errs.append(e)

    def sampler(k):
        try:
            while not stop.is_set():
                _, idx, w = shard.sample(8)
                shard.update_priorities(idx, w + 0.5)
                shard.total_host()
                rounds[k] += 1
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=adder)] + [
        threading.Thread(target=sampler, args=(k,)) for k in range(2)]
    deadline = time.time() + 30
    for t in threads:
        t.start()
    try:
        while not errs and time.time() < deadline and not (
                len(shard) == 64 and min(rounds) >= 20):
            time.sleep(0.01)
    finally:
        stop.set()
        for t in threads:
            t.join(10)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    assert len(shard) == 64 and min(rounds) >= 20, (len(shard), rounds)
    leaves = shard.leaf_priorities().numpy().astype(np.float64)
    assert shard.total_host() == pytest.approx(float(leaves.sum()), rel=1e-4)


def test_device_shard_runs_on_cuda_unless_the_cpu_is_asked():
    from moolib_tpu_torch._device import NoCudaError

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the no-CUDA behaviour cannot show")
    for make in (lambda: DeviceReplayShard(8), lambda: DeviceSumTree(8)):
        with pytest.raises(NoCudaError):
            make()
    assert _shard(8).tree.device == torch.device("cpu")
