"""The port's host replay store against the JAX package's: the numpy
sum-tree bitwise on one schedule, the prioritized buffer's draws, and the
RPC store (port server and clients of either package).

Both packages' host stores are numpy, so everything here is compared
exactly."""

import numpy as np
import pytest
import torch

import moolib_tpu
from moolib_tpu.replay import ReplayBuffer as JaxBuffer
from moolib_tpu.replay import ReplayClient as JaxClient
from moolib_tpu.replay import SumTree as JaxSumTree
from moolib_tpu_torch import Rpc
from moolib_tpu_torch.replay import (ReplayBuffer, ReplayClient, ReplayServer, SumTree,
                                     payload_bytes)
from moolib_tpu_torch.replay.host import _own_copy

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_sumtree_matches_jax_bitwise(dtype):
    port, ref = SumTree(100, dtype=dtype), JaxSumTree(100, dtype=dtype)
    rng = np.random.default_rng(1)
    for _ in range(300):
        n = int(rng.integers(1, 12))
        idx = rng.integers(0, 100, size=n)
        vals = rng.random(n) * 10
        port.set(idx, vals)
        ref.set(idx, vals)
        assert np.array_equal(port.tree, ref.tree)
    targets = rng.random(1000) * port.total()
    assert np.array_equal(port.sample(targets), ref.sample(targets))
    assert np.array_equal(port.get(np.arange(100)), ref.get(np.arange(100)))


def test_sumtree_total_and_sampling_distribution():
    t = SumTree(8)
    t.set([0, 1, 2, 3], [1.0, 2.0, 3.0, 4.0])
    assert t.total() == pytest.approx(10.0)
    rng = np.random.default_rng(0)
    idxs = t.sample(rng.random(20000) * 10.0)
    counts = np.bincount(idxs, minlength=4)[:4] / 20000
    np.testing.assert_allclose(counts, [0.1, 0.2, 0.3, 0.4], atol=0.02)
    t.set(3, 0.0)
    assert t.total() == pytest.approx(6.0)


def test_replay_buffer_add_sample_update():
    buf = ReplayBuffer(capacity=64, alpha=1.0, beta=1.0, seed=0)
    buf.add([{"obs": np.full((3,), float(i)), "idx": i} for i in range(32)])
    assert len(buf) == 32
    batch, idxs, weights = buf.sample(16)
    assert batch["obs"].shape == (16, 3)
    assert weights.shape == (16,) and weights.max() == pytest.approx(1.0)
    buf.update_priorities(np.arange(32), np.full(32, 1e-6))
    buf.update_priorities(torch.tensor([5]), torch.tensor([1000.0]))  # tensors pass too
    batch, idxs, _ = buf.sample(32)
    assert (idxs == 5).mean() > 0.9


def test_replay_ring_overwrite():
    buf = ReplayBuffer(capacity=8, seed=0)
    buf.add([{"v": i} for i in range(12)])  # wraps: slots hold 4..11
    assert len(buf) == 8
    batch, _, _ = buf.sample(32)
    assert set(np.asarray(batch["v"]).tolist()) <= set(range(4, 12))


def test_replay_buffer_draws_match_jax():
    """Same seed, same adds and updates: the same indices, weights and rows
    as the JAX package's buffer (both draw from ``np.random.default_rng``)."""
    port, ref = ReplayBuffer(48, seed=7), JaxBuffer(48, seed=7)
    rng = np.random.default_rng(2)
    for step in range(12):
        items = [{"obs": rng.normal(size=3).astype(np.float32)} for _ in range(8)]
        prios = rng.random(8) + 0.1 if step % 2 else None
        assert port.add(items, prios) == ref.add(items, prios)
        b1, i1, w1 = port.sample(16)
        b2, i2, w2 = ref.sample(16)
        assert np.array_equal(i1, i2) and np.array_equal(w1, w2)
        assert np.array_equal(b1["obs"], np.asarray(b2["obs"]))
        new = rng.random(16) * 3
        port.update_priorities(i1, new)
        ref.update_priorities(i2, new)
        assert np.array_equal(port._tree.tree, ref._tree.tree)


def test_payload_bytes_and_own_copy_take_tensors_and_borrowed_views():
    tree = {"a": np.zeros((2, 3), np.float32), "b": (torch.zeros(4, dtype=torch.bfloat16), 7)}
    assert payload_bytes(tree) == 24 + 8
    buf = np.arange(6, dtype=np.float32)
    view = np.frombuffer(buf.tobytes(), np.float32)  # read-only, like a borrowed view
    owned = _own_copy({"v": view, "t": tree["b"][0]})
    assert owned["v"].flags.writeable and owned["v"].base is None
    assert owned["t"] is tree["b"][0]


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
def test_replay_over_rpc(free_port, client_pkg):
    """A port ReplayServer, called by a client of either package."""
    server_rpc = Rpc()
    client_rpc = Rpc() if client_pkg == "port" else moolib_tpu.Rpc()
    client_cls = ReplayClient if client_pkg == "port" else JaxClient
    try:
        server_rpc.set_name("learner")
        client_rpc.set_name("actor")
        client_rpc.set_timeout(10)
        ReplayServer(server_rpc, "replay", ReplayBuffer(capacity=128, seed=1))
        server_rpc.listen(f"127.0.0.1:{free_port}")
        client_rpc.connect(f"127.0.0.1:{free_port}")
        client = client_cls(client_rpc, "learner", "replay")
        items = [{"obs": np.random.randn(4).astype(np.float32), "reward": float(i)}
                 for i in range(20)]
        idxs = client.add(items, priorities=[1.0] * 20)
        assert len(idxs) == 20
        assert client.size() == 20
        batch, indices, weights = client.sample(8)
        assert np.asarray(batch["obs"]).shape == (8, 4)
        client.update_priorities_async(indices, np.ones(len(indices))).result()
    finally:
        server_rpc.close()
        client_rpc.close()
