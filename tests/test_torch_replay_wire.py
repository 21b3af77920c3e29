"""The port's replay wire plane over ipc loopback: the two-level cohort draw
(level one in proportion to the shard totals, write-back routed to the
owning shard), the write-once memfd ingest, and mixed cohorts of JAX and
port peers — a port ReplayShardService drawn by a JAX DistributedReplay, a
JAX shard drawn by a port one, and ReplayPublisher write-once bytes in both
directions.  Shards run on the CPU (``device="cpu"``)."""

import time

import numpy as np
import pytest
import torch

import moolib_tpu
from moolib_tpu import replay as jreplay
from moolib_tpu import telemetry as jtelemetry
from moolib_tpu_torch import Rpc, telemetry
from moolib_tpu_torch import replay as preplay

torch.set_num_threads(1)

PKGS = {"port": (Rpc, preplay, telemetry), "jax": (moolib_tpu.Rpc, jreplay, jtelemetry)}


def _shard(pkg, capacity, **kw):
    if pkg == "port":
        return preplay.DeviceReplayShard(capacity, device="cpu", **kw)
    return jreplay.DeviceReplayShard(capacity, **kw)


def _counter(pkg, direction):
    reg = PKGS[pkg][2].get_registry()
    return reg.counter_values().get(f'replay_bytes_total{{direction="{direction}"}}', 0.0)


def _cohort(hub_pkg, shard_pkg, tag, capacity=64, alpha=1.0):
    """A hub Rpc listening on ipc and two shard services of ``shard_pkg``
    connected to it; returns (hub, [spoke Rpcs], [services], peer names)."""
    hub = PKGS[hub_pkg][0]()
    hub.set_name(f"{tag}-hub")
    hub.set_timeout(20)
    hub.listen(":0")
    addr = next(a for a in hub._listen_addrs if a.startswith("ipc://"))
    spokes, services, names = [], [], []
    for i in range(2):
        rpc_cls, mod, _ = PKGS[shard_pkg]
        r = rpc_cls()
        names.append(f"{tag}-shard{i}")
        r.set_name(names[-1])
        r.set_timeout(20)
        services.append(mod.ReplayShardService(
            r, "replay", _shard(shard_pkg, capacity, alpha=alpha, seed=i), shard_index=i,
            num_shards=2))
        r.connect(addr)
        spokes.append(r)
    return hub, spokes, services, names


def _close(hub, spokes):
    for r in spokes:
        r.close()
    hub.close()


@pytest.mark.parametrize("learner_pkg,shard_pkg", [("port", "port"), ("jax", "port"),
                                                   ("port", "jax")])
def test_cohort_draw_is_proportional_and_write_back_routes(learner_pkg, shard_pkg):
    """Two shards with lopsided priority mass (1 : 9): the across-shard pick
    follows the totals, and write-back reaches the owning shard — with the
    learner's DistributedReplay and the shard services from either
    package."""
    hub, spokes, services, names = _cohort(learner_pkg, shard_pkg, f"w{learner_pkg}{shard_pkg}")
    try:
        services[0]._shard.add([{"x": np.float32(i)} for i in range(8)],
                               np.full(8, 0.25, np.float32))
        services[1]._shard.add([{"x": np.float32(i)} for i in range(8)],
                               np.full(8, 2.25, np.float32))
        rep = PKGS[learner_pkg][1].DistributedReplay(rpc=hub, remote_peers=names,
                                                    name="replay", seed=5)
        totals = [st["total"] for st in rep.stats()]
        assert totals[1] == pytest.approx(9 * totals[0], rel=1e-5)
        assert rep.size() == 16
        picks = []
        for _ in range(200):
            batch, ref, w = rep.sample(4)
            picks.append(ref.shard)
            assert np.asarray(batch["x"]).shape == (4,)
            assert np.asarray(w).shape == (4,)
        frac1 = np.mean(np.asarray(picks) == 1)
        assert 0.83 < frac1 < 0.97  # Binomial(200, 0.9), +-3 sigma
        for _ in range(20):
            batch, ref, w = rep.sample(4)
            rep.update_priorities(ref, np.full(4, 1.0, np.float32))
        deadline = time.time() + 10
        while time.time() < deadline:  # remote write-back is fire-and-forget
            now = [st["total"] for st in rep.stats()]
            if now[1] < totals[1] and now[0] > totals[0]:
                break
            time.sleep(0.05)
        assert now[1] < totals[1] and now[0] > totals[0]
    finally:
        _close(hub, spokes)


def test_level_one_picks_match_jax():
    """Level one draws from the same seeded numpy generator over the same
    totals: the port's shard picks are the JAX package's, pick for pick."""
    reps = {}
    for pkg in ("port", "jax"):
        shards = [_shard(pkg, 16, alpha=1.0, seed=i) for i in range(3)]
        for k, s in enumerate(shards):
            s.add([{"x": np.float32(i)} for i in range(4)], np.full(4, k + 1.0, np.float32))
        reps[pkg] = PKGS[pkg][1].DistributedReplay(shards=shards, seed=9)
    picks = {pkg: [rep.sample(4)[1].shard for _ in range(50)] for pkg, rep in reps.items()}
    assert picks["port"] == picks["jax"]


@pytest.mark.parametrize("pub_pkg,shard_pkg", [("port", "port"), ("jax", "port"),
                                               ("port", "jax")])
def test_memfd_ingest_write_once_bytes(pub_pkg, shard_pkg):
    """Three publishes of 32 x [21, 512] f32 to a 2-shard same-host cohort:
    counted out once per publish (memfd multicast), the stripes partition
    the items, and drain() lands them in the rings — publisher and shards
    from either package."""
    hub, spokes, services, names = _cohort(pub_pkg, shard_pkg, f"i{pub_pkg}{shard_pkg}")
    rng = np.random.default_rng(0)
    items = [{"state": rng.normal(size=(21, 512)).astype(np.float32)} for _ in range(32)]
    per_publish = preplay.payload_bytes(items)
    assert per_publish > 1024 * 1024  # over the memfd multicast floor
    try:
        pub = PKGS[pub_pkg][1].ReplayPublisher(hub, names, "replay")
        deadline = time.time() + 10
        while not pub.multicast_ready() and time.time() < deadline:
            time.sleep(0.01)
        assert pub.multicast_ready()
        out0, in0 = _counter(pub_pkg, "ingest_out"), _counter(shard_pkg, "ingest_in")
        for _ in range(3):
            pub.publish(items).result(20)
        assert _counter(pub_pkg, "ingest_out") - out0 == 3 * per_publish
        assert _counter(shard_pkg, "ingest_in") - in0 == 3 * per_publish
        assert [s.drain() for s in services] == [48, 48]
        assert [len(s._shard) for s in services] == [48, 48]
        b, _, _ = services[0]._shard.sample(4)
        evens = np.stack([items[2 * i]["state"] for i in range(16)])
        for row in np.asarray(b["state"]):
            assert any(np.array_equal(row, e) for e in evens)
    finally:
        _close(hub, spokes)
