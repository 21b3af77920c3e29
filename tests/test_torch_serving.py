"""The port's resilient serving plane (``moolib_tpu_torch/serving.py``)
against the JAX package's: the mirror of ``tests/test_serving.py`` on the
port, plus mixed-package checks over loopback.

The mirror pins the plane's claims, each by a deterministic scenario: hot
swaps install between service iterations with zero errors; admission
rejects immediately and typed; req-id dedup serves each logical request
once, even under seeded frame duplication; a poisoned request fails only
its own caller; a replica dying mid-stream costs latency, never a request;
discovery fails over to a standby broker.

The mixed checks hold the wire to the JAX package's: a JAX ``ServeClient``
reaches port replicas of both arms through a JAX ``Broker``, a port client
reaches a JAX replica through a port ``Broker``, a publisher of either
package feeds a subscriber of the other (same sha for the same tree), and a
port replica answers the cohort aggregator's ``__telemetry_snapshot``.
"""

import asyncio
import threading
import time

import numpy as np
import pytest

import jax

import moolib_tpu
import moolib_tpu.serving as jax_serving
import moolib_tpu_torch.serving as port_serving
from moolib_tpu_torch import Broker, Group, Rpc, RpcError
from moolib_tpu_torch.serving import (
    AdmissionController,
    BrokerUnreachableError,
    ModelPublisher,
    ServeClient,
    ServeOverloadError,
    ServeReplica,
    ServeService,
    bucket,
    bucket_shapes,
    is_overload_error,
)
from moolib_tpu_torch.testing.faults import FaultPlan


def addr_of(rpc: Rpc) -> str:
    return next(
        a for a in rpc._listen_addrs if a.startswith("tcp://127")
    ).replace("tcp://", "")


def scale_step(scale: float):
    """step_fn multiplying each row by ``params['scale']`` — output carries
    the serving version, so a test can see *which* weights answered."""

    def step(params, batch):
        return np.asarray(batch, dtype=np.float64) * params["scale"]

    return step


class ServiceHarness:
    """One ServeService on a listening Rpc, its loop on a daemon thread."""

    def __init__(self, step_fn, params, *, name="generate", **kw):
        self.rpc = Rpc()
        self.rpc.set_name(kw.pop("peer_name", "server"))
        self.rpc.listen("127.0.0.1:0")
        self.service = ServeService(self.rpc, step_fn, params, name=name, **kw)
        self.addr = addr_of(self.rpc)
        self._thread = None

    def start(self, total=None):
        self._thread = threading.Thread(
            target=lambda: asyncio.run(self.service.loop(total=total)),
            daemon=True,
        )
        self._thread.start()
        return self

    def close(self):
        self.service.close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self.rpc.close()


# ---------------------------------------------------------------- admission
def test_admission_controller_estimates_and_rejects():
    ac = AdmissionController(max_queue=4, batch_size=2)
    # No EMA yet: only queue_full applies.
    assert ac.admit(0, deadline_s=0.001) is None
    assert ac.admit(4, deadline_s=None) == "queue_full"
    ac.note_service(0.1)
    assert ac.ema_batch_seconds() == pytest.approx(0.1)
    # depth 3 -> ceil(4/2)=2 batches ahead + 1 in service = 0.3s.
    assert ac.estimate_wait(3) == pytest.approx(0.3)
    assert ac.admit(3, deadline_s=0.2) == "deadline"
    assert ac.admit(3, deadline_s=1.0) is None
    # EMA is exponential, not a mean.
    ac.note_service(0.5)
    assert ac.ema_batch_seconds() == pytest.approx(0.1 + 0.25 * 0.4)


def test_bucket_policy_canonical_in_serving():
    assert [bucket(n, 16) for n in (1, 2, 3, 5, 9, 16, 40)] == [
        1, 2, 4, 8, 16, 16, 16,
    ]
    assert sorted(bucket_shapes(16)) == [1, 2, 4, 8, 16]
    # lm_serve must alias THIS policy (one definition; warmup enumerates it).
    from moolib_tpu_torch.examples import lm_serve

    assert lm_serve._bucket is bucket
    assert lm_serve._bucket_shapes is bucket_shapes


# ------------------------------------------------------------------ service
def test_serve_basic_roundtrip_and_stats():
    h = ServiceHarness(scale_step(1.0), {"scale": 2.0}, batch_size=4).start()
    client = Rpc()
    client.set_name("cli")
    client.connect(h.addr)
    try:
        cl = ServeClient(client, fn="generate", replicas=["server"],
                         deadline_s=10.0)
        out = cl.call(np.arange(4.0))
        np.testing.assert_allclose(np.asarray(out), np.arange(4.0) * 2.0)
        st = client.sync("server", "generate_stats")
        assert st["served"] == 1
        assert st["model_version"] == 0
        assert st["ema_batch_seconds"] is not None
        cl.close()
    finally:
        client.close()
        h.close()


def test_hot_swap_mid_traffic_zero_errors():
    h = ServiceHarness(scale_step(1.0), {"scale": 1.0}, batch_size=4).start()
    client = Rpc()
    client.set_name("cli")
    client.connect(h.addr)
    try:
        cl = ServeClient(client, fn="generate", replicas=["server"],
                         deadline_s=10.0)
        futs = []
        swapped = False
        for i in range(40):
            futs.append(cl.submit(np.ones(3)))
            if i == 15 and not swapped:
                announced = time.monotonic()
                assert h.service.stage(5, {"scale": 10.0}, announced)
                swapped = True
            time.sleep(0.002)
        results = [np.asarray(f.result(10.0)) for f in futs]  # no errors
        scales = sorted({float(r[0]) for r in results})
        assert scales[0] == 1.0 and scales[-1] == 10.0  # both versions served
        st = h.service.stats()
        assert st["hot_swaps"] == 1
        assert st["model_version"] == 5
        assert st["last_swap_seconds"] is not None and st["last_swap_seconds"] >= 0
        # Staging an older version is a no-op (stale announcement).
        assert not h.service.stage(3, {"scale": -1.0})
        cl.close()
    finally:
        client.close()
        h.close()


def test_admission_rejects_are_immediate_and_typed():
    # Slow model (~0.15 s/batch), batch_size 1: the EMA makes the wait
    # estimate honest, so a 50 ms deadline behind two queued batches is
    # hopeless (estimate >= 0.45 s) — but still wide enough that the
    # client's own pre-attempt expiry check can't race the dispatch.
    def slow(params, batch):
        time.sleep(0.15)
        return np.asarray(batch)

    h = ServiceHarness(slow, {}, batch_size=1, dynamic_batching=False,
                       max_queue=2).start()
    client = Rpc()
    client.set_name("cli")
    client.connect(h.addr)
    try:
        cl = ServeClient(client, fn="generate", replicas=["server"],
                         deadline_s=10.0)
        cl.call(np.ones(2))  # prime the EMA
        blockers = [cl.submit(np.ones(2)) for _ in range(2)]
        t0 = time.monotonic()
        with pytest.raises(ServeOverloadError) as ei:
            cl.call(np.ones(2), deadline_s=0.05)
        elapsed = time.monotonic() - t0
        assert elapsed < 5.0  # typed reject, not a transport timeout
        assert is_overload_error(ei.value)
        for f in blockers:  # admitted requests still complete
            f.result(10.0)
        st = h.service.stats()
        assert st["admission_rejects"] >= 1
        assert cl.stats()["overload"] == 1
        cl.close()
    finally:
        client.close()
        h.close()


def test_queue_full_rejects_without_ema():
    h = ServiceHarness(scale_step(1.0), {"scale": 1.0}, max_queue=3,
                       batch_size=4)
    # Loop NOT started: requests pile up at admission.
    client = Rpc()
    client.set_name("cli")
    client.connect(h.addr)
    try:
        futs = [client.async_("server", "generate", np.ones(2))
                for _ in range(3)]
        time.sleep(0.3)  # let all three enqueue
        with pytest.raises(Exception) as ei:
            client.sync("server", "generate", np.ones(2))
        assert is_overload_error(ei.value)
        assert "queue_full" in str(ei.value)
        h.start(total=3)
        for f in futs:
            f.result(10.0)
    finally:
        client.close()
        h.close()


def test_deadline_miss_is_counted_not_dropped():
    def slow(params, batch):
        time.sleep(0.2)
        return np.asarray(batch)

    h = ServiceHarness(slow, {}, batch_size=1, dynamic_batching=False).start()
    client = Rpc()
    client.set_name("cli")
    client.connect(h.addr)
    try:
        # No EMA yet -> admitted despite the hopeless deadline; the answer
        # still arrives (late), and the miss is accounted.
        out = client.sync("server", "generate", np.ones(2), deadline_s=0.01,
                          req_id="r-late")
        np.testing.assert_allclose(np.asarray(out), np.ones(2))
        assert h.service.stats()["deadline_misses"] == 1
    finally:
        client.close()
        h.close()


# -------------------------------------------------------------------- dedup
def test_req_id_dedup_inflight_and_done_cache():
    calls = []

    def step(params, batch):
        calls.append(np.asarray(batch).shape[0])
        time.sleep(0.15)  # wide race window for the retry
        return np.asarray(batch)

    h = ServiceHarness(step, {}, batch_size=4).start()
    client = Rpc()
    client.set_name("cli")
    client.connect(h.addr)
    try:
        f1 = client.async_("server", "generate", np.ones(3), req_id="r-1")
        time.sleep(0.05)  # original admitted / in service
        f2 = client.async_("server", "generate", np.ones(3), req_id="r-1")
        np.testing.assert_allclose(np.asarray(f1.result(10.0)), np.ones(3))
        np.testing.assert_allclose(np.asarray(f2.result(10.0)), np.ones(3))
        time.sleep(0.1)
        # Done-cache: a third retry after completion answers immediately.
        f3 = client.async_("server", "generate", np.ones(3), req_id="r-1")
        np.testing.assert_allclose(np.asarray(f3.result(10.0)), np.ones(3))
        assert calls == [1]  # ONE step call, one row: never re-served
        assert h.service.stats()["dedup_hits"] == 2
    finally:
        client.close()
        h.close()


def test_dedup_under_seeded_frame_duplication():
    served = []

    def step(params, batch):
        arr = np.asarray(batch)
        served.extend(float(x) for x in arr[:, 0])
        return arr

    # pad_buckets off: padding repeats the last row, which would alias a
    # legitimate re-serve in this row-count assertion.
    h = ServiceHarness(step, {}, batch_size=8, pad_buckets=False).start()
    plan = FaultPlan(seed=11)
    client = Rpc()
    client.set_name("cli")
    client.connect(h.addr)
    try:
        with plan.frame_faults(dup=0.3, hold=0.1):
            cl = ServeClient(client, fn="generate", replicas=["server"],
                             deadline_s=15.0)
            futs = [cl.submit(np.full(2, float(i))) for i in range(20)]
            results = [np.asarray(f.result(15.0)) for f in futs]
        for i, r in enumerate(results):
            np.testing.assert_allclose(r, np.full(2, float(i)))
        # Exactly-once per logical request: duplicated frames (receiver
        # dedup) and client retries (serving req_id dedup) never re-serve.
        assert sorted(served) == [float(i) for i in range(20)]
        cl.close()
    finally:
        client.close()
        h.close()


# ------------------------------------------------------------- blast radius
def test_poisoned_request_fails_only_its_caller():
    POISON = -7.0

    def step(params, batch):
        arr = np.asarray(batch)
        if (arr == POISON).any():
            raise ValueError("poisoned row")
        return arr * 2.0

    h = ServiceHarness(step, {}, batch_size=8)
    client = Rpc()
    client.set_name("cli")
    client.connect(h.addr)
    try:
        futs = [client.async_("server", "generate", np.full(2, float(i)))
                for i in range(3)]
        bad = client.async_("server", "generate", np.full(2, POISON))
        time.sleep(0.3)  # everything queues into ONE dynamic batch
        h.start(total=4)
        for i, f in enumerate(futs):
            np.testing.assert_allclose(np.asarray(f.result(10.0)),
                                       np.full(2, float(i) * 2.0))
        with pytest.raises(Exception, match="poisoned"):
            bad.result(10.0)
        st = h.service.stats()
        assert st["batch_retries"] == 1
    finally:
        client.close()
        h.close()


# ---------------------------------------------------- discovery + failover
def make_broker(port: int, broker_cls=Broker):
    broker = broker_cls()
    broker.set_name("broker")
    broker.listen(f"127.0.0.1:{port}")
    stop = threading.Event()

    def pump():
        while not stop.is_set():
            broker.update()
            stop.wait(0.05)

    t = threading.Thread(target=pump, daemon=True)
    t.start()
    return broker, stop


def make_replica(peer_name: str, broker_addr: str, scale: float,
                 publisher=None):
    rpc = Rpc()
    rpc.set_name(peer_name)
    rpc.listen("127.0.0.1:0")
    rep = ServeReplica(
        rpc, scale_step(1.0), {"scale": scale}, name="generate",
        batch_size=4, broker=broker_addr, publisher=publisher,
        poll_interval=0.1,
    )
    t = threading.Thread(target=lambda: asyncio.run(rep.loop()), daemon=True)
    t.start()
    return rpc, rep, t


def test_observer_registration_does_not_touch_member_epoch(free_port):
    broker, stop = make_broker(free_port)
    addr = f"127.0.0.1:{free_port}"
    member_rpc = Rpc()
    member_rpc.set_name("member0")
    member_rpc.listen("127.0.0.1:0")
    member_rpc.connect(addr)
    g = Group(member_rpc, "serve")
    rep_rpc = rep = rep_t = None
    try:
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline and not g.active():
            g.update()
            time.sleep(0.02)
        assert g.active()
        epoch = g.sync_id()
        rep_rpc, rep, rep_t = make_replica("rep0", addr, 3.0)
        cl = ServeClient(broker=addr, deadline_s=10.0)
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            g.update()
            if cl.replicas() == ["rep0"]:
                break
            time.sleep(0.02)
        assert cl.replicas() == ["rep0"]  # discovered through __broker_list
        g.update()
        assert g.sync_id() == epoch      # observer never bumped the epoch
        assert g.members() == ["member0"]  # and never joined membership
        out = np.asarray(cl.call(np.ones(2)))
        np.testing.assert_allclose(out, np.ones(2) * 3.0)
        cl.close()
    finally:
        if rep is not None:
            rep.close()
        if rep_rpc is not None:
            rep_rpc.close()
        member_rpc.close()
        stop.set()
        broker.close()


def test_failover_replica_death_loses_no_requests(free_port):
    broker, stop = make_broker(free_port)
    addr = f"127.0.0.1:{free_port}"
    r0 = make_replica("rep0", addr, 1.0)
    r1 = make_replica("rep1", addr, 1.0)
    cl = ServeClient(broker=addr, deadline_s=20.0, attempt_timeout=1.0)
    try:
        cl.wait_for_replicas(2, timeout=15.0)
        futs = [cl.submit(np.full(2, float(i))) for i in range(12)]
        # Abrupt death mid-stream: close rep0's engine out from under its
        # in-flight batch (the in-process stand-in for SIGKILL).
        r0[0].close()
        more = [cl.submit(np.full(2, float(12 + i))) for i in range(6)]
        for i, f in enumerate(futs + more):
            np.testing.assert_allclose(np.asarray(f.result(25.0)),
                                       np.full(2, float(i)))
        st = cl.stats()
        assert st["error"] == 0 and st["deadline"] == 0  # zero lost requests
        cl.close()
    finally:
        stop.set()
        for rpc, rep, _t in (r0, r1):
            try:
                rep.close()
            except Exception:
                pass
            rpc.close()
        broker.close()


# ----------------------------------------------------- publisher hot path
def test_publisher_subscriber_hot_swap_two_replicas(free_port):
    broker, stop = make_broker(free_port)
    addr = f"127.0.0.1:{free_port}"
    pub_rpc = Rpc()
    pub_rpc.set_name("pusher")
    pub_rpc.listen("127.0.0.1:0")
    pub = ModelPublisher(pub_rpc, name="model")
    r0 = make_replica("rep0", addr, 1.0, publisher="pusher")
    r1 = make_replica("rep1", addr, 1.0, publisher="pusher")
    # Replicas reach "pusher" by name through the broker's gossip.
    pub_rpc.connect(addr)
    cl = ServeClient(broker=addr, deadline_s=20.0)
    try:
        cl.wait_for_replicas(2, timeout=15.0)
        np.testing.assert_allclose(np.asarray(cl.call(np.ones(2))), np.ones(2))
        pub.publish({"scale": 9.0}, version=4)
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            if all(r.service.model_version() == 4 for _, r, _t in (r0, r1)):
                break
            time.sleep(0.05)
        assert all(r.service.model_version() == 4 for _, r, _t in (r0, r1))
        for _, rep, _t in (r0, r1):
            st = rep.service.stats()
            assert st["hot_swaps"] == 1
            assert st["last_swap_seconds"] is not None
        np.testing.assert_allclose(np.asarray(cl.call(np.ones(2))),
                                   np.ones(2) * 9.0)
        cl.close()
    finally:
        stop.set()
        for rpc, rep, _t in (r0, r1):
            rep.close()
            rpc.close()
        pub.close()
        pub_rpc.close()
        broker.close()


# ------------------------------------------------------------- fault plan
def test_replica_kill_schedule_is_seeded():
    a, b = FaultPlan(seed=7), FaultPlan(seed=7)
    ta, tb = a.replica_kill_time(10.0), b.replica_kill_time(10.0)
    assert ta == tb
    assert 2.5 <= ta <= 7.5  # middle half: always mid-stream
    assert FaultPlan(seed=8).replica_kill_time(10.0) != ta

    class FakeProc:
        def __init__(self, pid):
            self.pid = pid

    import os

    procs = [FakeProc(os.getpid()), FakeProc(os.getpid())]
    idx = a.replica_kill(procs, sig=0)  # sig 0: existence probe, no kill
    assert idx == b.replica_kill(procs, sig=0)
    assert a.actions[-1][0] == "replica_kill"


# --------------------------------------------------------------- broker HA
def make_ha_brokers(promote_grace=1.0, replicate_interval=0.1):
    """Primary + hot-standby broker pair, each pumped on a daemon thread
    (a closed broker's pump just absorbs the shutdown errors)."""
    from conftest import grab_port

    addr0 = f"127.0.0.1:{grab_port()}"
    addr1 = f"127.0.0.1:{grab_port()}"
    b0 = Broker()
    b0.set_name("broker0")
    b1 = Broker(standby=True)
    b1.set_name("broker1")
    stop = threading.Event()
    for b, addr, other in ((b0, addr0, addr1), (b1, addr1, addr0)):
        b.set_promote_grace(promote_grace)
        b.set_replicate_interval(replicate_interval)
        b.listen(addr)
        b.set_peer_brokers([other])

        def pump(b=b):
            while not stop.is_set():
                try:
                    b.update()
                except Exception:  # noqa: BLE001 - closed mid-test
                    pass
                stop.wait(0.05)

        threading.Thread(target=pump, daemon=True).start()
    return (b0, addr0), (b1, addr1), stop


def test_serve_client_discovery_fails_over_to_standby():
    """ServeClient discovery re-resolves from the broker ADDRESS LIST.  When the primary dies, the refresh loop suspects it and
    reads the roster from the standby's replicated state (then from it as
    the new primary) — replicas stay discoverable and calls keep landing."""
    from moolib_tpu_torch import telemetry

    (b0, addr0), (b1, addr1), stop = make_ha_brokers()
    rpc = Rpc()
    rpc.set_name("rep0")
    rpc.listen("127.0.0.1:0")
    rep = ServeReplica(
        rpc, scale_step(1.0), {"scale": 2.0}, name="generate", batch_size=4,
        brokers=[addr0, addr1], poll_interval=0.1,
    )
    rep._group.set_broker_fail_after(1.5)
    t = threading.Thread(target=lambda: asyncio.run(rep.loop()), daemon=True)
    t.start()
    failovers = telemetry.get_registry().counter(
        "serve_client_broker_failovers_total", "").labels()
    before = failovers.get()
    cl = ServeClient(brokers=[addr0, addr1], deadline_s=20.0,
                     attempt_timeout=2.0, refresh_interval=0.2,
                     broker_unreachable_after=8.0)
    try:
        cl.wait_for_replicas(1, timeout=20.0)
        assert cl.replicas() == ["rep0"]
        np.testing.assert_allclose(np.asarray(cl.call(np.ones(2))),
                                   np.ones(2) * 2.0)
        assert cl._broker_addr == addr0

        b0.close()  # primary dies mid-serve
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            if cl._broker_addr == addr1 and b1.is_primary:
                break
            time.sleep(0.05)
        assert cl._broker_addr == addr1, "discovery never failed over"
        assert b1.is_primary, "standby never promoted"
        assert failovers.get() > before
        assert cl.replicas() == ["rep0"]  # roster survived the failover
        np.testing.assert_allclose(np.asarray(cl.call(np.ones(2))),
                                   np.ones(2) * 2.0)
        st = cl.stats()
        assert st["error"] == 0 and st["deadline"] == 0
        cl.close()
    finally:
        stop.set()
        rep.close()
        rpc.close()
        b0.close()
        b1.close()


def test_broker_unreachable_typed_error():
    """Every broker in the list dead + empty roster ->
    a typed BrokerUnreachableError (an RpcError subclass), fast — never a
    silent deadline burn."""
    from conftest import grab_port

    dead = [f"127.0.0.1:{grab_port()}", f"127.0.0.1:{grab_port()}"]
    cl = ServeClient(brokers=dead, deadline_s=6.0, refresh_interval=0.1,
                     broker_unreachable_after=0.5)
    try:
        assert issubclass(BrokerUnreachableError, RpcError)
        t0 = time.monotonic()
        with pytest.raises(BrokerUnreachableError):
            cl.wait_for_replicas(1, timeout=15.0)
        assert time.monotonic() - t0 < 10.0
        with pytest.raises(BrokerUnreachableError):
            cl.submit(np.ones(2)).result(15.0)
    finally:
        cl.close()


# ------------------------------------------------------------ mixed packages
def _serve_forever(rep):
    t = threading.Thread(target=lambda: asyncio.run(rep.loop()), daemon=True)
    t.start()
    return t


def _engine_replica(peer_name: str, broker_addr: str, group: str):
    """A port engine replica (EngineService over a small LM on the CPU) and
    its model."""
    import torch

    from moolib_tpu_torch.engine import ContinuousBatchingEngine, EngineService
    from moolib_tpu_torch.models.transformer import TransformerLM

    model = TransformerLM(vocab_size=64, d_model=32, num_heads=4, num_kv_heads=2,
                          num_layers=2, max_len=32, attention="dense", dtype=torch.float32,
                          pos_embedding="rotary", device="cpu",
                          generator=torch.Generator().manual_seed(4))
    rpc = Rpc()
    rpc.set_name(peer_name)
    rpc.listen("127.0.0.1:0")
    engine = ContinuousBatchingEngine(model, slots=2, block_size=4, max_prompt_len=8)
    rep = ServeReplica(rpc, None, None, service=EngineService(rpc, engine),
                       broker=broker_addr, group=group)
    return rpc, rep, model


def test_jax_client_reaches_port_replicas_of_both_arms_through_jax_broker(free_port):
    """A JAX ServeClient discovers port replicas through a JAX Broker and
    gets their answers: the batch-synchronous arm (a numpy step) and the
    engine arm (a prompt and a budget; the reply is the port's generate())."""
    import torch

    from moolib_tpu_torch.models.transformer import generate

    broker, stop = make_broker(free_port, moolib_tpu.Broker)
    addr = f"127.0.0.1:{free_port}"
    r0 = make_replica("rep0", addr, 3.0)
    e_rpc, e_rep, model = _engine_replica("eng0", addr, "serve_engine")
    prompt = np.arange(3, 9, dtype=np.int32)
    with torch.no_grad():
        want = generate(model, torch.from_numpy(prompt[None]), 5)[0].numpy()
    e_t = _serve_forever(e_rep)
    clients = [jax_serving.ServeClient(broker=addr, deadline_s=20.0),
               jax_serving.ServeClient(broker=addr, group="serve_engine", deadline_s=20.0)]
    try:
        assert clients[0].wait_for_replicas(1, timeout=15.0) == ["rep0"]
        np.testing.assert_allclose(np.asarray(clients[0].call(np.ones(2))), np.ones(2) * 3.0)
        assert clients[1].wait_for_replicas(1, timeout=15.0) == ["eng0"]
        np.testing.assert_array_equal(np.asarray(clients[1].call(prompt, 5)), want)
        assert clients[0].stats()["error"] == clients[1].stats()["error"] == 0
    finally:
        for cl in clients:
            cl.close()
        stop.set()
        e_rep.close()
        e_t.join(5.0)
        e_rpc.close()
        r0[1].close()
        r0[0].close()
        broker.close()
    assert not e_t.is_alive()


def test_port_client_reaches_jax_replica_through_port_broker(free_port):
    broker, stop = make_broker(free_port)
    addr = f"127.0.0.1:{free_port}"
    rpc = moolib_tpu.Rpc()
    rpc.set_name("jrep0")
    rpc.listen("127.0.0.1:0")
    rep = jax_serving.ServeReplica(rpc, scale_step(1.0), {"scale": 5.0}, name="generate",
                                   batch_size=4, broker=addr)
    t = _serve_forever(rep)
    cl = ServeClient(broker=addr, deadline_s=20.0)
    try:
        assert cl.wait_for_replicas(1, timeout=15.0) == ["jrep0"]
        futs = [cl.submit(np.full(2, float(i))) for i in range(6)]
        for i, f in enumerate(futs):
            np.testing.assert_allclose(np.asarray(f.result(20.0)), np.full(2, 5.0 * i))
        assert cl.stats()["error"] == 0
    finally:
        cl.close()
        stop.set()
        rep.close()
        rpc.close()
        broker.close()


@pytest.mark.parametrize("publisher_pkg", ["jax", "torch"])
def test_publisher_feeds_the_other_packages_subscriber(publisher_pkg):
    """A ModelPublisher of one package feeds a ModelSubscriber of the other
    over loopback: the payload is the port LM's weights as the flax tree
    (``to_flax``), it arrives leaf for leaf, loads back into the port model
    exactly, and both packages' publishers give the same sha for it."""
    import torch

    from moolib_tpu_torch.models.convert import from_flax, to_flax
    from moolib_tpu_torch.models.transformer import TransformerLM

    lm = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2, max_len=16,
              attention="dense", device="cpu")
    tree = to_flax(TransformerLM(**lm, generator=torch.Generator().manual_seed(2)))
    packages = {"jax": (moolib_tpu.Rpc, jax_serving), "torch": (Rpc, port_serving)}
    (pub_rpc_cls, pub_mod), (sub_rpc_cls, sub_mod) = (
        packages[publisher_pkg], packages["torch" if publisher_pkg == "jax" else "jax"])
    pub_rpc, sub_rpc = pub_rpc_cls(), sub_rpc_cls()
    pub_rpc.set_name("pusher")
    pub_rpc.listen("127.0.0.1:0")
    sub_rpc.set_name("replica")
    sub_rpc.connect(addr_of(pub_rpc))
    got = []
    pub = pub_mod.ModelPublisher(pub_rpc, chunk_bytes=4096)  # many chunks
    sub = sub_mod.ModelSubscriber(sub_rpc, "pusher", poll_interval=0.05,
                                  on_update=lambda v, payload, t: got.append((v, payload)))
    try:
        meta = pub.publish(tree, version=3)
        other_rpc = sub_rpc_cls()
        other_pub = sub_mod.ModelPublisher(other_rpc, name="model2", chunk_bytes=4096)
        assert other_pub.publish(tree, version=3) == meta  # same sha, same chunks
        other_pub.close()
        other_rpc.close()
        sub.start()
        deadline = time.monotonic() + 20.0
        while not got and time.monotonic() < deadline:
            time.sleep(0.02)
        assert got and got[0][0] == 3 and meta["total"] > 1
        payload = got[0][1]
        leaves = jax.tree_util.tree_leaves_with_path(tree)
        assert [k for k, _ in jax.tree_util.tree_leaves_with_path(payload)] == [k for k, _ in leaves]
        for (_, a), (_, b) in zip(leaves, jax.tree_util.tree_leaves_with_path(payload)):
            assert isinstance(b, np.ndarray) and np.array_equal(a, b)
        model = TransformerLM(**lm, generator=torch.Generator().manual_seed(9))
        model.load_state_dict(from_flax(payload))
        for k, v in from_flax(tree).items():
            assert torch.equal(model.state_dict()[k], v), k
    finally:
        sub.stop()
        pub.close()
        sub_rpc.close()
        pub_rpc.close()


def test_port_replica_answers_the_cohort_aggregator(free_port):
    """A port replica installs the aggregator's endpoints: a JAX
    CohortAggregator and a port one scrape its registry through the broker;
    on-demand profiling answers with an error naming its slice."""
    from moolib_tpu.telemetry.aggregator import CohortAggregator as JaxAggregator
    from moolib_tpu_torch.telemetry.aggregator import CohortAggregator, fused_prometheus_text

    broker, stop = make_broker(free_port)
    addr = f"127.0.0.1:{free_port}"
    r0 = make_replica("rep0", addr, 2.0)
    rpcs = []
    try:
        cl = ServeClient(broker=addr, deadline_s=20.0)
        cl.wait_for_replicas(1, timeout=15.0)
        cl.call(np.ones(2))
        cl.close()
        for rpc_cls, agg_cls in ((Rpc, CohortAggregator), (moolib_tpu.Rpc, JaxAggregator)):
            rpc = rpc_cls()
            rpc.set_name(f"agg_{len(rpcs)}")
            rpc.connect(addr)
            rpcs.append(rpc)
            agg = agg_cls(rpc, "broker", group="serve", scrape_timeout=10.0)
            deadline = time.monotonic() + 15.0
            fused = agg.scrape()
            while "rep0" not in fused["peers"] and time.monotonic() < deadline:
                time.sleep(0.1)
                fused = agg.scrape()
            row = fused["peers"]["rep0"]
            assert row["name"] == "rep0" and row["role"] == "replica"
            assert "serve_requests_total" in row["metrics"]
        assert 'peer="rep0"' in fused_prometheus_text(fused["peers"])
        with pytest.raises(Exception, match=r"not yet ported \(slice 7\)"):
            rpcs[0].sync("rep0", "__telemetry_profile", "start")
    finally:
        for rpc in rpcs:
            rpc.close()
        stop.set()
        r0[1].close()
        r0[0].close()
        broker.close()
