"""Autoscaler tests on the port (the cases of ``tests/test_autoscaler.py``):
policy decisions from synthetic registry snapshots, graceful-leave epoch
bumps with zero eviction-timeout wait, virtual-batch stability across a
grow/shrink cycle, and scale-hold during an active recovery — with port
Accumulators holding CPU tensors.  Plus the port's own pieces: the JAX and
port policies decide alike on the same samples, ``example_spawn`` launches
a port worker without any JAX environment, and ``CohortAggregator.
peer_samples`` turns a scrape into rows."""

import contextlib
import json
import os
import threading
import time

import numpy as np
import torch

from moolib_tpu_torch import Accumulator, Broker
from moolib_tpu_torch.autoscaler import (
    Autoscaler,
    AutoscalePolicy,
    PeerSample,
    read_snapshot_tail,
    sample_from_snapshot,
)
from moolib_tpu_torch.testing.faults import FaultPlan

torch.set_num_threads(1)


NOW = 1000.0


def _sample(name="p0", t=NOW, q=None, fill=None, rec=False):
    return PeerSample(name, t, queue_depth=q, vbatch_fill=fill,
                      recovery_active=rec)


# --------------------------------------------------------------------- policy
def test_policy_grow_on_starvation():
    pol = AutoscalePolicy(1, 4, starvation_depth=0.0, cooldown_s=5.0)
    d = pol.decide([_sample(q=0.0), _sample("p1", q=0.0)], 2, NOW)
    assert (d.action, d.reason, d.target) == ("grow", "starved", 3)


def test_policy_no_grow_past_max():
    pol = AutoscalePolicy(1, 2)
    d = pol.decide([_sample(q=0.0), _sample("p1", q=0.0)], 2, NOW)
    assert d.action == "hold"


def test_policy_shrink_needs_sustained_saturation():
    pol = AutoscalePolicy(1, 4, saturation_fill=0.9, saturate_polls=3,
                          cooldown_s=0.0)
    samples = [_sample(q=3.0, fill=0.95), _sample("p1", q=2.0, fill=1.0)]
    assert pol.decide(samples, 3, NOW).action == "hold"
    assert pol.decide(samples, 3, NOW + 1).action == "hold"
    d = pol.decide(samples, 3, NOW + 2)
    assert (d.action, d.reason, d.target) == ("shrink", "saturated", 2)


def test_policy_saturation_streak_resets():
    pol = AutoscalePolicy(1, 4, saturation_fill=0.9, saturate_polls=2,
                          cooldown_s=0.0)
    hot = [_sample(q=3.0, fill=1.0)]
    cold = [_sample(q=3.0, fill=0.2)]
    assert pol.decide(hot, 3, NOW).action == "hold"
    assert pol.decide(cold, 3, NOW + 1).action == "hold"  # streak broken
    assert pol.decide(hot, 3, NOW + 2).action == "hold"
    assert pol.decide(hot, 3, NOW + 3).action == "shrink"


def test_policy_holds_during_recovery():
    """The scale-hold: a peer mid-rejoin freezes scaling even under a
    starvation signal that would otherwise grow the cohort."""
    pol = AutoscalePolicy(1, 4, starvation_depth=0.0, cooldown_s=0.0)
    samples = [_sample(q=0.0), _sample("p1", q=0.0, rec=True)]
    d = pol.decide(samples, 2, NOW)
    assert (d.action, d.reason) == ("hold", "recovery")
    # Recovery over -> the starvation signal acts again.
    samples = [_sample(q=0.0), _sample("p1", q=0.0, rec=False)]
    assert pol.decide(samples, 2, NOW + 1).action == "grow"


def test_policy_bounds_beat_recovery_hold():
    pol = AutoscalePolicy(2, 4)
    d = pol.decide([_sample(rec=True)], 1, NOW)
    assert (d.action, d.reason) == ("grow", "below_min")


def test_policy_cooldown():
    pol = AutoscalePolicy(1, 4, starvation_depth=0.0, cooldown_s=10.0)
    samples = [_sample(q=0.0)]
    assert pol.decide(samples, 2, NOW).action == "grow"
    pol.note_event(NOW)
    d = pol.decide(samples, 2, NOW + 5)
    assert (d.action, d.reason) == ("hold", "cooldown")
    assert pol.decide(samples, 2, NOW + 11).action == "grow"


def test_policy_ignores_stale_samples():
    pol = AutoscalePolicy(1, 4, starvation_depth=0.0, cooldown_s=0.0,
                          stale_s=30.0)
    # The only starvation evidence is 5 minutes old: no action on it.
    d = pol.decide([_sample(q=0.0, t=NOW - 300)], 2, NOW)
    assert d.action == "hold"


# ----------------------------------------------------- snapshots and sampling
def test_sample_from_snapshot_extracts_signals():
    snap = {
        "time": NOW,
        "pid": 1,
        "metrics": {
            "batcher_queue_depth": {
                "kind": "gauge", "help": "", "series": [
                    {"labels": {"batcher": "learn"}, "value": 0.0},
                    {"labels": {"batcher": "other"}, "value": 7.0},
                ],
            },
            "accum_virtual_batch_fill": {
                "kind": "gauge", "help": "", "series": [
                    {"labels": {"accumulator": "model", "peer": "p0"},
                     "value": 0.5},
                ],
            },
            "accum_recovery_active": {
                "kind": "gauge", "help": "", "series": [
                    {"labels": {"accumulator": "model", "peer": "p0"},
                     "value": 1.0},
                ],
            },
            "train_steps_total": {
                "kind": "counter", "help": "", "series": [
                    {"labels": {}, "value": 42.0},
                ],
            },
        },
    }
    s = sample_from_snapshot("p0", snap)
    assert s.name == "p0"
    assert s.queue_depth == 0.0  # min across batchers: the starved one
    assert s.vbatch_fill == 0.5
    assert s.recovery_active is True
    assert s.steps == 42.0


# ------------------------------------------------------- serving rules
def _serve_sample(name="r0", t=NOW, qps=None, wait=None, occ=None):
    return PeerSample(name, t, serve_qps=qps, serve_wait=wait,
                      slot_occupancy=occ)


def test_policy_grows_on_sustained_queue_wait():
    pol = AutoscalePolicy(1, 4, cooldown_s=0.0, serve_wait_grow_s=0.5,
                          serve_wait_polls=2)
    hot = [_serve_sample(qps=20.0, wait=0.8, occ=1.0)]
    assert pol.decide(hot, 2, NOW).action == "hold"  # one poll isn't a trend
    d = pol.decide(hot, 2, NOW + 1)
    assert (d.action, d.reason, d.target) == ("grow", "serve_wait", 3)
    # A calm poll in between resets the streak.
    pol2 = AutoscalePolicy(1, 4, cooldown_s=0.0, serve_wait_polls=2)
    assert pol2.decide(hot, 2, NOW).action == "hold"
    assert pol2.decide([_serve_sample(qps=20.0, wait=0.01)], 2,
                       NOW + 1).action == "hold"
    assert pol2.decide(hot, 2, NOW + 2).action == "hold"
    assert pol2.decide(hot, 2, NOW + 3).action == "grow"


def test_policy_serve_wait_respects_max_peers():
    pol = AutoscalePolicy(1, 2, cooldown_s=0.0, serve_wait_polls=1)
    d = pol.decide([_serve_sample(wait=5.0)], 2, NOW)
    assert (d.action, d.reason) == ("hold", "serve_wait_at_max")


def test_policy_shrinks_idle_serving_fleet():
    pol = AutoscalePolicy(1, 4, cooldown_s=0.0, serve_idle_qps=0.1,
                          serve_idle_polls=3)
    idle = [_serve_sample(qps=0.0, wait=0.0, occ=0.0),
            _serve_sample("r1", qps=0.0, wait=0.0, occ=0.0)]
    assert pol.decide(idle, 2, NOW).action == "hold"
    assert pol.decide(idle, 2, NOW + 1).action == "hold"
    d = pol.decide(idle, 2, NOW + 2)
    assert (d.action, d.reason, d.target) == ("shrink", "serve_idle", 1)
    # Busy slots veto the shrink even at zero answered QPS (long decodes
    # in flight answer nothing for a while but are NOT idle).
    pol2 = AutoscalePolicy(1, 4, cooldown_s=0.0, serve_idle_polls=1)
    busy = [_serve_sample(qps=0.0, wait=0.0, occ=0.9)]
    assert pol2.decide(busy, 2, NOW).action == "hold"


def test_policy_serving_rules_dormant_for_training_peers():
    """Training samples carry no serving signals: the serving rules must
    neither fire nor shadow the starvation rule."""
    pol = AutoscalePolicy(1, 4, starvation_depth=0.0, cooldown_s=0.0,
                          serve_idle_polls=1)
    d = pol.decide([_sample(q=0.0)], 2, NOW)
    assert (d.action, d.reason) == ("grow", "starved")


def test_policy_serving_signals_shadow_training_rules():
    """A serving fleet exposes no batcher depth, so the training starvation
    rule must never fire for it — serving samples route to the serving
    rules and steady traffic holds."""
    pol = AutoscalePolicy(1, 4, cooldown_s=0.0)
    steady = [_serve_sample(qps=50.0, wait=0.01, occ=0.6)]
    d = pol.decide(steady, 2, NOW)
    assert (d.action, d.reason) == ("hold", "steady")


def test_sample_from_snapshot_extracts_serving_signals():
    snap = {
        "time": NOW,
        "pid": 1,
        "metrics": {
            "serve_qps": {"kind": "gauge", "help": "", "series": [
                {"labels": {}, "value": 12.5},
            ]},
            "serve_queue_depth": {"kind": "gauge", "help": "", "series": [
                {"labels": {}, "value": 3.0},
            ]},
            "serve_queue_wait_s": {"kind": "gauge", "help": "", "series": [
                {"labels": {}, "value": 0.75},
            ]},
            "serve_engine_slot_occupancy": {
                "kind": "gauge", "help": "", "series": [
                    {"labels": {}, "value": 0.875},
                ],
            },
        },
    }
    s = sample_from_snapshot("r0", snap)
    assert s.serve_qps == 12.5
    assert s.serve_depth == 3.0
    assert s.serve_wait == 0.75
    assert s.slot_occupancy == 0.875
    assert s.queue_depth is None  # no training signals on a serving peer


def test_sample_falls_back_to_ready_depth():
    snap = {"time": NOW, "metrics": {
        "batcher_ready_depth": {"kind": "gauge", "help": "",
                                "series": [{"labels": {}, "value": 3.0}]},
    }}
    assert sample_from_snapshot("p", snap).queue_depth == 3.0


def test_read_snapshot_tail_skips_torn_write(tmp_path):
    path = os.path.join(str(tmp_path), "telemetry.jsonl")
    good = {"time": NOW, "pid": 1, "metrics": {"m": {"series": []}}}
    with open(path, "w") as f:
        f.write(json.dumps({"time": NOW - 1, "pid": 1, "metrics": {}}) + "\n")
        f.write(json.dumps(good) + "\n")
        f.write('{"time": 1001, "pid": 1, "met')  # snapshotter mid-write
    snap = read_snapshot_tail(path)
    assert snap is not None and snap["time"] == NOW
    assert read_snapshot_tail(os.path.join(str(tmp_path), "absent.jsonl")) is None


# ------------------------------------------------------- supervisor loop
class FakeFleet:
    def __init__(self, n, samples):
        self.n = n
        self._samples = samples
        self.grown = 0
        self.shrunk = 0

    def size(self):
        return self.n

    def samples(self):
        return self._samples

    def grow(self):
        self.grown += 1
        self.n += 1
        return f"auto{self.grown}"

    def shrink(self):
        self.shrunk += 1
        self.n -= 1
        return f"auto{self.n}"


def test_autoscaler_loop_grow_and_cooldown():
    fleet = FakeFleet(2, [_sample(q=0.0), _sample("p1", q=0.0)])
    scaler = Autoscaler(
        AutoscalePolicy(1, 4, starvation_depth=0.0, cooldown_s=100.0),
        fleet, poll_interval=0.0,
    )
    d = scaler.step(now=NOW)
    assert d.action == "grow" and fleet.grown == 1
    # Next poll is inside the cooldown window: no second spawn.
    d = scaler.step(now=NOW + 1)
    assert d.action == "hold" and d.reason == "cooldown" and fleet.grown == 1
    assert [e["action"] for e in scaler.events] == ["grow"]


def test_autoscaler_loop_shrink():
    fleet = FakeFleet(3, [_sample(q=5.0, fill=1.0)])
    scaler = Autoscaler(
        AutoscalePolicy(1, 4, saturate_polls=1, cooldown_s=0.0),
        fleet, poll_interval=0.0,
    )
    d = scaler.step(now=NOW)
    assert d.action == "shrink" and fleet.shrunk == 1


# ------------------------------------------------------------- fault schedule
def test_poisson_kills_deterministic():
    a = FaultPlan(7).poisson_kills(rate=0.5, window=60.0)
    b = FaultPlan(7).poisson_kills(rate=0.5, window=60.0)
    c = FaultPlan(8).poisson_kills(rate=0.5, window=60.0)
    assert a == b
    assert a != c
    assert all(0 < t < 60.0 for t in a)
    assert a == sorted(a)
    # ~rate*window arrivals on average; same-seed determinism makes this a
    # fixed number, just sanity-bound it.
    assert 10 <= len(a) <= 60


def test_poisson_kills_isolated_stream():
    """Drawing poisson kills must not perturb the plan's other streams."""
    p1, p2 = FaultPlan(3), FaultPlan(3)
    p1.poisson_kills(rate=1.0, window=10.0)
    assert p1.rng("kills").random() == p2.rng("kills").random()


def test_poisson_kills_empty_edges():
    assert FaultPlan(1).poisson_kills(0.0, 60.0) == []
    assert FaultPlan(1).poisson_kills(1.0, 0.0) == []


# ------------------------------------------- live cohorts: leave/vbatch/hold
def make_cohort(free_port, n, virtual_batch_size=None, broker_timeout=5.0,
                start=0):
    addr = f"127.0.0.1:{free_port}"
    broker = Broker()
    broker.set_name("broker")
    broker.set_timeout(broker_timeout)
    broker.listen(addr)
    accs = [join_peer(free_port, i, virtual_batch_size) for i in range(start, n)]
    return broker, accs


def join_peer(free_port, i, virtual_batch_size=None):
    params = {"w": torch.zeros(2, 2)}
    acc = Accumulator("model", params, buffers=None)
    acc._rpc.set_name(f"peer{i}")
    acc._rpc.set_timeout(10)
    acc._rpc.listen("127.0.0.1:0")
    if virtual_batch_size:
        acc.set_virtual_batch_size(virtual_batch_size)
    acc.connect(f"127.0.0.1:{free_port}")
    return acc


def pump(broker, accs, seconds, until=None):
    deadline = time.time() + seconds
    while time.time() < deadline:
        broker.update()
        for a in accs:
            a.update()
            if a.wants_state():
                a.set_state({"opt": a._rpc.get_name()})
        if until is not None and until():
            return True
        time.sleep(0.02)
    return until() if until is not None else None


def close_all(broker, accs):
    for a in accs:
        a.close()
    broker.close()


def test_graceful_decommission_no_eviction_wait(free_port):
    """A decommissioned peer's departure reaches the survivors via the
    explicit __broker_leave: with a 60 s ping-eviction timeout, only the
    leave RPC can explain a sub-second epoch bump."""
    broker, accs = make_cohort(free_port, 3, broker_timeout=60.0)
    try:
        assert pump(broker, accs, 30, until=lambda: all(a.connected() for a in accs))
        survivors = accs[:2]
        old_syncs = [a._group.sync_id() for a in survivors]
        t0 = time.monotonic()
        assert accs[2].decommission(timeout=10.0)
        assert accs[2].decommissioned()
        # The epoch push lands handler-side (no pump needed on survivors).
        deadline = time.monotonic() + 1.0
        while time.monotonic() < deadline:
            if all(a._group.sync_id() != s
                   for a, s in zip(survivors, old_syncs)):
                break
            time.sleep(0.01)
        bump_s = time.monotonic() - t0
        assert all(
            a._group.sync_id() != s for a, s in zip(survivors, old_syncs)
        ), "survivors never saw the leave epoch (would wait 60s eviction)"
        assert bump_s < 1.0, f"leave epoch took {bump_s:.2f}s"
        # Survivors re-form and reduce again without the decommissioned peer.
        assert pump(
            broker, survivors, 30,
            until=lambda: all(
                a.connected() and a.cohort_size() == 2 for a in survivors
            ),
        )
        for a in survivors:
            a.reduce_gradients(4, {"w": torch.ones(2, 2)})
        assert pump(broker, survivors, 10,
                    until=lambda: all(a.has_gradients() for a in survivors))
        for a in survivors:
            assert a.get_gradient_stats()["num_gradients"] == 2
    finally:
        close_all(broker, accs)


@contextlib.contextmanager
def running(fn, interval=0.01):
    """Call ``fn`` on a helper thread every ``interval`` seconds for the
    length of the block (the other peers' loops during a blocking call)."""
    stop = threading.Event()
    errors = []

    def loop():
        while not stop.is_set():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 - re-raised on exit
                errors.append(e)
                return
            time.sleep(interval)

    t = threading.Thread(target=loop, daemon=True)
    t.start()
    try:
        yield
    finally:
        stop.set()
        t.join()
    if errors:
        raise errors[0]


def test_vbatch_stable_across_grow_shrink(free_port):
    """The semantic contract: every APPLIED result carries at least the
    configured virtual batch, through a grow (3rd peer joins) and a shrink
    (graceful decommission) — effective batch never silently halves or
    doubles with peer count."""
    VBS = 8
    broker, accs = make_cohort(free_port, 2, virtual_batch_size=VBS,
                               broker_timeout=60.0)
    applied = []

    def tick(accs):
        """One pass of every peer's training loop."""
        broker.update()
        for a in accs:
            a.update()
            if a.wants_state():
                a.set_state({"opt": a._rpc.get_name()})
            if not a.connected():
                continue
            if a.has_gradients():
                if a is accs[0]:
                    applied.append(a.get_gradient_stats())
                a.zero_gradients()
            elif a.wants_gradients():
                a.reduce_gradients(2, {"w": torch.ones(2, 2)})

    def drive(accs, n_results, seconds=60):
        deadline = time.time() + seconds
        while time.time() < deadline and len(applied) < n_results:
            tick(accs)
            time.sleep(0.01)
        return len(applied) >= n_results

    try:
        assert pump(broker, accs, 30, until=lambda: all(a.connected() for a in accs))
        assert drive(accs, 2), f"no results with 2 peers: {applied}"
        # Grow: a third peer joins mid-run.
        accs.append(join_peer(free_port, 2, VBS))
        assert pump(broker, accs, 30, until=lambda: all(a.connected() for a in accs))
        assert drive(accs, len(applied) + 2), "no results after grow"
        # Shrink: the newcomer decommissions gracefully.
        victim = accs.pop()
        # The survivors keep training while the victim drains, as their own
        # loops would: a round the victim joined settles only once every
        # member has contributed to it.
        with running(lambda: tick(accs)):
            assert victim.decommission(timeout=10.0)
        victim.close()
        assert pump(
            broker, accs, 30,
            until=lambda: all(
                a.connected() and a.cohort_size() == 2 for a in accs
            ),
        )
        assert drive(accs, len(applied) + 2), "no results after shrink"
        assert applied, "nothing applied"
        for stats in applied:
            assert stats["batch_size"] >= VBS, (
                f"virtual batch violated across resize: {stats} "
                f"(target {VBS}); all={applied}"
            )
    finally:
        close_all(broker, accs)


def test_recovery_active_signal(free_port):
    """Accumulator.recovery_active(): True while joining, False once
    productive, True again on a membership epoch (the autoscaler's hold)."""
    broker, accs = make_cohort(free_port, 2, broker_timeout=60.0)
    try:
        assert all(a.recovery_active() for a in accs)  # not yet connected
        assert pump(broker, accs, 30, until=lambda: all(a.connected() for a in accs))
        assert not any(a.recovery_active() for a in accs)
        # A third peer joining changes the epoch: mid-rejoin the cohort
        # reports recovery_active until re-election/model-sync completes.
        late = join_peer(free_port, 2)
        accs.append(late)
        assert late.recovery_active()
        assert pump(broker, accs, 30, until=lambda: all(a.connected() for a in accs))
        assert not any(a.recovery_active() for a in accs)
    finally:
        close_all(broker, accs)


# ------------------------------------------------------------- port pieces
def test_policy_decides_as_the_jax_policy():
    """The same random poll sequence through the JAX package's policy and
    the port's gives the same decisions (the hysteresis included)."""
    from moolib_tpu import autoscaler as jax_autoscaler

    rng = np.random.default_rng(0)
    kw = dict(saturate_polls=2, cooldown_s=3.0, serve_wait_polls=2, serve_idle_polls=2)
    ours, theirs = AutoscalePolicy(1, 5, **kw), jax_autoscaler.AutoscalePolicy(1, 5, **kw)
    cohort = 2
    for i in range(200):
        t = NOW + i
        rows = []
        for j in range(int(rng.integers(1, 4))):
            serving = rng.random() < 0.3
            rows.append(dict(
                name=f"p{j}", time=t - float(rng.integers(0, 40)),
                queue_depth=None if serving else float(rng.integers(0, 3)),
                vbatch_fill=None if serving else float(rng.random() * 1.2),
                recovery_active=bool(rng.random() < 0.05),
                serve_qps=float(rng.random()) if serving else None,
                serve_wait=float(rng.random()) if serving else None,
                slot_occupancy=float(rng.random()) if serving else None))
        a = ours.decide([PeerSample(**r) for r in rows], cohort, t)
        b = theirs.decide([jax_autoscaler.PeerSample(**r) for r in rows], cohort, t)
        assert (a.action, a.reason, a.target) == (b.action, b.reason, b.target), i
        if a.action != "hold":
            ours.note_event(t)
            theirs.note_event(t)
            cohort = a.target


def test_example_spawn_launches_a_port_worker(tmp_path, monkeypatch):
    """The spawned worker is the port's module, joins the broker list, and
    gets its telemetry directory — and no JAX platform knob: a port worker
    runs on the card unless its arguments say --device cpu."""
    from moolib_tpu_torch import autoscaler

    seen = {}

    def fake_popen(cmd, **kw):
        seen.update(cmd=cmd, env=kw["env"], session=kw["start_new_session"])
        return "proc"

    monkeypatch.setattr(autoscaler.subprocess, "Popen", fake_popen)
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    spawn = autoscaler.example_spawn("127.0.0.1:1,127.0.0.1:2", str(tmp_path),
                                     "moolib_tpu_torch.examples.lm", ["--device", "cpu"])
    assert spawn("w0", str(tmp_path)) == "proc"
    cmd = seen["cmd"]
    assert cmd[1:3] == ["-m", "moolib_tpu_torch.examples.lm"]
    assert cmd[3:5] == ["--broker_addrs", "127.0.0.1:1,127.0.0.1:2"]
    assert cmd[-2:] == ["--device", "cpu"] and "--localdir" in cmd
    assert seen["env"]["MOOLIB_TELEMETRY_DIR"] == str(tmp_path)
    assert "JAX_PLATFORMS" not in seen["env"] and seen["session"]


def _row(t, steps):
    return {"time": t, "metrics": {
        "train_steps_total": {"kind": "counter", "help": "",
                              "series": [{"labels": {}, "value": steps}]},
        "accum_recovery_active": {"kind": "gauge", "help": "",
                                  "series": [{"labels": {}, "value": 0.0}]}}}


def test_cohort_aggregator_peer_samples():
    """A scrape as PeerSample rows: the signals sample_from_snapshot
    extracts, step rates from successive scrape deltas, a restarted
    peer's counter reset read as a fresh baseline, departed peers pruned."""
    from moolib_tpu_torch.telemetry import CohortAggregator

    agg = CohortAggregator(None, "broker")
    agg._fused = {"time": 1.0, "errors": {}, "peers": {"a": _row(100.0, 500.0),
                                                       "b": _row(100.0, 10.0)}}
    rows = {s.name: s for s in agg.peer_samples()}
    assert rows["a"].steps == 500.0 and rows["a"].step_rate is None
    assert not rows["a"].recovery_active
    agg._fused = {"time": 2.0, "errors": {}, "peers": {"a": _row(110.0, 600.0)}}
    (s,) = agg.peer_samples()
    assert s.step_rate == 10.0 and set(agg._last_steps) == {"a"}
    agg._fused = {"time": 3.0, "errors": {}, "peers": {"a": _row(120.0, 5.0)}}
    (s,) = agg.peer_samples()
    assert s.step_rate is None


def test_lm_autoscale_grows_a_worker_into_the_cohort(tmp_path, free_port, monkeypatch):
    """examples.lm --autoscale on the CPU: the broker-hosting peer applies
    one step, then (--min_cohort 2) waits while its autoscaler spawns one
    worker process of the same example (``--device cpu`` passed through),
    which joins and trains with it to the end; the worker leaves a telemetry
    snapshot and a log in its localdir."""
    from moolib_tpu_torch.examples import lm

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PYTHONPATH", os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
                       + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cohorts = []
    out = lm.train(lm.make_flags([
        "--mesh", "", "--attention", "dense", "--device", "cpu", "--seq_len", "16",
        "--batch_size", "4", "--steps", "12", "--log_interval", "1", "--quiet",
        "--address", f"127.0.0.1:{free_port}", "--local_name", "supervisor",
        "--min_cohort", "2", "--autoscale", "--autoscale_min", "1", "--autoscale_max", "1",
        "--autoscale_interval", "0.2", "--localdir", str(tmp_path)]),
        on_stats=lambda s: cohorts.append(s["cohort"]))
    assert out["steps"] == 12 and max(cohorts) == 2
    worker_dir = tmp_path / "fleet" / "auto0"
    assert (worker_dir / "worker.log").exists()
    assert (worker_dir / "telemetry.jsonl").exists()


def test_lm_serve_leaves_on_decommission(tmp_path, free_port):
    """lm_serve --localdir: the server watches the autoscaler's flag file
    and, when it appears, closes its service and returns from main()."""
    import threading

    from moolib_tpu_torch.examples import lm_serve

    done = {}

    def run():
        try:
            lm_serve.main(["--listen", f"127.0.0.1:{free_port}", "--device", "cpu",
                           "--localdir", str(tmp_path), "--d_model", "32", "--layers", "1",
                           "--heads", "2", "--seq_len", "16", "--max_new_tokens", "2"])
            done["ok"] = True
        except BaseException as e:  # noqa: BLE001 — reported below
            done["error"] = repr(e)

    from moolib_tpu_torch.rpc import Rpc

    t = threading.Thread(target=run, daemon=True)
    t.start()
    client = Rpc()
    client.set_timeout(2)
    client.connect(f"127.0.0.1:{free_port}")
    up, deadline = False, time.time() + 60
    while not up and time.time() < deadline:  # up once it answers its stats
        try:
            up = "served" in client.sync("lm_server", "generate_stats")
        except Exception:  # noqa: BLE001 — not up yet
            time.sleep(0.5)
    client.close()
    assert up, done
    (tmp_path / "decommission").write_text("now")
    t.join(30)
    assert not t.is_alive() and done == {"ok": True}
