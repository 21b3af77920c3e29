"""Autoscaler: telemetry-driven elastic fleet supervisor.

The port of the JAX package's ``autoscaler.py`` (the policy core is the
same pure function of the same snapshot rows, so either package's
supervisor steers either package's peers).  The warm-rejoin plane (docs/RESILIENCE.md) made peer *death* cheap; this
module makes peer *count* dynamic and load-driven (ROADMAP item 4, Podracer
fleets, arXiv:2104.06272).  A broker-adjacent supervisor polls each peer's
telemetry snapshot (the JSONL the ``JsonlSnapshotter`` writes under
``MOOLIB_TELEMETRY_DIR``) and grows or shrinks the cohort under an explicit
:class:`AutoscalePolicy`:

- **grow** when the learner's input queue starves (``batcher_queue_depth`` /
  ``batcher_ready_depth`` persistently empty while steps still advance): the
  env/actor side cannot keep the learner fed, so add a peer;
- **shrink** when virtual-batch fill saturates (``accum_virtual_batch_fill``
  pinned at/above the threshold across consecutive polls): contributions
  accumulate faster than the virtual-batch target consumes them, so the
  marginal peer adds latency, not throughput;
- **hold** while any peer reports ``accum_recovery_active`` — a resize is a
  membership epoch bump, and bumping during a rejoin would cancel the very
  model sync / election the recovering peer is waiting on.  Scaling never
  races a recovery.

Scaling *down* is graceful, not a kill: the victim drains its in-flight
contributions (``Accumulator.decommission``) and announces an explicit
``__broker_leave``, so the cohort's epoch bumps in sub-second time instead of
burning the ping-eviction timeout, and the virtual batch size stays
semantically stable across the resize (the two-phase count protocol fires on
the configured target, never on peer count).

The policy core is pure (synthetic snapshots in, decisions out — see
``tests/test_torch_autoscaler.py``); :class:`SubprocessFleet` supplies the
process-level mechanics of the ``--autoscale`` mode of the vtrace/lm
examples.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from . import telemetry
from . import utils

_REG = telemetry.get_registry()
_M_TARGET = _REG.gauge(
    "autoscaler_target_peers", "cohort size the policy is steering toward"
)
_M_COHORT = _REG.gauge(
    "autoscaler_cohort_peers", "live peers the supervisor currently tracks"
)
_M_EVENTS = _REG.counter(
    "autoscaler_scale_events_total", "scale actions taken", ("direction",)
)
_M_HOLDS = _REG.counter(
    "autoscaler_holds_total", "polls that held the cohort size", ("reason",)
)

# How a decommission request reaches a subprocess peer: the supervisor drops
# this flag file in the peer's localdir; the train loop polls for it and runs
# the drain + graceful ``__broker_leave`` before exiting cleanly.
DECOMMISSION_FLAG = "decommission"


class PeerSample:
    """One peer's extracted autoscaling signals (from a telemetry snapshot,
    or built directly by tests)."""

    __slots__ = ("name", "time", "queue_depth", "vbatch_fill",
                 "recovery_active", "steps", "step_rate",
                 "serve_qps", "serve_depth", "serve_wait", "slot_occupancy")

    def __init__(self, name: str, time: float, queue_depth: Optional[float] = None,
                 vbatch_fill: Optional[float] = None, recovery_active: bool = False,
                 steps: Optional[float] = None, step_rate: Optional[float] = None,
                 serve_qps: Optional[float] = None,
                 serve_depth: Optional[float] = None,
                 serve_wait: Optional[float] = None,
                 slot_occupancy: Optional[float] = None):
        self.name = name
        self.time = time
        self.queue_depth = queue_depth
        self.vbatch_fill = vbatch_fill
        self.recovery_active = recovery_active
        self.steps = steps
        self.step_rate = step_rate
        # Serving-plane signals: answered QPS, admission-queue
        # depth, queue-wait EMA, and engine slot occupancy.  None on
        # training peers — the policy's serving rules stay dormant there.
        self.serve_qps = serve_qps
        self.serve_depth = serve_depth
        self.serve_wait = serve_wait
        self.slot_occupancy = slot_occupancy

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"PeerSample({self.name!r}, t={self.time:.1f}, "
                f"q={self.queue_depth}, fill={self.vbatch_fill}, "
                f"rec={self.recovery_active}, rate={self.step_rate}, "
                f"qps={self.serve_qps}, wait={self.serve_wait})")


def _series_values(metrics: Dict[str, Any], name: str) -> List[float]:
    fam = metrics.get(name)
    if not fam:
        return []
    return [s["value"] for s in fam.get("series", []) if s.get("value") is not None]


def sample_from_snapshot(name: str, snap: Dict[str, Any]) -> PeerSample:
    """Extract the policy's signals from one JSONL snapshot line
    (``{"time", "pid", "metrics": registry.snapshot()}``)."""
    metrics = snap.get("metrics", {})
    # Learner input queue: prefer the per-instance bounded-queue gauge, fall
    # back to the process-wide ready depth (pre-``max_outstanding`` peers).
    q = _series_values(metrics, "batcher_queue_depth")
    if not q:
        q = _series_values(metrics, "batcher_ready_depth")
    fills = _series_values(metrics, "accum_virtual_batch_fill")
    rec = _series_values(metrics, "accum_recovery_active")
    steps = _series_values(metrics, "train_steps_total")
    qps = _series_values(metrics, "serve_qps")
    sdepth = _series_values(metrics, "serve_queue_depth")
    swait = _series_values(metrics, "serve_queue_wait_s")
    occ = _series_values(metrics, "serve_engine_slot_occupancy")
    return PeerSample(
        name=name,
        time=float(snap.get("time", 0.0)),
        queue_depth=min(q) if q else None,
        vbatch_fill=max(fills) if fills else None,
        recovery_active=any(v >= 1.0 for v in rec),
        steps=sum(steps) if steps else None,
        serve_qps=sum(qps) if qps else None,
        serve_depth=max(sdepth) if sdepth else None,
        serve_wait=max(swait) if swait else None,
        slot_occupancy=max(occ) if occ else None,
    )


# The torn-tail-tolerant snapshot parser lives with its writer
# (telemetry.exporters.JsonlSnapshotter); re-exported here for the existing
# autoscaler-facing callers.
read_snapshot_tail = telemetry.read_snapshot_tail


class Decision:
    __slots__ = ("action", "reason", "target")

    def __init__(self, action: str, reason: str, target: int):
        self.action = action  # "grow" | "shrink" | "hold"
        self.reason = reason
        self.target = target

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"Decision({self.action}, {self.reason}, target={self.target})"


class AutoscalePolicy:
    """The explicit scaling rules, evaluated one poll at a time.

    Pure with respect to its inputs except for two pieces of hysteresis
    state: the last scale-event time (``cooldown_s``) and the consecutive
    saturated-poll count (``saturate_polls``) — both exist so a single noisy
    sample can't thrash the cohort.  Precedence, highest first:

    1. ``below_min`` / ``above_max``: hard bounds always win.
    2. ``recovery``: any peer mid-rejoin freezes scaling (a resize is an
       epoch bump and would cancel the rejoin's election/model sync).
    3. ``cooldown``: one scale event per ``cooldown_s`` window — every event
       itself triggers a recovery (re-elect) that the next poll must observe.
    4. ``serve_wait`` / ``serve_idle``: serving-fleet rules —
       evaluated only when samples carry serving signals, so training
       cohorts never see them.  Queue-wait EMA above ``serve_wait_grow_s``
       for ``serve_wait_polls`` consecutive polls → grow (clients are
       visibly waiting for admission); answered QPS at/below
       ``serve_idle_qps`` AND slot occupancy at/below
       ``serve_idle_occupancy`` for ``serve_idle_polls`` polls → shrink
       (the marginal replica is idle).
    5. ``starved``: the learner queue is empty cohort-wide → grow.
    6. ``saturated``: vbatch fill pinned >= threshold for ``saturate_polls``
       consecutive polls → shrink.
    7. ``steady``: hold.
    """

    def __init__(self, min_peers: int, max_peers: int, *,
                 starvation_depth: float = 0.0, saturation_fill: float = 0.9,
                 saturate_polls: int = 3, cooldown_s: float = 10.0,
                 stale_s: float = 30.0, serve_wait_grow_s: float = 0.5,
                 serve_wait_polls: int = 2, serve_idle_qps: float = 0.1,
                 serve_idle_occupancy: float = 0.25,
                 serve_idle_polls: int = 3):
        if min_peers < 1 or max_peers < min_peers:
            raise ValueError("need 1 <= min_peers <= max_peers")
        self.min_peers = int(min_peers)
        self.max_peers = int(max_peers)
        self.starvation_depth = float(starvation_depth)
        self.saturation_fill = float(saturation_fill)
        self.saturate_polls = int(saturate_polls)
        self.cooldown_s = float(cooldown_s)
        self.stale_s = float(stale_s)
        self.serve_wait_grow_s = float(serve_wait_grow_s)
        self.serve_wait_polls = int(serve_wait_polls)
        self.serve_idle_qps = float(serve_idle_qps)
        self.serve_idle_occupancy = float(serve_idle_occupancy)
        self.serve_idle_polls = int(serve_idle_polls)
        self._last_event_t: Optional[float] = None
        self._saturated_polls = 0
        self._wait_streak = 0
        self._idle_streak = 0

    def note_event(self, now: float) -> None:
        """Record that a scale action was taken (arms the cooldown)."""
        self._last_event_t = now
        self._saturated_polls = 0
        self._wait_streak = 0
        self._idle_streak = 0

    def decide(self, samples: Sequence[PeerSample], cohort_size: int,
               now: float) -> Decision:
        fresh = [s for s in samples if now - s.time <= self.stale_s]
        if cohort_size < self.min_peers:
            return Decision("grow", "below_min", cohort_size + 1)
        if cohort_size > self.max_peers:
            return Decision("shrink", "above_max", cohort_size - 1)
        if any(s.recovery_active for s in fresh):
            return Decision("hold", "recovery", cohort_size)
        if (self._last_event_t is not None
                and now - self._last_event_t < self.cooldown_s):
            return Decision("hold", "cooldown", cohort_size)
        serve = self._decide_serving(fresh, cohort_size)
        if serve is not None:
            return serve
        depths = [s.queue_depth for s in fresh if s.queue_depth is not None]
        if (depths and cohort_size < self.max_peers
                and max(depths) <= self.starvation_depth):
            return Decision("grow", "starved", cohort_size + 1)
        fills = [s.vbatch_fill for s in fresh if s.vbatch_fill is not None]
        if fills and min(fills) >= self.saturation_fill:
            self._saturated_polls += 1
        else:
            self._saturated_polls = 0
        if (self._saturated_polls >= self.saturate_polls
                and cohort_size > self.min_peers):
            return Decision("shrink", "saturated", cohort_size - 1)
        return Decision("hold", "steady", cohort_size)

    def _decide_serving(self, fresh: Sequence[PeerSample],
                        cohort_size: int) -> Optional[Decision]:
        """Serving-fleet rules: sustained queue-wait grows, sustained idle
        shrinks.  Returns None (and resets the streaks) when no fresh
        sample carries serving signals — training cohorts fall through to
        the starvation/saturation rules untouched."""
        waits = [s.serve_wait for s in fresh if s.serve_wait is not None]
        qpss = [s.serve_qps for s in fresh if s.serve_qps is not None]
        if not waits and not qpss:
            self._wait_streak = 0
            self._idle_streak = 0
            return None
        if waits and max(waits) >= self.serve_wait_grow_s:
            self._wait_streak += 1
        else:
            self._wait_streak = 0
        if self._wait_streak >= self.serve_wait_polls:
            if cohort_size < self.max_peers:
                return Decision("grow", "serve_wait", cohort_size + 1)
            return Decision("hold", "serve_wait_at_max", cohort_size)
        occs = [s.slot_occupancy for s in fresh
                if s.slot_occupancy is not None]
        idle = (qpss and max(qpss) <= self.serve_idle_qps
                and (not waits or max(waits) < self.serve_wait_grow_s)
                and (not occs or max(occs) <= self.serve_idle_occupancy))
        if idle:
            self._idle_streak += 1
        else:
            self._idle_streak = 0
        if (self._idle_streak >= self.serve_idle_polls
                and cohort_size > self.min_peers):
            return Decision("shrink", "serve_idle", cohort_size - 1)
        # Serving signals present but no rule fired: the generic training
        # rules must not interpret a serving fleet's (absent) batcher depth.
        return Decision("hold", "steady", cohort_size)


class SubprocessFleet:
    """Process-level fleet mechanics for the supervisor: spawn workers,
    decommission them via the localdir flag file, read their telemetry
    snapshots, and reap exits.

    ``spawn(name, localdir)`` must start a peer process whose telemetry
    snapshotter writes ``<localdir>/telemetry.jsonl`` (set
    ``MOOLIB_TELEMETRY_DIR=<localdir>`` in its env) and whose train loop
    honors the :data:`DECOMMISSION_FLAG` file (the examples'
    ``--autoscale``-aware loops and the soak workers both do).
    """

    def __init__(self, spawn: Callable[[str, str], subprocess.Popen],
                 base_dir: str, name_prefix: str = "auto",
                 sample_source: Optional["RpcSampleSource"] = None):
        self._spawn = spawn
        self._base_dir = base_dir
        self._prefix = name_prefix
        self._next_idx = 0
        # name -> {"proc", "dir", "decommissioning", "last_steps": (t, n)}
        self._peers: Dict[str, dict] = {}
        # Optional RPC-pull sampling (telemetry.CohortAggregator behind
        # RpcSampleSource): replaces the file-tail reads in samples(), so
        # the fleet can span hosts with no shared filesystem.
        self._sample_source = sample_source

    # ----------------------------------------------------------- inventory
    def peers(self) -> List[str]:
        return list(self._peers)

    def size(self) -> int:
        """Peers counted toward the cohort target: live and not already on
        their way out."""
        self.reap()
        return sum(
            1 for p in self._peers.values()
            if p["proc"].poll() is None and not p["decommissioning"]
        )

    def reap(self) -> List[str]:
        """Drop exited peers from the inventory; returns the names of peers
        that exited WITHOUT being asked to (preemptions — the autoscaler's
        policy sees them only as a smaller cohort, the soak counts them)."""
        preempted = []
        for name in list(self._peers):
            p = self._peers[name]
            if p["proc"].poll() is not None:
                if not p["decommissioning"]:
                    preempted.append(name)
                del self._peers[name]
        return preempted

    # ------------------------------------------------------------- actions
    def grow(self) -> str:
        name = f"{self._prefix}{self._next_idx}"
        self._next_idx += 1
        localdir = os.path.join(self._base_dir, name)
        os.makedirs(localdir, exist_ok=True)
        # A retained flag from a previous peer of the same name must not
        # instantly decommission the new one.
        flag = os.path.join(localdir, DECOMMISSION_FLAG)
        if os.path.exists(flag):
            os.unlink(flag)
        proc = self._spawn(name, localdir)
        self._peers[name] = {
            "proc": proc, "dir": localdir, "decommissioning": False,
            "last_steps": None,
        }
        return name

    def shrink(self) -> Optional[str]:
        """Ask the newest live peer to decommission (drain + graceful leave).
        The flag file is the request; the peer's exit is the completion."""
        candidates = [
            (name, p) for name, p in self._peers.items()
            if p["proc"].poll() is None and not p["decommissioning"]
        ]
        if not candidates:
            return None
        name, p = candidates[-1]
        with open(os.path.join(p["dir"], DECOMMISSION_FLAG), "w") as f:
            f.write(str(time.time()))
        p["decommissioning"] = True
        return name

    def kill(self, name: str) -> bool:
        """Hard-kill a peer (the soak's simulated preemption — SIGKILL, no
        drain, no leave; the cohort recovers via ping eviction + rejoin)."""
        p = self._peers.get(name)
        if p is None or p["proc"].poll() is not None:
            return False
        try:
            os.killpg(p["proc"].pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError, OSError):
            try:
                p["proc"].kill()
            except OSError:
                return False
        return True

    def terminate_all(self, timeout: float = 10.0) -> None:
        for p in self._peers.values():
            if p["proc"].poll() is None:
                try:
                    p["proc"].terminate()
                except OSError:
                    pass
        deadline = time.monotonic() + timeout
        for p in self._peers.values():
            left = deadline - time.monotonic()
            try:
                p["proc"].wait(max(0.1, left))
            except subprocess.TimeoutExpired:
                try:
                    p["proc"].kill()
                except OSError:
                    pass

    # ------------------------------------------------------------- samples
    def samples(self) -> List[PeerSample]:
        if self._sample_source is not None:
            # RPC-pull path: the aggregator scraped every broker-discovered
            # peer; keep only the ones this fleet supervises and considers
            # live (a decommissioning peer still answers RPCs but must stop
            # steering the policy).
            live = {
                name for name, p in self._peers.items()
                if p["proc"].poll() is None and not p["decommissioning"]
            }
            return [s for s in self._sample_source.samples() if s.name in live]
        out = []
        for name, p in self._peers.items():
            if p["proc"].poll() is not None or p["decommissioning"]:
                continue
            snap = read_snapshot_tail(os.path.join(p["dir"], "telemetry.jsonl"))
            if snap is None:
                continue
            s = sample_from_snapshot(name, snap)
            # Step rate from successive snapshot counter deltas.
            if s.steps is not None:
                prev = p["last_steps"]
                if prev is not None and s.time > prev[0]:
                    s.step_rate = (s.steps - prev[1]) / (s.time - prev[0])
                p["last_steps"] = (s.time, s.steps)
            out.append(s)
        return out


class RpcSampleSource:
    """RPC-pull :class:`PeerSample` source behind the same ``samples()``
    interface the policy consumes — the cross-host replacement for the
    file-tail reads above.  Wraps a
    :class:`moolib_tpu_torch.telemetry.CohortAggregator`: each ``samples()`` call
    is one cohort scrape (per-peer timeouts, so a dying peer costs one
    bounded wait, not the poll), with step rates computed from successive
    scrape deltas by the aggregator."""

    def __init__(self, aggregator):
        self._agg = aggregator

    def samples(self) -> List[PeerSample]:
        self._agg.scrape()
        return self._agg.peer_samples()


class Autoscaler:
    """The supervisor loop: poll fleet telemetry, ask the policy, act.

    ``fleet`` is anything with the :class:`SubprocessFleet` surface
    (``size()``, ``samples()``, ``grow()``, ``shrink()``); tests drive the
    policy with synthetic fleets.  Call :meth:`step` from the supervising
    process's loop — it rate-limits itself to ``poll_interval``.
    """

    def __init__(self, policy: AutoscalePolicy, fleet, *,
                 poll_interval: float = 2.0):
        self.policy = policy
        self.fleet = fleet
        self.poll_interval = float(poll_interval)
        self._last_poll = 0.0
        self.events: List[dict] = []  # scale/hold log for harnesses

    def step(self, now: Optional[float] = None) -> Optional[Decision]:
        """One supervision tick; returns the decision when a poll ran."""
        t = time.time() if now is None else now
        if t - self._last_poll < self.poll_interval:
            return None
        self._last_poll = t
        samples = self.fleet.samples()
        cohort = self.fleet.size()
        decision = self.policy.decide(samples, cohort, t)
        _M_COHORT.set(float(cohort))
        _M_TARGET.set(float(decision.target))
        if decision.action == "grow":
            name = self.fleet.grow()
            self.policy.note_event(t)
            _M_EVENTS.inc(direction="up")
            telemetry.flight_event("autoscaler.grow", peer=name,
                                   reason=decision.reason, cohort=cohort)
            utils.log_info(
                "autoscaler: grow %s (%s, cohort %d -> %d)",
                name, decision.reason, cohort, decision.target,
            )
            self.events.append({"time": t, "action": "grow", "peer": name,
                                "reason": decision.reason, "cohort": cohort})
        elif decision.action == "shrink":
            name = self.fleet.shrink()
            if name is not None:
                self.policy.note_event(t)
                _M_EVENTS.inc(direction="down")
                telemetry.flight_event("autoscaler.shrink", peer=name,
                                       reason=decision.reason, cohort=cohort)
                utils.log_info(
                    "autoscaler: decommission %s (%s, cohort %d -> %d)",
                    name, decision.reason, cohort, decision.target,
                )
                self.events.append({"time": t, "action": "shrink", "peer": name,
                                    "reason": decision.reason, "cohort": cohort})
        else:
            _M_HOLDS.inc(reason=decision.reason)
        return decision


def decommission_requested(localdir: Optional[str]) -> bool:
    """Train-loop helper: has the supervisor dropped the decommission flag?
    Cheap enough to poll every iteration."""
    if not localdir:
        return False
    return os.path.exists(os.path.join(localdir, DECOMMISSION_FLAG))


def example_spawn(connect_addr: str, base_dir: str, module: str,
                  extra_args: Sequence[str] = ()) -> Callable[[str, str], subprocess.Popen]:
    """A ``SubprocessFleet`` spawn callable that launches one of the port's
    example trainers (``module``, e.g. ``moolib_tpu_torch.examples.lm``) as
    a worker peer.  ``connect_addr`` may be comma-separated — the full
    broker list — in which case workers get ``--broker_addrs`` and survive
    a broker failover mid-fleet.

    Workers run on the card by default, as every entry point of the port
    does: each child creates its own CUDA context (about 0.5 GB of device
    memory before any tensor), so ``max_peers`` workers on one card cost
    that much each.  A CPU fleet passes ``--device cpu`` in
    ``extra_args``; nothing here chooses a device for the worker."""
    connect_flag = "--broker_addrs" if "," in connect_addr else "--connect"

    def spawn(name: str, localdir: str) -> subprocess.Popen:
        env = dict(os.environ)
        env["MOOLIB_TELEMETRY_DIR"] = localdir
        env.setdefault("MOOLIB_TELEMETRY_INTERVAL", "1")
        cmd = [
            sys.executable, "-m", module,
            connect_flag, connect_addr,
            "--local_name", name,
            "--localdir", localdir,
            *extra_args,
        ]
        log = open(os.path.join(localdir, "worker.log"), "ab")
        try:
            return subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT, env=env,
                start_new_session=True,  # killpg must not take the supervisor down
            )
        finally:
            log.close()  # the child holds its own descriptor

    return spawn
