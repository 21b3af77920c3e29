"""Cohort metrics aggregator: one fused view of every peer's registry — the
port of the JAX package's ``telemetry/aggregator.py``, the same endpoints
and row shapes, so a JAX aggregator scrapes port peers and the reverse.

The aggregator rides the broker's discovery surface: ``__broker_list``
names the live cohort (contributing members AND observers — serving
replicas, standbys), each of which answers a ``__telemetry_snapshot`` RPC
with the same JSON row shape the
:class:`~moolib_tpu_torch.telemetry.exporters.JsonlSnapshotter` writes.
The fused result exposes per-peer-labeled Prometheus text / JSONL.

Wiring: every peer that should be scrapable calls
:func:`install_rpc_handlers` on its ``Rpc`` (the serving replica and the
Accumulator do this by default); the aggregating process connects an
``Rpc`` to the broker and polls :meth:`CohortAggregator.scrape`.  A peer
dying mid-scrape costs one per-peer timeout and an
``aggregator_scrape_errors_total`` increment — never the scrape.

The ``__telemetry_profile`` handler makes every scrapable peer remotely
profilable: it opens and closes an on-demand ``torch.profiler`` window
(:mod:`moolib_tpu_torch.telemetry.profiling`), answering as the JAX
package's handler does.  :meth:`CohortAggregator.peer_samples` turns a
scrape into the autoscaler's ``PeerSample`` rows.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Union

from . import exporters, metrics, tracing

__all__ = [
    "install_rpc_handlers",
    "CohortAggregator",
    "fused_prometheus_text",
]

_REG = metrics.get_registry()
_M_SCRAPES = _REG.counter(
    "aggregator_scrapes_total", "cohort scrape rounds completed"
)
_M_SCRAPE_ERRORS = _REG.counter(
    "aggregator_scrape_errors_total",
    "per-peer snapshot pulls that failed or timed out",
    ("peer",),
)
_M_PEERS = _REG.gauge(
    "aggregator_peers", "peers in the last fused snapshot"
)
_M_SKEW = _REG.gauge(
    "cohort_step_skew_ratio",
    "slowest peer's fused per-step seconds / cohort median (step_skew)",
)
_M_PEER_STEP = _REG.gauge(
    "cohort_peer_step_seconds",
    "per-peer fused step seconds (train dispatch + psum share-down) from "
    "the last two scrapes",
    ("peer",),
)
_M_SCRAPE_SECONDS = _REG.histogram(
    "aggregator_scrape_seconds",
    "per-peer snapshot pull wall time within a scrape (timeouts land at "
    "the per-peer cap)",
    ("peer",),
)

_INSTALLED_FLAG = "_moolib_telemetry_handlers"


def install_rpc_handlers(
    rpc,
    registry: Optional[metrics.Registry] = None,
    tracer: Optional[tracing.Tracer] = None,
) -> bool:
    """Define the ``__telemetry_*`` endpoints on ``rpc`` (idempotent):

    - ``__telemetry_snapshot()`` → ``{"time", "pid", "name", "metrics"}`` —
      the JSONL row shape the JAX package's autoscaler consumes.
    - ``__telemetry_trace()`` → this peer's Chrome trace dict (feed files to
      ``scripts/trace_merge.py``).
    - ``__telemetry_profile(action, logdir=None, seconds=None)`` → on-demand
      ``torch.profiler`` window control (``profiling.handle_command``:
      start / stop / status / window).

    Returns False when the endpoints were already installed on this ``rpc``.
    """
    if getattr(rpc, _INSTALLED_FLAG, False):
        return False
    reg = registry or metrics.get_registry()
    tr = tracer or tracing.get_tracer()

    def _snapshot():
        from .flightrec import get_flight_recorder

        return {
            "time": time.time(),
            "pid": os.getpid(),
            "name": rpc.get_name(),
            "metrics": reg.snapshot(),
            # Last flight-recorder entries, newest last — the cohort console
            # (scripts/mtop.py) shows this tail per peer.
            "flight": [
                {"time": t, "name": n, "args": a}
                for t, n, a in get_flight_recorder().events()[-16:]
            ],
        }

    def _trace():
        return tr.chrome_trace()

    def _profile(action: str, logdir: Optional[str] = None, seconds: Optional[float] = None):
        from . import profiling

        return profiling.handle_command(action, logdir=logdir, seconds=seconds)

    rpc.define("__telemetry_snapshot", _snapshot)
    rpc.define("__telemetry_trace", _trace)
    rpc.define("__telemetry_profile", _profile)
    setattr(rpc, _INSTALLED_FLAG, True)
    return True


class CohortAggregator:
    """Pull every broker-discovered peer's registry snapshot over RPC and
    fuse them into one per-peer-labeled view.

    ``rpc`` must be connected (or connectable by gossip) to at least one of
    ``brokers`` — the same client contract as ``ServeClient``.  Peers are
    reached by their broker-advertised names through ``__moolib_find_peer``
    gossip; no address bookkeeping here.
    """

    def __init__(
        self,
        rpc,
        brokers: Union[str, Sequence[str]],
        group: str = "default",
        scrape_timeout: float = 2.0,
        include_observers: bool = True,
        include_self: bool = False,
        peer_timeout: Optional[float] = None,
    ):
        self._rpc = rpc
        self._brokers = [brokers] if isinstance(brokers, str) else list(brokers)
        if not self._brokers:
            raise ValueError("need at least one broker peer name")
        self._group = group
        self._timeout = float(scrape_timeout)
        # Per-peer cap within a scrape, so one wedged peer can't consume the
        # whole shared deadline and stall every later peer's collection (the
        # mtop refresh tick).  Resolution: constructor arg >
        # MOOLIB_AGGREGATOR_SCRAPE_TIMEOUT env > the shared scrape timeout.
        if peer_timeout is None:
            env = os.environ.get("MOOLIB_AGGREGATOR_SCRAPE_TIMEOUT")
            if env:
                try:
                    peer_timeout = float(env)
                except ValueError:
                    peer_timeout = None
        self._peer_timeout = (
            float(peer_timeout)
            if peer_timeout and peer_timeout > 0
            else self._timeout
        )
        self._include_observers = include_observers
        self._include_self = include_self
        self._lock = threading.Lock()
        self._roster: Dict[str, str] = {}  # name -> role
        self._fused: Dict[str, Any] = {"time": 0.0, "peers": {}, "errors": {}}
        self._last_steps: Dict[str, tuple] = {}  # peer -> (time, steps)
        # step_skew() state: peer -> (dispatch_sum, dispatch_count,
        # psum_sum, psum_count) from the previous call, so per-peer step
        # time reflects the window BETWEEN skew computations, not lifetime.
        self._skew_state: Dict[str, tuple] = {}
        self._straggler_streak: tuple = (None, 0)  # (peer, consecutive flags)
        self._straggler_announced: Optional[str] = None

    # ------------------------------------------------------------ discovery
    def discover(self) -> Dict[str, str]:
        """Refresh the roster from the first broker that answers
        ``__broker_list``; on total silence the last roster is kept (a
        scrape through a broker failover degrades, it doesn't blank)."""
        for broker in self._brokers:
            try:
                listing = self._rpc.async_(
                    broker, "__broker_list", self._group
                ).result(self._timeout)
            except Exception:  # noqa: BLE001 — next broker owns this
                continue
            if not isinstance(listing, dict):
                continue
            roster: Dict[str, str] = {}
            for m in listing.get("members") or ():
                roster[m] = "member"
            if self._include_observers:
                for name, role in (listing.get("observers") or {}).items():
                    roster.setdefault(name, role or "observer")
            if not self._include_self:
                roster.pop(self._rpc.get_name(), None)
            with self._lock:
                self._roster = roster
            return dict(roster)
        with self._lock:
            return dict(self._roster)

    # -------------------------------------------------------------- scraping
    def scrape(self) -> Dict[str, Any]:
        """One fused pull: discover, fan out ``__telemetry_snapshot`` to
        every peer concurrently, collect under a shared deadline.  Returns
        (and caches) ``{"time", "peers": {name: row}, "errors": {name:
        reason}}``; a peer that died mid-scrape lands in ``errors`` and
        costs at most the scrape timeout in wall clock."""
        roster = self.discover()
        futures = {
            name: self._rpc.async_(name, "__telemetry_snapshot") for name in roster
        }
        deadline = time.monotonic() + self._timeout
        peers: Dict[str, Any] = {}
        errors: Dict[str, str] = {}
        for name, fut in futures.items():
            t0 = time.monotonic()
            try:
                row = fut.result(
                    max(0.05, min(self._peer_timeout, deadline - time.monotonic()))
                )
            except Exception as e:  # noqa: BLE001 — per-peer failure isolated
                fut.cancel()
                _M_SCRAPE_SECONDS.observe(time.monotonic() - t0, peer=name)
                errors[name] = str(e) or type(e).__name__
                _M_SCRAPE_ERRORS.inc(peer=name)
                continue
            _M_SCRAPE_SECONDS.observe(time.monotonic() - t0, peer=name)
            if isinstance(row, dict) and "metrics" in row:
                row.setdefault("name", name)
                row["role"] = roster.get(name, "member")
                peers[name] = row
            else:
                errors[name] = "malformed snapshot"
                _M_SCRAPE_ERRORS.inc(peer=name)
        fused = {"time": time.time(), "peers": peers, "errors": errors}
        with self._lock:
            self._fused = fused
        _M_SCRAPES.inc()
        _M_PEERS.set(len(peers))
        return fused

    def snapshot(self) -> Dict[str, Any]:
        """The last fused scrape (without pulling again)."""
        with self._lock:
            return self._fused

    # ------------------------------------------------------------ exposition
    def prometheus_text(self) -> str:
        """The last fused scrape as Prometheus text with a ``peer`` label
        on every series."""
        with self._lock:
            peers = self._fused["peers"]
        return fused_prometheus_text(peers)

    def write_jsonl(self, path: str) -> None:
        """Append the last fused scrape as one JSON line (the cohort-level
        analogue of the per-process ``telemetry.jsonl``)."""
        with self._lock:
            fused = self._fused
        with open(path, "a") as f:
            f.write(json.dumps(fused) + "\n")

    # ------------------------------------------------------------ autoscaler
    def peer_samples(self) -> List[Any]:
        """The last fused scrape as :class:`moolib_tpu_torch.autoscaler.PeerSample`
        rows, with step rates from successive scrape deltas — the RPC-pull
        counterpart of ``SubprocessFleet.samples()``."""
        from .. import autoscaler  # deferred: autoscaler imports telemetry

        with self._lock:
            peers = dict(self._fused["peers"])
        out = []
        for name, row in peers.items():
            s = autoscaler.sample_from_snapshot(name, row)
            if s.steps is not None:
                prev = self._last_steps.get(name)
                # A counter BELOW the previous reading means the peer
                # restarted (registry counters never decrease): treat it as
                # fresh rather than publishing a negative rate the policy
                # would read as a stall.
                if prev is not None and s.time > prev[0] and s.steps >= prev[1]:
                    s.step_rate = (s.steps - prev[1]) / (s.time - prev[0])
                self._last_steps[name] = (s.time, s.steps)
            out.append(s)
        # Peers that left the cohort must not pin their last reading forever
        # (a name reused by a respawned peer would inherit a stale delta).
        for gone in set(self._last_steps) - set(peers):
            del self._last_steps[gone]
        return out

    # ----------------------------------------------------------- cohort skew
    @staticmethod
    def _hist_totals(metrics_snap: Dict[str, Any], name: str) -> tuple:
        """(sum, count) across every series of one histogram family in a
        peer's snapshot — the cumulative figures the skew deltas work on."""
        fam = metrics_snap.get(name) or {}
        total, count = 0.0, 0.0
        for s in fam.get("series", ()):
            v = s.get("value")
            if isinstance(v, dict):
                total += float(v.get("sum", 0.0))
                count += float(v.get("count", 0.0))
        return total, count

    def step_skew(self, threshold: float = 1.5, sustain: int = 3) -> Dict[str, Any]:
        """Per-peer straggler attribution from the last fused scrape
        (devmon's cohort sub-plane, docs/TELEMETRY.md "Device performance
        plane").

        Fuses each peer's ``train_step_dispatch_seconds`` and
        ``accum_psum_seconds`` histograms into one per-step wall figure —
        computed over the window since the previous ``step_skew`` call
        (cumulative sum/count deltas), so a recovered peer stops looking
        slow one window later.  Publishes ``cohort_step_skew_ratio``
        (slowest / cohort median) and ``cohort_peer_step_seconds{peer}``;
        when the SAME peer stays above ``threshold`` for ``sustain``
        consecutive calls, one ``devmon.straggler`` flight event names it
        (re-armed when the peer recovers or the straggler moves).

        Returns ``{"ratio", "peers": {name: {...}}, "straggler",
        "sustained"}``; ratio 1.0 with no straggler when fewer than two
        peers report step timings.
        """
        with self._lock:
            peers = dict(self._fused["peers"])
        cur: Dict[str, tuple] = {}
        per_peer: Dict[str, Dict[str, float]] = {}
        for name, row in peers.items():
            met = row.get("metrics") or {}
            d_sum, d_cnt = self._hist_totals(met, "train_step_dispatch_seconds")
            p_sum, p_cnt = self._hist_totals(met, "accum_psum_seconds")
            cur[name] = (d_sum, d_cnt, p_sum, p_cnt)
            prev = self._skew_state.get(name)
            # Window deltas when we have a previous reading and the counters
            # moved forward (a restart resets them — fall back to lifetime).
            if prev is not None and d_cnt > prev[1] and d_sum >= prev[0]:
                dd_sum, dd_cnt = d_sum - prev[0], d_cnt - prev[1]
                dp_sum = max(0.0, p_sum - prev[2])
                dp_cnt = max(0.0, p_cnt - prev[3])
            else:
                dd_sum, dd_cnt, dp_sum, dp_cnt = d_sum, d_cnt, p_sum, p_cnt
            if dd_cnt <= 0:
                continue  # no step timing from this peer (e.g. pure server)
            dispatch = dd_sum / dd_cnt
            psum = dp_sum / dp_cnt if dp_cnt > 0 else 0.0
            per_peer[name] = {
                "step_seconds": dispatch + psum,
                "dispatch_seconds": dispatch,
                "psum_seconds": psum,
            }
        self._skew_state = cur  # prune dead peers with the same assignment
        for name, row in per_peer.items():
            _M_PEER_STEP.set(row["step_seconds"], peer=name)
        if len(per_peer) < 2:
            _M_SKEW.set(1.0)
            self._straggler_streak = (None, 0)
            self._straggler_announced = None
            return {"ratio": 1.0, "peers": per_peer, "straggler": None,
                    "sustained": False}
        times = sorted(r["step_seconds"] for r in per_peer.values())
        median = times[len(times) // 2]
        slowest = max(per_peer, key=lambda n: per_peer[n]["step_seconds"])
        ratio = (per_peer[slowest]["step_seconds"] / median) if median > 0 else 1.0
        _M_SKEW.set(ratio)
        candidate = slowest if ratio >= threshold else None
        last_peer, streak = self._straggler_streak
        streak = streak + 1 if (candidate and candidate == last_peer) else (
            1 if candidate else 0
        )
        self._straggler_streak = (candidate, streak)
        if candidate != self._straggler_announced:
            self._straggler_announced = None
        sustained = bool(candidate) and streak >= sustain
        if sustained and self._straggler_announced != candidate:
            self._straggler_announced = candidate
            from .flightrec import flight_event

            flight_event(
                "devmon.straggler",
                peer=candidate,
                ratio=round(ratio, 2),
                step_seconds=round(per_peer[candidate]["step_seconds"], 4),
                median_seconds=round(median, 4),
            )
        return {"ratio": ratio, "peers": per_peer, "straggler": candidate,
                "sustained": sustained}


def fused_prometheus_text(peers: Dict[str, Dict[str, Any]]) -> str:
    """Merge per-peer registry snapshots (``{peer: {"metrics": ...}}`` rows)
    into one Prometheus exposition with a ``peer`` label on every series."""
    # family name -> {"kind", "help", "buckets"?, "series": [(labels, value)]}
    fams: Dict[str, Dict[str, Any]] = {}
    for peer in sorted(peers):
        met = peers[peer].get("metrics") or {}
        for name in sorted(met):
            fam = met[name]
            dst = fams.setdefault(
                name,
                {
                    "kind": fam.get("kind", "gauge"),
                    "help": fam.get("help", ""),
                    "buckets": fam.get("buckets"),
                    "series": [],
                },
            )
            for s in fam.get("series", ()):
                labels = dict(s.get("labels") or {})
                labels["peer"] = peer
                dst["series"].append((labels, s.get("value")))
    lines: List[str] = []
    fmt_labels = exporters._fmt_labels
    fmt_value = exporters._fmt_value
    for name in sorted(fams):
        fam = fams[name]
        if fam["help"]:
            lines.append(f"# HELP {name} {fam['help']}")
        lines.append(f"# TYPE {name} {fam['kind']}")
        if fam["kind"] == "histogram":
            bounds = fam.get("buckets") or ()
            for labels, h in fam["series"]:
                if not isinstance(h, dict):
                    continue
                cum = 0
                for bound, n in zip(bounds, h.get("buckets", ())):
                    cum += n
                    lines.append(
                        f"{name}_bucket{fmt_labels(labels, ('le', fmt_value(bound)))} {cum}"
                    )
                hb = h.get("buckets", ())
                cum += hb[-1] if len(hb) > len(bounds) else 0
                lines.append(f"{name}_bucket{fmt_labels(labels, ('le', '+Inf'))} {cum}")
                lines.append(f"{name}_sum{fmt_labels(labels)} {fmt_value(h.get('sum', 0.0))}")
                lines.append(f"{name}_count{fmt_labels(labels)} {h.get('count', 0)}")
        else:
            for labels, v in fam["series"]:
                if v is None:
                    continue
                lines.append(f"{name}{fmt_labels(labels)} {fmt_value(v)}")
    return "\n".join(lines) + "\n"
