"""Broker: replicated (and stateless-restartable) membership registry.

Counterpart of the reference's ``BrokerService`` (``src/broker.h:99-237``) and
broker CLI (``py/moolib/broker.py:21-40``).  Peers ping the broker with their
group name; the broker evicts peers whose pings stop, and on any membership
change bumps the group's epoch (``sync_id``) and pushes the new sorted member
list to every member.  Allreduce epochs are keyed by ``sync_id``, which is
what makes the whole stack elastic: a pushed update cancels in-flight
reductions on the clients (see ``moolib_tpu_torch.group``).

High availability (docs/RESILIENCE.md "Broker failover"): a **primary**
broker replicates every group's state (members, observers, hosts,
``sync_id``) to hot-standby brokers via ``__broker_replicate`` on the
``update()`` cadence.  A standby that stops hearing from its primary for
``promote_grace`` seconds promotes itself on the first member ping it
receives, bumping a monotonic **generation**.  The generation rides in every
ping reply, epoch push, and replication frame and acts as a split-brain
fence: a zombie ex-primary that comes back (process un-wedges, partition
heals) sees a higher generation — in a peer ping or in replication from the
new primary — and demotes itself to standby; peers reject its stale epoch
pushes by the same fence.  Generation ties (two standbys promoted during the
same chaos window) break deterministically on the broker name, so exactly
one primary survives any heal.

Run standalone with ``python -m moolib_tpu_torch.broker`` (``--brokers`` with the
full address list + ``--standby`` for the hot spares).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence

from . import telemetry, utils
from .rpc import Rpc

_REG = telemetry.get_registry()
_M_SYNC_REPAIRS = _REG.counter(
    "broker_sync_id_repairs_total",
    "Higher client sync_id absorbed by the broker (restarted-broker / "
    "clock-skew epoch repair; each one is a cohort that outran this broker)",
)
_M_PROMOTIONS = _REG.counter(
    "broker_promotions_total", "Standby-to-primary takeovers (generation bumps)"
)
_M_DEMOTIONS = _REG.counter(
    "broker_demotions_total",
    "Primary-to-standby demotions (zombie fenced by a higher generation)",
)
_M_REPL_APPLIED = _REG.counter(
    "broker_replications_total", "Replication snapshots applied from a primary"
)
_M_REPL_REJECTS = _REG.counter(
    "broker_replication_rejects_total",
    "Replication snapshots rejected for carrying a stale generation",
)
_M_GENERATION = _REG.gauge(
    "broker_generation", "This broker's current generation fence value"
)
_M_IS_PRIMARY = _REG.gauge(
    "broker_is_primary", "1 while this broker is the serving primary, else 0"
)


class _BrokerGroup:
    __slots__ = ("name", "members", "observers", "sync_id", "active_members",
                 "active_hosts", "needs_update", "last_update")

    def __init__(self, name: str):
        self.name = name
        # peer name -> {"last_ping": t, "sort_order": int, "host": str|None}
        self.members: Dict[str, dict] = {}
        # Non-contributing members (serving replicas, observers): registered
        # for liveness + discovery (``__broker_list``) but NEVER part of the
        # membership epoch — joining, leaving, or dying must not bump
        # ``sync_id`` (an epoch bump cancels the cohort's in-flight
        # reductions; a serving replica must not be able to do that).
        # peer name -> {"last_ping": t, "role": str}
        self.observers: Dict[str, dict] = {}
        self.sync_id = int(time.time() * 1000) % (1 << 40)
        self.active_members: list = []
        # Host map SNAPSHOTTED at the epoch bump: resync must serve exactly
        # what the epoch push served (ring_auto input, wire protocol), not a
        # live view that may have mutated inside the bump rate-limit window.
        self.active_hosts: Dict[str, Optional[str]] = {}
        self.needs_update = False
        self.last_update = 0.0


class Broker:
    """Coordinates a cohort during training (same API as the reference)."""

    def __init__(self, rpc: Optional[Rpc] = None, standby: bool = False):
        self._rpc = rpc if rpc is not None else Rpc()
        self._groups: Dict[str, _BrokerGroup] = {}
        self._timeout = 10.0
        # _on_ping/_on_resync run on the Rpc handler thread pool, concurrently
        # with update() on the caller thread; all group/member/sync_id state is
        # guarded here (push RPCs are issued outside the lock).
        self._lock = threading.Lock()
        # --- high availability ------------------------------------------
        # The generation fence: bumped on every standby takeover, carried in
        # ping replies, epoch pushes, and replication; higher wins, ties
        # break on the broker name (deterministic single survivor).
        self._generation = 1
        self._primary = not standby
        self._peer_broker_addrs: List[str] = []
        self._replicate_interval = 0.5
        self._last_replicate_tx = 0.0
        # Standby promotion clock: how long since the primary last proved it
        # was alive (a replication snapshot landed here).  Seeded with "now"
        # so a freshly-started standby gives the primary one full grace
        # window before it will take over.
        self._last_replicate_rx = time.monotonic()
        self._promote_grace = 3.0
        self._rpc.define("__broker_ping", self._on_ping)
        self._rpc.define("__broker_resync", self._on_resync)
        self._rpc.define("__broker_leave", self._on_leave)
        self._rpc.define("__broker_list", self._on_list)
        self._rpc.define("__broker_replicate", self._on_replicate)
        self._rpc.define("__broker_status", self._on_status)
        _M_GENERATION.set(self._generation)
        _M_IS_PRIMARY.set(1.0 if self._primary else 0.0)

    # transparent passthroughs ------------------------------------------------
    def set_name(self, name: str) -> None:
        self._rpc.set_name(name)

    def connect(self, address: str) -> None:
        """Connect the broker's Rpc to an existing peer/network (reference
        ``Broker`` passthrough, ``src/broker.h:240-265``)."""
        self._rpc.connect(address)

    def listen(self, address: str) -> None:
        self._rpc.listen(address)

    def set_timeout(self, seconds: float) -> None:
        self._timeout = float(seconds)

    @property
    def rpc(self) -> Rpc:
        return self._rpc

    # high-availability api ---------------------------------------------------
    def set_peer_brokers(self, addresses: Sequence[str]) -> None:
        """Addresses of the OTHER brokers in this control plane.  A primary
        replicates group state to them every ``replicate_interval``; a
        standby expects replication FROM one of them and promotes itself
        when it goes quiet past ``promote_grace``."""
        self._peer_broker_addrs = [a for a in addresses if a]
        for a in self._peer_broker_addrs:
            self._rpc.connect(a)

    def set_replicate_interval(self, seconds: float) -> None:
        self._replicate_interval = float(seconds)

    def set_promote_grace(self, seconds: float) -> None:
        """How long a standby waits after the last replication snapshot
        before a member ping makes it take over as primary."""
        self._promote_grace = float(seconds)

    @property
    def is_primary(self) -> bool:
        return self._primary

    @property
    def generation(self) -> int:
        return self._generation

    def _promote_locked(self, now: float) -> None:
        """Standby takeover: bump the generation fence and re-publish every
        replicated group as a fresh epoch.  Members get a full ping window
        (their replicated liveness stamps are re-stamped at apply/promote
        time) before eviction can touch them."""
        self._primary = True
        self._generation += 1
        _M_PROMOTIONS.inc()
        _M_GENERATION.set(self._generation)
        _M_IS_PRIMARY.set(1.0)
        for g in self._groups.values():
            for m in g.members.values():
                m["last_ping"] = now
            for o in g.observers.values():
                o["last_ping"] = now
            if g.members:
                g.needs_update = True
                g.last_update = 0.0  # bypass the churn rate limit: push now
        utils.log_info(
            "broker %s: promoted to primary, generation=%d (groups: %s)",
            self._rpc.get_name(), self._generation, sorted(self._groups),
        )

    def _demote_locked(self, seen_generation: int, why: str) -> None:
        """Generation fence tripped: somebody with a higher (or tie-winning)
        generation is primary.  Become a standby; the winner's replication
        stream will overwrite our group state."""
        if self._primary:
            _M_DEMOTIONS.inc()
            utils.log_info(
                "broker %s: demoted to standby (%s, generation %d -> %d)",
                self._rpc.get_name(), why, self._generation, seen_generation,
            )
        self._primary = False
        self._generation = max(self._generation, int(seen_generation))
        # Restart the promotion clock: don't instantly take back over.
        self._last_replicate_rx = time.monotonic()
        _M_GENERATION.set(self._generation)
        _M_IS_PRIMARY.set(0.0)

    # service -----------------------------------------------------------------
    def _standby_reply(self) -> dict:
        return {
            "sync_id": None,
            "timeout": self._timeout,
            "generation": self._generation,
            "standby": True,
        }

    def _on_ping(self, group_name: str, peer_name: str, sort_order: int, client_sync_id,
                 host: Optional[str] = None, role: str = "member",
                 generation: Optional[int] = None):
        now = time.monotonic()
        with self._lock:
            if generation is not None and generation > self._generation:
                if self._primary and self._peer_broker_addrs:
                    # Zombie fence: a peer already follows a higher-generation
                    # primary — we lost a takeover we never saw.  Stand down;
                    # the peer's failover scan will route it to the winner.
                    self._demote_locked(generation, f"peer {peer_name} pinged gen {generation}")
                    return self._standby_reply()
                # No other broker exists (legacy single-broker deployment, or
                # a fresh restart of the only broker): absorb the generation
                # instead of wedging the cohort behind an unreachable fence.
                self._generation = int(generation)
                _M_GENERATION.set(self._generation)
            if not self._primary:
                if now - self._last_replicate_rx <= self._promote_grace:
                    return self._standby_reply()
                # The primary has been silent past the grace window and a
                # member is knocking: take over.
                self._promote_locked(now)
            g = self._groups.setdefault(group_name, _BrokerGroup(group_name))
            if role != "member":
                # Observer ping: track liveness/role only.  If the peer was
                # previously a contributing member (role change mid-life),
                # it leaves the epoch like any other departure.
                g.observers[peer_name] = {
                    "last_ping": now, "role": str(role),
                }
                if peer_name in g.members:
                    del g.members[peer_name]
                    g.needs_update = True
                return {"sync_id": g.sync_id, "timeout": self._timeout,
                        "generation": self._generation}
            g.observers.pop(peer_name, None)
            # Stateless restart safety: clients ignore epoch pushes that don't
            # EXCEED their current sync_id, so a freshly-restarted broker must
            # jump past any epoch still alive in the cohort. Wall-clock seeding
            # usually guarantees that; a pinged-in higher sync_id (clock skew,
            # regressed clock — or a generation takeover, where the new
            # primary must outrun epochs the old one minted) covers the rest.
            if client_sync_id is not None and client_sync_id > g.sync_id:
                _M_SYNC_REPAIRS.inc()
                utils.log_info(
                    "broker %s: WARNING sync_id repair in group %s: client %s "
                    "pinged %d > broker %d (restart/skew/takeover) — jumping past it",
                    self._rpc.get_name(), group_name, peer_name,
                    int(client_sync_id), g.sync_id,
                )
                g.sync_id = int(client_sync_id) + 1
                g.needs_update = True
            m = g.members.get(peer_name)
            if m is None:
                g.members[peer_name] = {
                    "last_ping": now, "sort_order": sort_order, "host": host,
                }
                g.needs_update = True
            else:
                m["last_ping"] = now
                m["sort_order"] = sort_order
                if m.get("host") != host:
                    # A member's machine changed (same-name restart elsewhere
                    # within the ping timeout): the host map is part of the
                    # epoch contract (ring_auto input), so it must reach the
                    # cohort via a push — never by silent divergence.
                    m["host"] = host
                    g.needs_update = True
            return {"sync_id": g.sync_id, "timeout": self._timeout,
                    "generation": self._generation}

    def _hosts_locked(self, g: _BrokerGroup, members: list) -> Dict[str, Optional[str]]:
        """Machine identity (boot id) per member, as pinged in.  Pushed with
        every membership epoch so all members share ONE consistent view —
        the tree-vs-ring auto-selection (``Group.ring_auto``) is part of the
        wire protocol and must be decided identically cohort-wide."""
        return {name: (g.members[name].get("host") if name in g.members else None)
                for name in members}

    def _bump_locked(self, g: _BrokerGroup, now: float) -> list:
        """Advance the group's epoch and snapshot the member/host views.
        Returns the push list to issue OUTSIDE the lock."""
        g.needs_update = False
        g.last_update = now
        g.sync_id += 1
        g.active_members = sorted(
            g.members, key=lambda n: (g.members[n]["sort_order"], n)
        )
        utils.log_info(
            "broker: group %s sync_id=%d gen=%d members=%s",
            g.name,
            g.sync_id,
            self._generation,
            g.active_members,
        )
        members = list(g.active_members)
        g.active_hosts = self._hosts_locked(g, members)
        hosts = dict(g.active_hosts)
        return [(name, g.name, g.sync_id, members, hosts, self._generation)
                for name in members]

    def _on_leave(self, group_name: str, peer_name: str):
        """Graceful decommission: the peer announces its departure instead of
        going silent, so the cohort doesn't burn the ping-eviction timeout.
        The epoch bumps and pushes IMMEDIATELY — bypassing both the update()
        cadence and the churn rate limit — because a decommission is a planned,
        already-drained event: remaining members should re-form now."""
        with self._lock:
            if not self._primary:
                # A standby can't mint the epoch; the leaver falls back to
                # ping-silence eviction on whichever broker is primary.
                return {"left": False, "standby": True, "generation": self._generation}
            g = self._groups.get(group_name)
            if g is None:
                return {"left": False}
            if peer_name in g.observers:
                # Observer decommission: no epoch to bump, just deregister
                # (so ``__broker_list`` stops advertising it immediately —
                # the client-visible analogue of the member fast path).
                del g.observers[peer_name]
                return {"left": True, "sync_id": g.sync_id}
            if peer_name not in g.members:
                return {"left": False}
            del g.members[peer_name]
            pushes = self._bump_locked(g, time.monotonic())
            sync_id = g.sync_id
        for push in pushes:
            self._push_to(*push)
        return {"left": True, "sync_id": sync_id}

    def _on_list(self, group_name: str):
        """Discovery for non-members (``serving.ServeClient``): the live
        contributing roster (last epoch snapshot) plus the live observers
        with their roles.  Observers are a LIVE view — they have no epoch,
        and a client failing over wants the freshest liveness the broker
        has, not a rate-limited snapshot.  Standbys serve this too, from
        replicated state: discovery stays available while a failover is
        still electing the next primary."""
        with self._lock:
            g = self._groups.get(group_name)
            if g is None:
                return {"sync_id": None, "members": [], "observers": {},
                        "generation": self._generation,
                        "standby": not self._primary}
            return {
                "sync_id": g.sync_id,
                "members": list(g.active_members),
                "observers": {n: m["role"] for n, m in g.observers.items()},
                "generation": self._generation,
                "standby": not self._primary,
            }

    def _on_resync(self, group_name: str, peer_name: str):
        """A client whose sync_id went stale asks for the member list again."""
        with self._lock:
            if not self._primary:
                return {"sync_id": None, "standby": True,
                        "generation": self._generation}
            g = self._groups.get(group_name)
            if g is None:
                return None
            push = (g.name, g.sync_id, list(g.active_members),
                    dict(g.active_hosts), self._generation)
        self._push_to(peer_name, *push)
        return {"sync_id": push[1], "generation": push[4]}

    def _on_status(self):
        """Read-only probe for failover scans: who am I, what generation,
        am I serving.  Never mutates state (unlike a ping, this must not
        promote a standby — a scan is a question, not a vote)."""
        with self._lock:
            return {
                "name": self._rpc.get_name(),
                "generation": self._generation,
                "primary": self._primary,
                "groups": {name: g.sync_id for name, g in self._groups.items()},
                "timeout": self._timeout,
            }

    # replication -------------------------------------------------------------
    def _snapshot_locked(self) -> dict:
        return {
            g.name: {
                "sync_id": g.sync_id,
                "members": {
                    n: {"sort_order": m["sort_order"], "host": m.get("host")}
                    for n, m in g.members.items()
                },
                "observers": {n: {"role": m["role"]} for n, m in g.observers.items()},
                "active_members": list(g.active_members),
                "active_hosts": dict(g.active_hosts),
            }
            for g in self._groups.values()
        }

    def _on_replicate(self, from_name: str, generation: int, state: dict):
        """A primary's state snapshot.  Accept iff the sender wins the
        generation fence against us ((generation, name) — higher generation
        wins, name breaks ties); otherwise reject so the STALE sender
        demotes.  This exchange is the post-partition-heal convergence
        mechanism in both directions: whichever of two transient primaries
        loses the fence becomes the other's standby."""
        now = time.monotonic()
        with self._lock:
            generation = int(generation)
            if self._primary:
                # Primary-vs-primary: the (generation, name) fence picks ONE
                # survivor.  Name only breaks exact generation ties — between
                # a primary and its own standbys generations differ or the
                # standby accepts below.
                mine = (self._generation, self._rpc.get_name())
                theirs = (generation, str(from_name))
                if theirs <= mine:
                    _M_REPL_REJECTS.inc()
                    return {"ok": False, "generation": self._generation,
                            "name": self._rpc.get_name()}
                self._demote_locked(generation, f"replication from {from_name}")
            else:
                if generation < self._generation:
                    # Stale zombie replicating at us: refuse, and tell it the
                    # real generation so it stands down.
                    _M_REPL_REJECTS.inc()
                    return {"ok": False, "generation": self._generation,
                            "name": self._rpc.get_name()}
                self._generation = generation
                _M_GENERATION.set(self._generation)
            self._last_replicate_rx = now
            groups: Dict[str, _BrokerGroup] = {}
            for name, snap in state.items():
                g = _BrokerGroup(name)
                g.sync_id = int(snap["sync_id"])
                # Liveness re-stamped at apply time: if we're promoted later,
                # every replicated member gets a full ping window before the
                # eviction sweep may touch it.
                g.members = {
                    n: {"last_ping": now, "sort_order": m["sort_order"],
                        "host": m.get("host")}
                    for n, m in snap["members"].items()
                }
                g.observers = {
                    n: {"last_ping": now, "role": m["role"]}
                    for n, m in snap["observers"].items()
                }
                g.active_members = list(snap["active_members"])
                g.active_hosts = dict(snap["active_hosts"])
                groups[name] = g
            self._groups = groups
            _M_REPL_APPLIED.inc()
            return {"ok": True, "generation": self._generation,
                    "name": self._rpc.get_name()}

    def _replicate_locked(self) -> list:
        """Build the replication sends to issue OUTSIDE the lock."""
        snapshot = self._snapshot_locked()
        sends = []
        own = self._rpc.get_name()
        for addr in self._peer_broker_addrs:
            name = self._rpc.peer_name_at(addr)
            if name is None or name == own:
                continue  # not greeted yet (down or still dialing) — skip
            sends.append((name, self._generation, snapshot))
        return sends

    def _send_replicate(self, peer_name: str, generation: int, snapshot: dict) -> None:
        def _reply(result, error):
            if error is not None:
                utils.log_verbose("broker: replicate to %s failed: %s",
                                  peer_name, error)
                return
            if isinstance(result, dict) and not result.get("ok", True):
                r_fence = (int(result.get("generation", 0)),
                           str(result.get("name", "")))
                with self._lock:
                    if self._primary and r_fence > (self._generation,
                                                    self._rpc.get_name()):
                        self._demote_locked(r_fence[0],
                                            f"replication rejected by {r_fence[1]}")

        self._rpc.async_callback(
            peer_name, "__broker_replicate", _reply,
            self._rpc.get_name(), generation, snapshot,
        )

    # pump --------------------------------------------------------------------
    def update(self) -> None:
        """Evict silent peers and push membership epochs. Call regularly
        (~0.25 s cadence, reference ``py/moolib/broker.py:31-36``)."""
        now = time.monotonic()
        pushes = []
        replicates = []
        with self._lock:
            if self._primary:
                for g in self._groups.values():
                    evicted = [
                        name
                        for name, m in g.members.items()
                        if now - m["last_ping"] > self._timeout
                    ]
                    for name in evicted:
                        del g.members[name]
                        g.needs_update = True
                    # Observer eviction never bumps the epoch: replicas dying
                    # must not cancel the training cohort's in-flight rounds.
                    for name in [
                        n for n, m in g.observers.items()
                        if now - m["last_ping"] > self._timeout
                    ]:
                        del g.observers[name]
                    # Rate-limit epoch bumps (reference: 2 s; we use 0.5 s so
                    # tests with churn settle fast).
                    if g.needs_update and now - g.last_update > 0.5:
                        pushes.extend(self._bump_locked(g, now))
                if (self._peer_broker_addrs
                        and now - self._last_replicate_tx >= self._replicate_interval):
                    self._last_replicate_tx = now
                    replicates = self._replicate_locked()
            # A standby neither evicts (its liveness stamps are replication
            # apply times, not real pings) nor pushes epochs — it only keeps
            # the promotion clock, which _on_ping reads.
        for push in pushes:
            self._push_to(*push)
        for send in replicates:
            self._send_replicate(*send)

    def _push_to(self, peer_name: str, group_name: str, sync_id: int, members: list,
                 hosts: Optional[dict] = None, generation: Optional[int] = None) -> None:
        def _ignore(result, error):
            if error is not None:
                utils.log_verbose("broker: push to %s failed: %s", peer_name, error)

        self._rpc.async_callback(
            peer_name, "__group_update", _ignore, group_name, sync_id, members,
            hosts, generation,
        )

    def close(self) -> None:
        self._rpc.close()


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description="moolib_tpu_torch broker")
    parser.add_argument("--address", default="0.0.0.0:4431")
    parser.add_argument("--name", default="broker")
    parser.add_argument("--interval", type=float, default=0.25)
    parser.add_argument(
        "--brokers", default=None,
        help="comma-separated addresses of the OTHER brokers in this control "
             "plane (enables replication + failover)")
    parser.add_argument(
        "--standby", action="store_true",
        help="start as a hot standby (promotes itself when the primary's "
             "replication goes quiet past --promote_grace)")
    parser.add_argument("--promote_grace", type=float, default=3.0)
    parser.add_argument("--replicate_interval", type=float, default=0.5)
    parser.add_argument("--timeout", type=float, default=10.0,
                        help="ping-silence eviction timeout (seconds)")
    args = parser.parse_args(argv)

    rpc = Rpc()
    broker = Broker(rpc, standby=args.standby)
    broker.set_name(args.name)
    broker.set_timeout(args.timeout)
    broker.set_promote_grace(args.promote_grace)
    broker.set_replicate_interval(args.replicate_interval)
    broker.listen(args.address)
    if args.brokers:
        broker.set_peer_brokers([a.strip() for a in args.brokers.split(",") if a.strip()])
    role = "standby" if args.standby else "primary"
    print(f"Broker {args.name!r} ({role}) listening on {args.address}", flush=True)
    try:
        while True:
            broker.update()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    finally:
        broker.close()


if __name__ == "__main__":
    main()
