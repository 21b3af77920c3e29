"""Broker-HA soak: SIGKILL the primary broker mid-allreduce and mid-serve.

Drives the replicated broker control plane (``moolib_tpu_torch.broker``)
end to end with real broker processes; the port of the JAX package's
``scripts/broker_soak.py``, with its gates, thresholds and seeded schedule:

1. **Training phase**: a primary + hot-standby broker pair is spawned as
   subprocesses (``python -m moolib_tpu_torch.broker --brokers ...
   [--standby]``); an in-process 3-peer cohort (``Group.set_brokers``) runs
   back-to-back allreduce rounds.  At a seeded time (middle half of the
   window, :meth:`FaultPlan.broker_kill_time`) the PRIMARY is SIGKILLed.
   Gates: every peer records a ``recovery_seconds{phase="broker_failover"}``
   span inside the failover budget; allreduce rounds resume on the promoted
   standby (>= 3 post-kill successful rounds; a round cancelled by the
   takeover's epoch push, "group changed", is benign churn); no round
   wedges; every peer adopts the bumped generation fence.
2. **Serving phase**: a fresh broker pair, two in-process serving replicas
   registered through the HA list, and a ``ServeClient(brokers=[...])``
   under paced open-loop load.  The primary is SIGKILLed mid-serve.
   Gates: zero lost requests, client discovery fails over to the standby's
   address, and the roster survives the takeover.

The brokers and replicas are host-only (the replicas' step is numpy), so
the soak reaches no kernel; ``--device`` is checked like every soak's (no
value: the card, which must be present).  Exit 0 only when every gate
holds; the JSON verdict goes to ``--out`` or stdout.

    python -m moolib_tpu_torch.scripts.broker_soak --smoke --device cpu
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import threading
import time

from . import _soak

log = _soak.logger("broker_soak")


def schedule(flags, plan) -> dict:
    """The seeded kill times, drawn in the order the soak draws them."""
    return {"training_kill_t": plan.broker_kill_time(flags.window_s),
            "serving_kill_t": plan.broker_kill_time(flags.window_s)}


def spawn_broker(name: str, addr: str, peers: str, standby: bool, flags) -> tuple:
    args = ["--address", addr, "--name", name, "--brokers", peers, "--interval", "0.1",
            "--timeout", str(flags.broker_timeout), "--promote_grace", str(flags.promote_grace),
            "--replicate_interval", str(flags.replicate_interval)]
    if standby:
        args.append("--standby")
    log_path = os.path.join(flags.workdir, f"{name}.log")
    return _soak.spawn("moolib_tpu_torch.broker", args, log_path), log_path


def spawn_broker_pair(flags, tag: str):
    """A ready primary + hot standby; returns (procs, log_paths, addrs)."""
    addr0 = f"127.0.0.1:{_soak.free_port()}"
    addr1 = f"127.0.0.1:{_soak.free_port()}"
    p0, l0 = spawn_broker(f"broker0_{tag}", addr0, addr1, False, flags)
    p1, l1 = spawn_broker(f"broker1_{tag}", addr1, addr0, True, flags)
    try:
        _soak.await_line(l0, p0, "listening", 60.0)
        _soak.await_line(l1, p1, "listening", 60.0)
    except BaseException:
        kill_pair([p0, p1])
        raise
    return [p0, p1], [l0, l1], [addr0, addr1]


def kill_pair(procs) -> None:
    for p in procs:
        _soak.kill_tree(p)


def failover_spans():
    """(count, max_bucket_bound_seconds) of recovery_seconds{broker_failover}."""
    from ..telemetry.recovery import RECOVERY_BUCKETS, recovery_histogram

    h = recovery_histogram().labels(phase="broker_failover").get()
    bound = 0.0
    for i, c in enumerate(h["buckets"]):
        if c:
            bound = RECOVERY_BUCKETS[i] if i < len(RECOVERY_BUCKETS) else float("inf")
    return h["count"], bound


# --------------------------------------------------------------- phase A
def training_phase(flags, plan, kill_t: float) -> dict:
    from .. import Group, Rpc

    procs, _lps, addrs = spawn_broker_pair(flags, "train")
    log(f"training phase: brokers at {addrs}, primary SIGKILL @ +{kill_t}s")
    peers = []
    for i in range(3):
        rpc = Rpc()
        rpc.set_name(f"peer{i}")
        rpc.set_timeout(10)
        rpc.listen("127.0.0.1:0")
        g = Group(rpc, "soak")
        g.set_timeout(20.0)
        g.set_broker_fail_after(flags.fail_after)
        g.set_brokers(addrs)
        peers.append((rpc, g))
    groups = [g for _, g in peers]
    phase = {"kill_t": kill_t, "rounds_ok": 0, "rounds_churned": 0,
             "rounds_wedged": 0, "errors": []}
    killed = {"done": False, "at": None}
    t_start = time.monotonic()

    def pump(pred, timeout):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for g in groups:
                g.update()
            t_rel = time.monotonic() - t_start
            if not killed["done"] and t_rel >= kill_t:
                plan.broker_kill(procs[0])
                killed["done"] = True
                killed["at"] = round(t_rel, 3)
                log(f"SIGKILLed primary broker (pid {procs[0].pid}) at +{t_rel:.1f}s, "
                    "mid-allreduce")
            if pred():
                return True
            time.sleep(0.02)
        return pred()

    try:
        if not pump(lambda: all(len(g.members()) == 3 and g.active() for g in groups), 60.0):
            raise RuntimeError(f"cohort never formed: {[g.members() for g in groups]}")
        log("cohort formed (3 peers)")
        post_kill_ok = 0
        first_ok_after_kill = None
        hard_deadline = t_start + flags.window_s * 3 + 60.0
        while ((time.monotonic() - t_start < flags.window_s or post_kill_ok < 3)
               and time.monotonic() < hard_deadline):
            futs = [g.all_reduce("soak", k + 1) for k, g in enumerate(groups)]
            if not pump(lambda: all(f.done() for f in futs), 30.0):
                phase["rounds_wedged"] += 1
                break
            errs = [f.exception() for f in futs]
            if all(e is None for e in errs):
                if not all(f.result(0) == 6 for f in futs):
                    raise AssertionError(f"allreduce sums {[f.result(0) for f in futs]} != 6")
                phase["rounds_ok"] += 1
                if killed["done"]:
                    post_kill_ok += 1
                    if first_ok_after_kill is None:
                        first_ok_after_kill = round(
                            time.monotonic() - t_start - killed["at"], 3)
            elif any(e is not None and "group changed" in str(e) for e in errs):
                phase["rounds_churned"] += 1  # takeover epoch push: benign
            elif len(phase["errors"]) < 5:
                phase["errors"].append(str(next(e for e in errs if e))[:300])
        count, max_bound = failover_spans()
        phase.update(
            killed_at=killed["at"],
            post_kill_rounds_ok=post_kill_ok,
            first_ok_after_kill_s=first_ok_after_kill,
            failover_spans=count,
            failover_max_bucket_s=max_bound,
            generations=[g._broker_gen for g in groups],
        )
        phase["gates"] = {
            "broker_killed_mid_run": killed["done"],
            "rounds_resumed_on_standby": post_kill_ok >= 3,
            "no_wedged_rounds": phase["rounds_wedged"] == 0,
            "no_hard_errors": not phase["errors"],
            "failover_span_per_peer": count >= len(groups),
            "failover_within_budget": 0 < max_bound <= flags.failover_budget_s,
            "generation_fence_adopted": all(g._broker_gen >= 2 for g in groups),
        }
    finally:
        for rpc, _ in peers:
            rpc.close()
        kill_pair(procs)
    return phase


# --------------------------------------------------------------- phase B
def serving_phase(flags, plan, kill_t: float) -> dict:
    import numpy as np

    from .. import Rpc, telemetry
    from ..serving import ServeClient, ServeReplica, is_overload_error

    procs, _lps, addrs = spawn_broker_pair(flags, "serve")
    log(f"serving phase: brokers at {addrs}, primary SIGKILL @ +{kill_t}s")

    def step(params, batch):
        return np.asarray(batch, dtype=np.float64) * params["scale"]

    reps = []
    client = None
    phase = {"kill_t": kill_t}
    try:
        for i in range(2):
            rpc = Rpc()
            rpc.set_name(f"rep{i}")
            rpc.listen("127.0.0.1:0")
            rep = ServeReplica(rpc, step, {"scale": 2.0}, name="generate", batch_size=8,
                               brokers=addrs, poll_interval=0.1)
            rep._group.set_broker_fail_after(flags.fail_after)
            threading.Thread(target=lambda rep=rep: asyncio.run(rep.loop()), daemon=True).start()
            reps.append((rpc, rep))
        client_failovers = telemetry.get_registry().counter(
            "serve_client_broker_failovers_total", "").labels()
        before_failovers = client_failovers.get()
        client = ServeClient(brokers=addrs, deadline_s=flags.deadline_s, attempt_timeout=2.0,
                             max_attempts=8, refresh_interval=0.2, broker_unreachable_after=30.0)
        client.wait_for_replicas(2, timeout=60.0)
        log(f"discovered replicas: {client.replicas()}")
        rng = np.random.default_rng(flags.seed)
        client.call(rng.random(4))  # warm

        outcomes = {"ok": 0, "reject": 0, "error": 0}
        error_samples = []
        lock = threading.Lock()
        pending = []

        def on_done(fut):
            exc = fut.exception()
            with lock:
                if exc is None:
                    outcomes["ok"] += 1
                elif is_overload_error(exc):
                    outcomes["reject"] += 1
                else:
                    outcomes["error"] += 1
                    if len(error_samples) < 5:
                        error_samples.append(str(exc)[:300])

        interval = 1.0 / flags.qps
        n = max(1, int(flags.window_s * flags.qps))
        killed = None
        t_start = time.monotonic()
        for i in range(n):
            target = t_start + i * interval
            now = time.monotonic()
            if now < target:
                time.sleep(target - now)
            t_rel = time.monotonic() - t_start
            if killed is None and t_rel >= kill_t:
                plan.broker_kill(procs[0])
                killed = {"t": round(t_rel, 3), "pid": procs[0].pid}
                log(f"SIGKILLed primary broker (pid {killed['pid']}) at +{t_rel:.1f}s, "
                    "mid-serve")
            fut = client.submit(rng.random(4))
            fut.add_done_callback(on_done)
            pending.append(fut)
        log(f"offered {n} requests; awaiting completions")
        unfinished = 0
        for fut in pending:
            try:
                fut.result(flags.deadline_s + 10.0)
            except TimeoutError:
                unfinished += 1  # never resolved = lost
            except Exception:  # noqa: BLE001 — classified in on_done
                pass
        # Give discovery a beat to settle on the standby's address.
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and client._broker_addr != addrs[1]:
            time.sleep(0.1)
        lost = outcomes["error"] + unfinished
        phase.update(
            requests=n, ok=outcomes["ok"], rejects=outcomes["reject"],
            errors=outcomes["error"], unfinished_futures=unfinished,
            lost_requests=lost, error_samples=error_samples,
            kill=killed, broker_addr=client._broker_addr,
            roster=client.replicas(), client_stats=client.stats(),
        )
        phase["gates"] = {
            "broker_killed_mid_serve": killed is not None,
            "zero_lost_requests": lost == 0,
            "all_futures_completed": unfinished == 0,
            "discovery_failed_over": client._broker_addr == addrs[1]
            and client_failovers.get() > before_failovers,
            "roster_survived": sorted(client.replicas()) == ["rep0", "rep1"],
        }
    finally:
        if client is not None:
            client.close()
        for rpc, rep in reps:
            try:
                rep.close()
            except Exception:  # noqa: BLE001 — teardown must reach rpc.close()
                pass
            rpc.close()
        kill_pair(procs)
    return phase


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=10)
    ap.add_argument("--smoke", action="store_true", help="CI profile: short windows, small load")
    ap.add_argument("--window_s", type=float, default=None,
                    help="per-phase window (default 12 smoke / 45 full)")
    ap.add_argument("--qps", type=float, default=None,
                    help="serving offered load (default 25 smoke / 40 full)")
    ap.add_argument("--deadline_s", type=float, default=15.0)
    ap.add_argument("--failover_budget_s", type=float, default=15.0,
                    help="bound on every recovery_seconds{broker_failover} span")
    ap.add_argument("--broker_timeout", type=float, default=5.0)
    ap.add_argument("--promote_grace", type=float, default=1.5)
    ap.add_argument("--replicate_interval", type=float, default=0.25)
    ap.add_argument("--fail_after", type=float, default=2.0,
                    help="peer-side ping silence before the failover scan")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--workdir", default=None, help="child logs go here (default: a new tmp dir)")
    ap.add_argument("--out", default=None, help="write the JSON verdict here")
    return ap


def parse_flags(argv=None):
    flags = make_parser().parse_args(argv)
    if flags.window_s is None:
        flags.window_s = 12.0 if flags.smoke else 45.0
    if flags.qps is None:
        flags.qps = 25.0 if flags.smoke else 40.0
    return flags


def main(argv=None) -> int:
    flags = parse_flags(argv)
    device = _soak.device_arg(flags.device)
    flags.workdir = _soak.workdir(flags.workdir, "broker_soak_")

    from ..testing.faults import FaultPlan

    plan = FaultPlan(flags.seed)
    log(f"seed={flags.seed} window={flags.window_s}s/phase budget={flags.failover_budget_s}s "
        f"device={device} workdir={flags.workdir}")
    result = {
        "soak": "broker", "seed": flags.seed, "smoke": flags.smoke, "device": device,
        "window_s": flags.window_s, "failover_budget_s": flags.failover_budget_s,
        "knobs": {
            "broker_timeout": flags.broker_timeout,
            "promote_grace": flags.promote_grace,
            "replicate_interval": flags.replicate_interval,
            "fail_after": flags.fail_after,
        },
    }
    try:
        sched = schedule(flags, plan)
        result["training"] = training_phase(flags, plan, sched["training_kill_t"])
        result["serving"] = serving_phase(flags, plan, sched["serving_kill_t"])
        result["plan_actions"] = [list(a) for a in plan.actions]
        gates = {}
        for phase in ("training", "serving"):
            for name, ok in result[phase]["gates"].items():
                gates[f"{phase}.{name}"] = ok
        result["gates"] = gates
        result["pass"] = all(gates.values())
    except Exception as e:  # noqa: BLE001 — the verdict must always be written
        log(f"FAILED: {e!r}")
        result["pass"] = False
        result["failure"] = str(e)

    payload = json.dumps(result, indent=1)
    if flags.out:
        with open(flags.out, "w") as f:
            f.write(payload + "\n")
        log(f"verdict -> {flags.out}")
    print(payload)
    if result.get("pass"):
        log("PASS: broker failover bounded, zero lost serve requests")
        return 0
    log("FAIL")
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
