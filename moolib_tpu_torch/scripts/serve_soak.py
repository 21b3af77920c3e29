"""Serving-plane soak: replica SIGKILL + live hot-swap under sustained load.

The port of the JAX package's ``scripts/serve_soak.py``, with its gates,
thresholds, seeded schedule and verdict keys.  It drives the resilient
serving plane (``moolib_tpu_torch.serving``) end to end with real
processes:

1. **Formation**: this process hosts the Broker and an in-process
   :class:`~moolib_tpu_torch.serving.ModelPublisher` ("pusher"), then
   spawns two ``moolib_tpu_torch.examples.lm_serve`` replica subprocesses
   (``--broker`` + ``--publisher``).  Both must print their readiness line
   and be discovered by a broker-polling ``ServeClient``.
2. **Sustained load**: paced open-loop requests at a target QPS for the
   whole window; every future is awaited, every outcome classified.
3. **Replica SIGKILL mid-stream**: at a seeded time (middle half of the
   window, :meth:`FaultPlan.replica_kill_time`) a seeded victim is
   SIGKILLed.  The gate: zero lost requests.
4. **Live hot-swap**: at 0.8 of the window the pusher publishes a new
   model version (the replicas' own model from ``lm_serve.make_model``,
   same flags and seed, built on ``--device`` and scaled by 1 + 1e-3);
   the survivor must install it (``hot_swaps >= 1``, its seconds
   recorded) with no admission rejects across the swap.

``--engine`` serves every replica through the continuous-batching engine
(``lm_serve --engine``) under the same gates.  ``--swing`` runs the
QPS-elasticity phase instead (:func:`run_swing`): calm -> 5x surge ->
quiet offered load against an autoscaled fleet, gated on a ``serve_wait``
grow, a ``serve_idle`` graceful shrink and zero lost requests.

Beyond the JAX script: replicas run on ``--device`` (no value: the card)
with ``--attention``/``--dtype``; the survivor is stopped with SIGINT at
the end and its ``kernel_launches:`` exit line (each flash kernel's
launches and the engine's prefills since its warm-up) goes into the
verdict; ``--fit_qps`` measures one replica's sustained rate during the
warm-up and offers half of it when it is below ``--qps``, so the survivor
can carry the load alone after the kill.

    python -m moolib_tpu_torch.scripts.serve_soak --smoke --device cpu
    python -m moolib_tpu_torch.scripts.serve_soak --smoke --engine --device cpu
    python -m moolib_tpu_torch.scripts.serve_soak --smoke --swing --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import tempfile
import threading
import time

from . import _soak

log = _soak.logger("serve_soak")

REPLICA_MODULE = "moolib_tpu_torch.examples.lm_serve"


def schedule(flags, plan) -> dict:
    """The seeded kill time, victim index and swap time, drawn in the
    order the JAX script draws them (the victim at the kill, from the
    same ``serving`` stream)."""
    kill_t = plan.replica_kill_time(flags.window_s)
    return {"kill_t": kill_t, "victim": plan.rng("serving").randrange(2),
            "swap_t": round(flags.window_s * 0.8, 3)}


def replica_args(flags, device: str) -> list:
    """The lm_serve flags every replica of the soak shares."""
    return [*_soak.lm_shape_args(flags), "--dtype", flags.dtype,
            "--max_new_tokens", str(flags.max_new_tokens), "--max_queue", str(flags.max_queue),
            "--seed", str(flags.seed), "--device", device]


def spawn_replica(name: str, port: int, broker_addr: str, flags, device: str) -> tuple:
    args = ["--listen", f"127.0.0.1:{port}", "--broker", broker_addr, "--name", name,
            "--publisher", "pusher", *replica_args(flags, device)]
    if flags.engine:
        args.append("--engine")
    log_path = os.path.join(flags.workdir, f"{name}.log")
    return _soak.spawn(REPLICA_MODULE, args, log_path), log_path


def stop_for_launches(proc, log_path: str, timeout: float = 60.0):
    """SIGINT a live replica, wait for it to exit, and return its
    ``kernel_launches:`` exit line (None if it printed none)."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=timeout)
        except Exception:  # noqa: BLE001 — a replica that will not leave is killed below
            pass
    return _soak.json_line(_soak.read(log_path), "kernel_launches: ")


def replica_rate(flags, addr: str, name: str) -> float:
    """One replica's sustained requests/s: a burst of 4 x its slots (the
    batch cap) requests to ``name`` alone, all at once, timed to the last
    reply."""
    import numpy as np

    from .. import Rpc
    from ..serving import ServeClient

    rpc = Rpc()
    rpc.set_name(f"serve-soak-probe-{os.getpid()}")
    rpc.connect(addr)
    client = ServeClient(rpc, replicas=[name], deadline_s=flags.deadline_s * 4,
                         attempt_timeout=flags.deadline_s * 4, max_attempts=1)
    try:
        rng = np.random.default_rng(flags.seed + 1)
        n = 4 * flags.batch_size
        prompts = [rng.integers(2, flags.vocab, flags.seq_len).astype(np.int32) for _ in range(n)]
        t0 = time.monotonic()
        futs = [client.submit(p) for p in prompts]
        for f in futs:
            f.result(flags.deadline_s * 4 + 10.0)
        return n / (time.monotonic() - t0)
    finally:
        client.close()
        rpc.close()


def _pump_broker(broker, stop: threading.Event) -> None:
    while not stop.is_set():
        broker.update()
        stop.wait(0.05)


def run_swing(flags, device: str) -> int:
    """QPS-elasticity swing: a one-replica engine fleet under a 5x
    offered-load swing, supervised by the autoscaler's serving rules end
    to end with real processes.

    Phases: **calm** (qps_low, one replica keeps up) -> **surge** (5 x
    qps_low: the replica saturates, ``serve_queue_wait_s`` climbs, the
    policy grows a second replica) -> **quiet** (back to qps_low: the fleet
    drains, sustained idle shrinks it back through the localdir
    decommission flag, a graceful leave).  ``--service_delay_ms`` pins the
    per-iteration service time, so "one replica saturates under the surge
    but two do not" holds on any host.  Gates: a ``serve_wait`` grow fired
    during the surge, a ``serve_idle`` shrink brought the fleet back to
    one, and zero requests were lost (admission rejects are the plane
    working)."""
    import shutil

    import numpy as np

    from .. import Broker
    from ..autoscaler import Autoscaler, AutoscalePolicy, SubprocessFleet
    from ..serving import ServeClient, is_overload_error

    qps_low = flags.qps if flags.qps is not None else 2.0
    qps_high = 5.0 * qps_low
    calm_s = 8.0 if flags.smoke else 15.0
    surge_s = 35.0 if flags.smoke else 60.0
    quiet_s = 25.0 if flags.smoke else 45.0
    log(f"swing: qps {qps_low} -> {qps_high} -> {qps_low} ({calm_s}/{surge_s}/{quiet_s}s), "
        f"service_delay={flags.service_delay_ms}ms device={device}")

    broker_addr = f"127.0.0.1:{_soak.free_port()}"
    broker = Broker()
    broker.set_name("broker")
    broker.listen(broker_addr)
    stop_pump = threading.Event()
    threading.Thread(target=_pump_broker, args=(broker, stop_pump), daemon=True).start()
    base_dir = tempfile.mkdtemp(prefix="serve_swing_", dir=flags.workdir)

    def spawn(name: str, localdir: str):
        args = ["--listen", f"127.0.0.1:{_soak.free_port()}", "--broker", broker_addr,
                "--name", name, "--localdir", localdir, "--engine",
                # Capacity pin: one replica serves ~slots/(max_new x delay)
                # req/s (4/(4 x 0.15) ~ 6.7 with defaults), so the 5x surge
                # (10 req/s) saturates one replica and two absorb it.
                "--slots", str(max(1, flags.batch_size // 2)),
                *replica_args(flags, device), "--service_delay_ms", str(flags.service_delay_ms)]
        return _soak.spawn(REPLICA_MODULE, args, os.path.join(localdir, "replica.log"),
                           extra_env={"MOOLIB_TELEMETRY_DIR": localdir,
                                      "MOOLIB_TELEMETRY_INTERVAL": "1"})

    fleet = SubprocessFleet(spawn, base_dir, name_prefix="swing")
    policy = AutoscalePolicy(
        min_peers=1, max_peers=2, cooldown_s=5.0,
        serve_wait_grow_s=0.4, serve_wait_polls=2,
        # The quiet trickle still lands ~qps_low answers/s fleet-wide;
        # idle means "at or below the calm rate with a cold queue".
        serve_idle_qps=max(0.1, qps_low), serve_idle_occupancy=0.5,
        serve_idle_polls=3,
    )
    scaler = Autoscaler(policy, fleet, poll_interval=1.0)
    result = {
        "soak": "serve_swing", "seed": flags.seed, "smoke": flags.smoke, "device": device,
        "qps_low": qps_low, "qps_high": qps_high,
        "service_delay_ms": flags.service_delay_ms,
    }
    client = None
    try:
        fleet.grow()
        client = ServeClient(broker=broker_addr, deadline_s=flags.deadline_s,
                             attempt_timeout=2.0, max_attempts=8)
        client.wait_for_replicas(1, timeout=flags.ready_timeout)
        rng = np.random.default_rng(flags.seed)
        warm = rng.integers(2, flags.vocab, flags.seq_len).astype(np.int32)
        client.call(warm)

        outcomes = {"ok": 0, "reject": 0, "deadline": 0, "error": 0}
        error_samples: list = []
        lock = threading.Lock()
        pending = []

        def on_done(fut):
            exc = fut.exception()
            with lock:
                if exc is None:
                    outcomes["ok"] += 1
                elif is_overload_error(exc):
                    outcomes["reject"] += 1
                elif "deadline" in str(exc).lower():
                    outcomes["deadline"] += 1
                else:
                    outcomes["error"] += 1
                    if len(error_samples) < 5:
                        error_samples.append(str(exc)[:300])

        phase_cohorts = {}
        for label, q, dur in (("calm", qps_low, calm_s), ("surge", qps_high, surge_s),
                              ("quiet", qps_low, quiet_s)):
            log(f"phase {label}: qps={q} for {dur}s (cohort={fleet.size()})")
            interval = 1.0 / q
            n = max(1, int(dur * q))
            t0p = time.monotonic()
            peak = fleet.size()
            for i in range(n):
                target = t0p + i * interval
                # Supervise while pacing: the scaler self-limits to its
                # poll interval, so calling it every beat is free.
                while True:
                    scaler.step()
                    now = time.monotonic()
                    if now >= target:
                        break
                    time.sleep(min(0.1, target - now))
                p = rng.integers(2, flags.vocab, flags.seq_len).astype(np.int32)
                fut = client.submit(p)
                fut.add_done_callback(on_done)
                pending.append(fut)
                peak = max(peak, fleet.size())
            phase_cohorts[label] = {"end": fleet.size(), "peak": peak}
        # Post-quiet grace: keep supervising until the idle shrink lands
        # and the decommissioned replica actually exits.
        deadline = time.monotonic() + 30.0
        shrunk = False
        while time.monotonic() < deadline:
            scaler.step()
            fleet.reap()
            shrunk = (any(e["action"] == "shrink" for e in scaler.events)
                      and fleet.size() <= 1)
            if shrunk:
                break
            time.sleep(0.25)
        unfinished = 0
        for fut in pending:
            try:
                fut.result(flags.deadline_s + 10.0)
            except TimeoutError:
                unfinished += 1
            except Exception:  # noqa: BLE001 — classified in on_done
                pass
        lost = outcomes["deadline"] + outcomes["error"] + unfinished
        grow_reasons = [e["reason"] for e in scaler.events if e["action"] == "grow"]
        shrink_reasons = [e["reason"] for e in scaler.events if e["action"] == "shrink"]
        result.update(
            requests=len(pending),
            ok=outcomes["ok"], rejects=outcomes["reject"],
            deadline_errors=outcomes["deadline"], errors=outcomes["error"],
            unfinished_futures=unfinished, lost_requests=lost,
            error_samples=error_samples,
            phase_cohorts=phase_cohorts,
            scale_events=[{k: e[k] for k in ("action", "peer", "reason")}
                          for e in scaler.events],
        )
        gates = {
            "grew_on_surge_wait": "serve_wait" in grow_reasons,
            "fleet_reached_two": phase_cohorts["surge"]["peak"] >= 2,
            "shrank_back_on_idle": shrunk and "serve_idle" in shrink_reasons,
            "zero_lost_requests": lost == 0,
        }
        result["gates"] = gates
        result["pass"] = all(gates.values())
    except Exception as e:  # noqa: BLE001 — the verdict must always be written
        log(f"FAILED: {e!r}")
        result["pass"] = False
        result["failure"] = str(e)
    finally:
        if client is not None:
            client.close()
        stop_pump.set()
        broker.close()
        fleet.terminate_all()
        shutil.rmtree(base_dir, ignore_errors=True)
    return _verdict(flags, result, "fleet grew under the surge, shrank back when idle, "
                    "zero lost requests")


def _verdict(flags, result: dict, passed: str) -> int:
    payload = json.dumps(result, indent=1)
    if flags.out:
        with open(flags.out, "w") as f:
            f.write(payload + "\n")
        log(f"verdict -> {flags.out}")
    print(payload, flush=True)
    if result.get("pass"):
        log(f"PASS: {passed}")
        return 0
    log("FAIL")
    return 1


def _swap_payload(flags, device: str):
    """The replicas' own model (same flags, same seed) built on ``device``,
    scaled by 1 + 1e-3 so the swap is observable, as the publisher's flax
    tree of f32 numpy leaves."""
    import torch

    from ..examples.lm_serve import make_model
    from ..models.convert import to_flax

    model = make_model(flags, torch.device(device), torch.Generator().manual_seed(flags.seed))
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1.0 + 1e-3)
    tree = to_flax(model)
    del model
    return tree


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--smoke", action="store_true", help="CI profile: short window, small load")
    ap.add_argument("--window_s", type=float, default=None,
                    help="load window (default 20 smoke / 60 full)")
    ap.add_argument("--qps", type=float, default=None,
                    help="offered load (default 30 smoke / 50 full)")
    ap.add_argument("--deadline_s", type=float, default=15.0)
    _soak.add_lm_shape_flags(ap, vocab=64, seq_len=8, d_model=32, layers=1, heads=2,
                             batch_size=8)
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                    help="the replicas' compute dtype")
    ap.add_argument("--max_new_tokens", type=int, default=4)
    ap.add_argument("--max_queue", type=int, default=256)
    ap.add_argument("--ready_timeout", type=float, default=300.0)
    ap.add_argument("--device", default=None, help="the replicas' torch device (default: cuda)")
    ap.add_argument("--workdir", default=None, help="child logs go here (default: a new tmp dir)")
    ap.add_argument("--out", default=None, help="write the JSON verdict here")
    ap.add_argument("--engine", action="store_true",
                    help="replicas serve through the continuous-batching engine "
                    "(lm_serve --engine); same gates")
    ap.add_argument("--swing", action="store_true",
                    help="run the QPS-elasticity load-swing phase instead of the kill+swap "
                    "soak: calm -> 5x surge -> quiet, gated on autoscaler grow/shrink + zero "
                    "lost requests (--qps sets the calm rate, default 2)")
    ap.add_argument("--service_delay_ms", type=float, default=150.0,
                    help="swing only: per-iteration service delay handed to lm_serve so one "
                    "replica deterministically saturates under the surge")
    ap.add_argument("--fit_qps", action="store_true",
                    help="measure one replica's sustained rate during the warm-up and offer "
                    "half of it when it is below --qps")
    return ap


def parse_flags(argv=None):
    flags = make_parser().parse_args(argv)
    if not flags.swing:
        if flags.window_s is None:
            flags.window_s = 20.0 if flags.smoke else 60.0
        if flags.qps is None:
            flags.qps = 30.0 if flags.smoke else 50.0
    return flags


def main(argv=None) -> int:
    flags = parse_flags(argv)
    device = _soak.device_arg(flags.device)
    flags.workdir = _soak.workdir(flags.workdir, "serve_soak_")
    if flags.swing:
        return run_swing(flags, device)

    import numpy as np

    from .. import Broker, Rpc
    from ..serving import ModelPublisher, ServeClient, is_overload_error
    from ..testing.faults import FaultPlan

    # The payload a hot-swap installs must be REAL weights for the
    # replicas' geometry: the plane installs whatever the publisher
    # announces, and a garbage tree turns every later request into an error.
    swap_params = _swap_payload(flags, device)

    plan = FaultPlan(flags.seed)
    sched = schedule(flags, plan)
    kill_t, swap_t = sched["kill_t"], sched["swap_t"]
    log(f"seed={flags.seed} window={flags.window_s}s qps={flags.qps} kill@{kill_t}s "
        f"swap@{swap_t}s device={device} workdir={flags.workdir}")

    broker_addr = f"127.0.0.1:{_soak.free_port()}"
    broker = Broker()
    broker.set_name("broker")
    broker.listen(broker_addr)
    stop_pump = threading.Event()
    threading.Thread(target=_pump_broker, args=(broker, stop_pump), daemon=True).start()

    pusher_rpc = Rpc()
    pusher_rpc.set_name("pusher")
    pusher_rpc.listen("127.0.0.1:0")
    pusher_rpc.connect(broker_addr)
    pusher = ModelPublisher(pusher_rpc, name="model")

    ports = [_soak.free_port(), _soak.free_port()]
    replicas = [spawn_replica(f"rep{i}", ports[i], broker_addr, flags, device) for i in range(2)]
    result = {
        "soak": "serve", "seed": flags.seed, "smoke": flags.smoke, "device": device,
        "engine": flags.engine, "window_s": flags.window_s, "qps": flags.qps,
        "replicas": 2, "plan_actions": [],
    }
    client = None
    survivor = None
    try:
        for (proc, lp), name in zip(replicas, ("rep0", "rep1")):
            _soak.await_line(lp, proc, "serving", flags.ready_timeout)
            log(f"{name} serving")
        client = ServeClient(broker=broker_addr, deadline_s=flags.deadline_s,
                             attempt_timeout=1.0, max_attempts=8)
        client.wait_for_replicas(2, timeout=30.0)
        log(f"discovered replicas: {client.replicas()}")

        rng = np.random.default_rng(flags.seed)
        warm = rng.integers(2, flags.vocab, flags.seq_len).astype(np.int32)
        client.call(warm)
        if flags.fit_qps:
            rate = replica_rate(flags, f"127.0.0.1:{ports[0]}", "rep0")
            result["replica_rate_rps"] = rate
            if rate < flags.qps:
                flags.qps = rate / 2.0
                result["qps"] = flags.qps
            log(f"one replica sustains {rate:.2f} req/s; offering {flags.qps:.2f} req/s")

        latencies: list = []
        outcomes = {"ok": 0, "reject": 0, "deadline": 0, "error": 0}
        error_samples: list = []
        lock = threading.Lock()
        pending = []

        def on_done(fut, t0):
            dt = time.monotonic() - t0
            exc = fut.exception()
            with lock:
                if exc is None:
                    outcomes["ok"] += 1
                    latencies.append(dt)
                elif is_overload_error(exc):
                    outcomes["reject"] += 1
                elif "deadline" in str(exc).lower():
                    outcomes["deadline"] += 1
                else:
                    outcomes["error"] += 1
                    if len(error_samples) < 5:
                        error_samples.append(str(exc)[:300])

        # One seeded schedule, three actors: paced arrivals, the SIGKILL,
        # and the publish all run off the same monotonic clock.
        interval = 1.0 / flags.qps
        n = max(1, int(flags.window_s * flags.qps))
        killed = None
        swap = {"published": False, "rejects_before": None, "version": 2}
        t_start = time.monotonic()
        for i in range(n):
            target = t_start + i * interval
            now = time.monotonic()
            if now < target:
                time.sleep(target - now)
            t_rel = time.monotonic() - t_start
            if killed is None and t_rel >= kill_t:
                victim = plan.replica_kill([p for p, _lp in replicas], index=sched["victim"])
                survivor = ("rep0", "rep1")[1 - victim]
                killed = {"victim": f"rep{victim}", "t": round(t_rel, 3),
                          "pid": replicas[victim][0].pid}
                log(f"SIGKILLed rep{victim} (pid {killed['pid']}) at +{t_rel:.1f}s; "
                    f"survivor={survivor}")
            if not swap["published"] and t_rel >= swap_t:
                stats = pusher_rpc.sync(survivor or "rep0", "generate_stats")
                swap["rejects_before"] = stats["admission_rejects"]
                pusher.publish(swap_params, version=swap["version"])
                swap["published"] = True
                log(f"published model version {swap['version']} at +{t_rel:.1f}s")
            p = rng.integers(2, flags.vocab, flags.seq_len).astype(np.int32)
            t0 = time.monotonic()
            fut = client.submit(p)
            fut.add_done_callback(lambda f, t0=t0: on_done(f, t0))
            pending.append(fut)
        log(f"offered {n} requests; awaiting completions")
        unfinished = 0
        for fut in pending:
            try:
                fut.result(flags.deadline_s + 10.0)
            except TimeoutError:
                unfinished += 1  # a future that never resolved = lost
            except Exception:  # noqa: BLE001 — classified in on_done
                pass

        # Survivor's post-swap accounting: the swap must have landed, with
        # its duration recorded, and caused no admission rejects.
        deadline = time.monotonic() + 20.0
        st = None
        while time.monotonic() < deadline:
            st = pusher_rpc.sync(survivor or "rep1", "generate_stats")
            if st["model_version"] == swap["version"]:
                break
            time.sleep(0.25)
        lat = sorted(latencies)
        lost = outcomes["deadline"] + outcomes["error"] + unfinished
        result.update(
            requests=n,
            ok=outcomes["ok"],
            rejects=outcomes["reject"],
            deadline_errors=outcomes["deadline"],
            errors=outcomes["error"],
            unfinished_futures=unfinished,
            lost_requests=lost,
            error_samples=error_samples,
            p50_ms=round(lat[len(lat) // 2] * 1e3, 1) if lat else None,
            p99_ms=round(lat[int(len(lat) * 0.99)] * 1e3, 1) if lat else None,
            kill=killed,
            survivor=survivor,
            swap={
                "version": swap["version"],
                "hot_swaps": st["hot_swaps"],
                "serve_swap_seconds": st["last_swap_seconds"],
                "rejects_during_swap": st["admission_rejects"] - (swap["rejects_before"] or 0),
            },
            client_stats=client.stats(),
            plan_actions=[list(a) for a in plan.actions],
        )
        gates = {
            "zero_lost_requests": lost == 0,
            "all_futures_completed": unfinished == 0,
            "replica_killed_mid_stream": killed is not None,
            "hot_swap_completed": st["model_version"] == swap["version"]
            and st["hot_swaps"] >= 1,
            "swap_seconds_recorded": st["last_swap_seconds"] is not None,
            "no_swap_rejects": st["admission_rejects"] - (swap["rejects_before"] or 0) == 0,
        }
        result["gates"] = gates
        result["pass"] = all(gates.values())
    except Exception as e:  # noqa: BLE001 — the verdict must always be written
        log(f"FAILED: {e!r}")
        result["pass"] = False
        result["failure"] = str(e)
    finally:
        if client is not None:
            client.close()
        if survivor is not None:
            # The survivor's exit line: its kernel launches beside the
            # prefills it ran (the chip's exact-launch check reads them).
            proc, lp = replicas[int(survivor[-1])]
            result["survivor_kernel_launches"] = stop_for_launches(proc, lp)
        pusher.close()
        pusher_rpc.close()
        stop_pump.set()
        broker.close()
        for proc, _lp in replicas:
            _soak.kill_tree(proc)
    return _verdict(flags, result, "zero lost requests, failover + hot-swap held under load")


if __name__ == "__main__":
    raise SystemExit(main())
