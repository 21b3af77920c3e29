"""Preemption-hardened autoscaling soak: the elastic fleet under Poisson kills.

The port of the JAX package's ``scripts/autoscale_soak.py``, with its
gates, thresholds, seeded schedule and verdict keys.  It drives the full
supervision stack against the port's elastic LM trainer:

1. **Formation**: this process hosts the Broker and runs an
   :class:`moolib_tpu_torch.autoscaler.Autoscaler` over a
   :class:`~moolib_tpu_torch.autoscaler.SubprocessFleet` of
   ``moolib_tpu_torch.examples.lm`` workers.  The ``below_min`` rule grows
   the cohort from zero to the target size; every worker must print its
   ``recovered:`` line (contributing, model-synced).
2. **Poisson preemption**: a seeded
   :meth:`~moolib_tpu_torch.testing.FaultPlan.poisson_kills` schedule
   SIGKILLs a random live worker at each arrival.  The autoscaler must
   respawn and the replacement must be contributing again within
   ``--recovery_bound_s``; each miss counts as an ``unrecovered_kill`` and
   the soak fails on any.
3. **Graceful decommission**: one explicit ``fleet.shrink()`` drops the
   decommission flag; the victim drains and announces ``__broker_leave``.
   The broker's membership must exclude the victim within 1 s of the
   victim's exit.  The autoscaler then grows the cohort back to target.
4. **Invariants** over every worker log at the end: zero
   ``vbatch_violation`` lines and the final cohort back at target size.

Workers run on ``--device`` (no value: the card; each worker holds its own
CUDA context there) at the shape flags given (default: the JAX script's
widths).  Exit 0 only when all four hold; the JSON verdict goes to
``--out`` and stdout.

    python -m moolib_tpu_torch.scripts.autoscale_soak --smoke --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import _soak

log = _soak.logger("autoscale_soak")


def kill_schedule(flags, plan) -> list:
    """The seeded Poisson arrival times of the preemptions (at least one)."""
    schedule = plan.poisson_kills(flags.kill_rate, flags.kill_window_s)
    return schedule[: flags.max_kills] or [flags.kill_window_s / 2]


def pick_victim(plan, live) -> str:
    """The seeded victim among the live members."""
    assert live, "no live member to preempt"
    return plan.rng("victim").choice(sorted(live))


def worker_log_has(peer_dir: str, needle: str) -> bool:
    return needle in _soak.read(os.path.join(peer_dir, "worker.log"))


def count_in_logs(fleet_dir: str, needle: str) -> int:
    names = sorted(os.listdir(fleet_dir)) if os.path.isdir(fleet_dir) else []
    return sum(_soak.read(os.path.join(fleet_dir, n, "worker.log")).count(needle) for n in names)


def dump_worker_tails(fleet_dir: str, n: int = 1500) -> None:
    for name in sorted(os.listdir(fleet_dir)) if os.path.isdir(fleet_dir) else []:
        path = os.path.join(fleet_dir, name, "worker.log")
        if os.path.exists(path):
            _soak.dump_tail(path, n)


def worker_args(flags) -> list:
    return [*_soak.lm_shape_args(flags), "--device", flags.device,
            "--steps", "1000000",  # run until decommissioned/terminated
            "--virtual_batch_size", str(flags.virtual_batch_size),
            "--log_interval", "5", "--watchdog", "180"]


class Soak:
    def __init__(self, flags):
        from .. import Broker, autoscaler
        from ..testing import FaultPlan

        self.flags = flags
        self.result = {
            "metric": "autoscale_soak",
            "ok": False,
            "failure": None,
            "seed": flags.seed,
            "device": flags.device,
            "target_peers": flags.target_peers,
            "evict_s": flags.evict_s,
            "recovery_bound_s": flags.recovery_bound_s,
            "kills": 0,
            "kill_times_s": [],
            "recovery_s": [],
            "unrecovered_kills": 0,
            "graceful_leave_s": None,
            "decommission_drain_s": None,
            "vbatch_violations": None,
            "scale_events": [],
            "final_cohort": None,
        }
        self.fleet_dir = os.path.join(flags.workdir, "fleet")
        addr = f"127.0.0.1:{_soak.free_port()}"
        self.broker = Broker()
        self.broker.set_name("broker")
        # Modest eviction window: preemption recovery pays it, and the
        # graceful-leave check below proves decommissions DON'T.
        self.broker.set_timeout(flags.evict_s)
        self.broker.listen(addr)
        self.fleet = autoscaler.SubprocessFleet(
            autoscaler.example_spawn(addr, self.fleet_dir, "moolib_tpu_torch.examples.lm",
                                     worker_args(flags)),
            self.fleet_dir,
        )
        # min == target: every preemption/decommission makes the cohort
        # below_min, which is exactly what pulls it back to size.
        self.policy = autoscaler.AutoscalePolicy(flags.target_peers, flags.target_peers + 1,
                                                 cooldown_s=flags.cooldown_s)
        self.scaler = autoscaler.Autoscaler(self.policy, self.fleet, poll_interval=flags.poll_s)
        self.plan = FaultPlan(flags.seed)

    # ------------------------------------------------------------- plumbing
    def members(self):
        g = self.broker._groups.get("lm")
        return list(g.active_members) if g is not None else []

    def tick(self, seconds: float = 0.05) -> None:
        self.broker.update()
        self.scaler.step()
        time.sleep(seconds)

    def wait(self, pred, bound_s: float, what: str):
        deadline = time.monotonic() + bound_s
        while time.monotonic() < deadline:
            v = pred()
            if v:
                return v
            self.tick()
        raise SystemExit(f"FAIL: deadline ({bound_s:.0f}s) expired while {what}")

    def peer_dirs(self):
        return {name: os.path.join(self.fleet_dir, name) for name in self.fleet.peers()}

    def recovered_peers(self):
        return {name for name, d in self.peer_dirs().items() if worker_log_has(d, "recovered:")}

    # --------------------------------------------------------------- phases
    def form_cohort(self) -> None:
        flags = self.flags
        log(f"phase 1: forming cohort of {flags.target_peers} (below_min grows from zero)")
        self.wait(lambda: len(self.members()) >= flags.target_peers
                  and len(self.recovered_peers()) >= flags.target_peers,
                  flags.phase_deadline, "forming the initial cohort")
        log(f"phase 1 OK: members={self.members()}")

    def poisson_phase(self) -> None:
        flags = self.flags
        schedule = kill_schedule(flags, self.plan)
        log(f"phase 2: Poisson preemptions at {schedule} "
            f"(rate={flags.kill_rate}/s over {flags.kill_window_s:.0f}s)")
        t_phase = time.monotonic()
        for t_kill in schedule:
            while time.monotonic() - t_phase < t_kill:
                self.tick()
            # A kill while the previous recovery is still in flight would
            # make per-kill recovery accounting ambiguous; wait out the
            # current rejoin first (the Poisson time is a lower bound).
            self.wait(lambda: len(self.members()) >= flags.target_peers,
                      flags.recovery_bound_s + flags.phase_deadline,
                      "waiting for cohort before next kill")
            before = set(self.fleet.peers())
            victim = pick_victim(self.plan, [n for n in self.fleet.peers()
                                             if n in self.members()])
            assert self.fleet.kill(victim), f"kill({victim}) found no live peer"
            t0 = time.monotonic()
            self.result["kills"] += 1
            self.result["kill_times_s"].append(round(time.monotonic() - _soak.T0, 1))
            log(f"SIGKILLed {victim} (preemption); waiting for replacement")

            def replacement_contributing():
                fresh = set(self.fleet.peers()) - before
                return any(worker_log_has(os.path.join(self.fleet_dir, n), "recovered:")
                           for n in fresh) and len(self.members()) >= flags.target_peers

            try:
                self.wait(replacement_contributing, flags.recovery_bound_s,
                          f"recovering from the {victim} preemption")
            except SystemExit:
                self.result["unrecovered_kills"] += 1
                log(f"UNRECOVERED kill of {victim} (bound {flags.recovery_bound_s:.0f}s)")
                continue
            took = time.monotonic() - t0
            self.result["recovery_s"].append(round(took, 1))
            log(f"recovered in {took:.1f}s (evict {flags.evict_s:.0f}s of that)")
        if self.result["unrecovered_kills"]:
            raise SystemExit(f"FAIL: {self.result['unrecovered_kills']} unrecovered kills")
        log(f"phase 2 OK: {self.result['kills']} kills, recoveries {self.result['recovery_s']}")

    def decommission_phase(self) -> None:
        flags = self.flags
        log("phase 3: graceful decommission (drain + __broker_leave)")
        t_flag = time.monotonic()
        victim = self.fleet.shrink()
        assert victim is not None, "nothing to decommission"
        proc = self.fleet._peers[victim]["proc"]
        t_exit = t_gone = None
        deadline = time.monotonic() + flags.phase_deadline
        while time.monotonic() < deadline and (t_exit is None or t_gone is None):
            if t_exit is None and proc.poll() is not None:
                t_exit = time.monotonic()
            if t_gone is None and victim not in self.members():
                t_gone = time.monotonic()
            self.broker.update()  # membership only; no autoscale races here
            time.sleep(0.005)
        if t_exit is None or t_gone is None:
            raise SystemExit(f"FAIL: decommission of {victim} never completed "
                             f"(exit={t_exit}, membership={t_gone})")
        # The leave RPC lands BEFORE the worker exits, so membership drops
        # no later than ~the exit.  Eviction alone would need evict_s more.
        leave_lag = max(0.0, t_gone - t_exit)
        self.result["graceful_leave_s"] = round(leave_lag, 3)
        self.result["decommission_drain_s"] = round(t_gone - t_flag, 1)
        log(f"decommissioned {victim}: drain+leave {t_gone - t_flag:.1f}s, membership lag "
            f"after exit {leave_lag:.3f}s (eviction would be {flags.evict_s:.0f}s)")
        if leave_lag >= 1.0:
            raise SystemExit(f"FAIL: graceful leave took {leave_lag:.2f}s — that is the "
                             "ping-eviction path, not __broker_leave")
        # below_min pulls the cohort back to target.
        self.wait(lambda: len(self.members()) >= flags.target_peers,
                  flags.phase_deadline, "regrowing after the decommission")
        log(f"phase 3 OK: cohort back at {len(self.members())}")

    def finish(self) -> None:
        self.result["vbatch_violations"] = count_in_logs(self.fleet_dir, "vbatch_violation")
        self.result["final_cohort"] = len(self.members())
        self.result["scale_events"] = [
            {k: (round(v, 1) if isinstance(v, float) else v) for k, v in e.items()}
            for e in self.scaler.events
        ]
        if self.result["vbatch_violations"]:
            raise SystemExit(f"FAIL: {self.result['vbatch_violations']} vbatch violations "
                             "— the virtual batch did not survive a resize")
        self.result["ok"] = True

    def close(self) -> None:
        self.fleet.terminate_all()
        self.broker.close()


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="autoscaling soak under Poisson preemption")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="~3 min CI profile (1 kill, small windows)")
    ap.add_argument("--target_peers", type=int, default=2)
    ap.add_argument("--virtual_batch_size", type=int, default=8)
    ap.add_argument("--evict_s", type=float, default=10.0,
                    help="broker ping-eviction timeout (preemptions pay it; graceful "
                    "decommissions must not)")
    ap.add_argument("--recovery_bound_s", type=float, default=None,
                    help="kill-to-contributing SLO for the respawned peer "
                    "(default 90 smoke / 120 full)")
    ap.add_argument("--kill_rate", type=float, default=None,
                    help="Poisson preemption rate, kills/s (default ~1 kill per window "
                    "smoke, 3 per window full)")
    ap.add_argument("--kill_window_s", type=float, default=None)
    ap.add_argument("--max_kills", type=int, default=None)
    ap.add_argument("--cooldown_s", type=float, default=2.0)
    ap.add_argument("--poll_s", type=float, default=0.5)
    ap.add_argument("--phase_deadline", type=float, default=None)
    _soak.add_lm_shape_flags(ap, vocab=16, seq_len=16, batch_size=2, d_model=16, layers=1,
                             heads=1)
    ap.add_argument("--device", default=None, help="the workers' torch device (default: cuda)")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--out", default=None, help="write the JSON verdict here")
    return ap


def parse_flags(argv=None):
    flags = make_parser().parse_args(argv)
    if flags.recovery_bound_s is None:
        flags.recovery_bound_s = 90.0 if flags.smoke else 120.0
    if flags.kill_window_s is None:
        flags.kill_window_s = 20.0 if flags.smoke else 120.0
    if flags.kill_rate is None:
        flags.kill_rate = (1.0 if flags.smoke else 3.0) / flags.kill_window_s
    if flags.max_kills is None:
        flags.max_kills = 1 if flags.smoke else 4
    if flags.phase_deadline is None:
        flags.phase_deadline = 180.0 if flags.smoke else 420.0
    return flags


def main(argv=None) -> int:
    flags = parse_flags(argv)
    flags.device = _soak.device_arg(flags.device)
    flags.workdir = _soak.workdir(flags.workdir, "autoscale_soak_")
    # The workers are spawned with this process's environment: they import
    # the port from the repository and take one CPU thread each.
    os.environ.update({k: v for k, v in _soak.child_env().items()
                       if k in ("PYTHONPATH", "OMP_NUM_THREADS")})
    log(f"seed={flags.seed} target={flags.target_peers} device={flags.device} "
        f"workdir={flags.workdir}")
    soak = Soak(flags)
    try:
        soak.form_cohort()
        soak.poisson_phase()
        soak.decommission_phase()
        soak.finish()
    except (SystemExit, AssertionError) as e:
        soak.result["failure"] = str(e)
        dump_worker_tails(soak.fleet_dir)
        raise
    finally:
        soak.close()
        payload = json.dumps(soak.result, indent=1)
        if flags.out:
            with open(flags.out, "w") as f:
                f.write(payload + "\n")
        print(payload, flush=True)
    log("AUTOSCALE SOAK OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
