"""Seeded chaos soak: drive the real stack through its fault domains.

The port of the JAX package's ``scripts/chaos_soak.py``, with its phases,
gates, thresholds and seeded :class:`moolib_tpu_torch.testing.FaultPlan`:

1. **EnvPool supervision** (in-process): SIGKILL a worker mid-step; the
   pending step future must complete on the respawn and
   ``envpool_worker_restarts`` must move.
2. **2-peer elastic LM run under RPC chaos**: peer A hosts the broker,
   checkpoints, and runs with a watchdog; peer B joins; seeded frame
   drop/dup is injected into both through ``MOOLIB_FAULTS``.  Peer B is
   SIGKILLed mid-run and respawned: the respawned peer must be contributing
   again (its ``recovered:`` line) within ``--recovery_bound_s``, and A must
   still reach its target step count.  Beyond the JAX script, A's exit line
   ``frame_faults:`` must show drops and duplicates, so the chaos really ran,
   and the peers run with ``--min_cohort 2``: A holds (its broker live)
   while B is down, so it outlives the respawn whatever the host's speed
   (on an H100 a peer at the card's widths takes ~25 steps a second alone,
   and a respawned process ~15 s to start).
3. **Forced kill + corrupt checkpoint + relaunch**: A is relaunched
   open-ended, SIGKILLed once fresh checkpoints land, the newest checkpoint
   is truncated, and a final relaunch must resume from the newest *intact*
   checkpoint (step-counter continuity in the logs) and reach its target.
4. **Distributed checkpoints under mid-write host loss**: a 2-peer
   ``--shard_grads`` cohort snapshots into one shared directory; peer B is
   SIGKILLed *mid-shard-write* (``MOOLIB_CKPT_WRITE_DELAY`` widens the
   window).  No torn checkpoint may be eligible, the 1-host relaunch must
   resume from the newest *committed* cohort manifest with step continuity
   (an elastic M<N restore), and the per-capture checkpoint stall (the
   ``ckpt_async:`` exit line) must stay under 10% of the mean step time.
   Beyond the JAX script, the peers run with ``--form_cohort 2``: A takes
   no step past its first until B has joined (then absorbs B's loss
   alone), so B is a member when it is killed however fast A steps alone
   (at the JAX widths on a CPU, ~8 ms a step: its whole target in a second).

The LM peers run ``python -m moolib_tpu_torch.examples.lm`` on ``--device``
(no value: the card) at the shape flags given (default: the JAX script's
widths).  Exit code 0 only when every phase holds; ``--out`` writes a JSON
summary of the phases (the resumed peer's ``kernel_launches:`` exit line
included).

    python -m moolib_tpu_torch.scripts.chaos_soak --smoke --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import time

from . import _soak

log = _soak.logger("chaos_soak")

LM_MODULE = "moolib_tpu_torch.examples.lm"


def schedule(flags, plan) -> dict:
    """The seeded EnvPool victim and every phase's step targets, in the
    order the soak uses them (phase 3's final target follows the resume
    step it finds)."""
    return {"envpool_worker": plan.rng("envpool").randrange(2),
            "cohort_target": flags.steps * 3, "early_progress": flags.steps // 3,
            "dckpt_target": flags.steps * 2, "resume_extra": 30}


# ---------------------------------------------------------------- log parsers
def logged_steps(log_path: str):
    """All ``step=K`` values printed so far, in order."""
    return [int(m.group(1)) for m in re.finditer(r"^step=(\d+)", _soak.read(log_path), re.M)]


def resumed_step(log_path: str):
    m = re.search(r"resumed from checkpoint step (\d+)", _soak.read(log_path))
    return int(m.group(1)) if m else None


def recovered_line(log_path: str):
    """The one-shot per-phase recovery breakdown a rejoining peer prints
    once it is contributing again (``recovered: {...}``), or None."""
    m = re.search(r"^recovered: (\{.*\})", _soak.read(log_path), re.M)
    return m.group(1) if m else None


def _ckpt_async_stats(log_path: str):
    """The exit-line capture stats a distributed-checkpoint run prints
    (``ckpt_async: captures=.. commits=.. stall_s=.. write_s=.. train_s=..
    steps=..``), as a dict, or None."""
    m = re.search(r"^ckpt_async: captures=(\d+) commits=(\d+) stall_s=([\d.]+) "
                  r"write_s=([\d.]+) train_s=([\d.]+) steps=(\d+)", _soak.read(log_path), re.M)
    if not m:
        return None
    keys = ("captures", "commits", "stall_s", "write_s", "train_s", "steps")
    return {k: float(m.group(i + 1)) for i, k in enumerate(keys)}


def exit_line(log_path: str, name: str):
    """A peer's ``<name>: {json}`` exit line (``kernel_launches``,
    ``frame_faults``), or None."""
    return _soak.json_line(_soak.read(log_path), f"{name}: ")


# --------------------------------------------------------------------- phases
def phase_envpool(plan, worker: int) -> dict:
    """Kill a worker mid-step; the same future must complete on respawn."""
    import numpy as np

    from .. import telemetry
    from ..envpool import EnvPool

    log("phase 1: envpool worker kill -> respawn")
    pool = EnvPool(_SlowEnv, num_processes=2, batch_size=4, num_batches=1)
    try:
        fut = pool.step(0, np.zeros(4, np.int64))
        time.sleep(0.1)  # ensure the step is in flight
        idx = plan.kill_envpool_worker(pool, worker)
        out = fut.result()  # must complete without raising
        assert (out["state"][:, 0] == 7.0).all(), out["state"][:, 0]
        out = pool.step(0, np.zeros(4, np.int64)).result()  # next step fine too
        assert (out["state"][:, 0] == 7.0).all()
        restarts = telemetry.get_registry().counter_values().get("envpool_worker_restarts", 0.0)
        assert restarts >= 1.0, f"no restart recorded ({restarts})"
        log(f"phase 1 OK (killed worker {idx}; restarts={restarts:.0f})")
        return {"killed_worker": idx, "restarts": restarts}
    finally:
        pool.close()


class _SlowEnv:
    """0.4 s steps: wide window to land the kill mid-step."""

    def reset(self):
        import numpy as np

        return np.zeros(2, np.float32)

    def step(self, action):
        import numpy as np

        time.sleep(0.4)
        return np.full(2, 7.0, np.float32), 1.0, False, {}


def lm_args(flags, steps, ckpt_dir, port=None, connect=None, watchdog=120.0, name=None):
    args = [*_soak.lm_shape_args(flags), "--device", flags.device,
            "--log_interval", "10", "--steps", str(steps),
            "--checkpoint_interval", str(flags.checkpoint_interval),
            "--watchdog", str(watchdog)]
    if ckpt_dir:
        args += ["--checkpoint_dir", ckpt_dir]
    if port is not None:
        args += ["--address", f"127.0.0.1:{port}"]
    if connect is not None:
        args += ["--connect", f"127.0.0.1:{connect}"]
    if name:
        args += ["--local_name", name]
    return args


def spawn_lm(args, log_path, faults="", extra_env=None):
    return _soak.spawn(LM_MODULE, args, log_path, faults, extra_env)


def _finish(proc, log_path: str, timeout: float, what: str) -> None:
    """Wait for a peer that must end by itself with rc 0."""
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        _soak.dump_tail(log_path)
        raise SystemExit(f"FAIL: {what} never finished")
    finally:
        _soak.kill_tree(proc)
    if rc != 0:
        _soak.dump_tail(log_path)
        raise SystemExit(f"FAIL: {what} exited rc={rc}")


def phase_cohort(flags, plan, sched, workdir: str) -> dict:
    """2-peer elastic lm under RPC chaos; peer B dies mid-run and is
    RESPAWNED: the rejoiner must be contributing again within
    ``--recovery_bound_s`` and A must still reach its target step count."""
    log("phase 2: 2-peer elastic lm; kill + respawn peer B mid-run")
    port = _soak.free_port()
    ckpt_dir = os.path.join(workdir, "ckpt")
    faults = f"seed={plan.seed},rpc_drop={flags.rpc_drop},rpc_dup={flags.rpc_dup}"
    a_log = os.path.join(workdir, "peerA.log")
    b_log = os.path.join(workdir, "peerB.log")
    b2_log = os.path.join(workdir, "peerB_respawn.log")
    # A must outlive B's kill AND the respawned B's whole recovery, so the
    # broker it hosts stays up while the recovery bound is measured: its
    # target is stretched, and it holds while its cohort is short.
    target = sched["cohort_target"]
    hold = ["--min_cohort", "2"]
    a = spawn_lm(lm_args(flags, target, ckpt_dir, port=port, name="peerA") + hold, a_log,
                 faults)
    b = spawn_lm(lm_args(flags, target, None, connect=port, name="peerB") + hold, b_log, faults)
    b2 = None
    deadline = time.monotonic() + flags.phase_deadline
    try:
        _soak.wait_for(lambda: logged_steps(a_log)
                       and logged_steps(a_log)[-1] >= sched["early_progress"],
                       deadline, "waiting for early progress", procs=(a,))
        if b.poll() is None:
            plan.kill_process(b)
            log(f"killed peer B (pid {b.pid}) at step ~{logged_steps(a_log)[-1]} of {target}")
        # Respawn B; its rejoin is SLO-gated: kill-to-contributing must fit
        # --recovery_bound_s.
        t_respawn = time.monotonic()
        b2 = spawn_lm(lm_args(flags, target, None, connect=port, name="peerB2") + hold, b2_log,
                      faults)
        rec_deadline = min(deadline, t_respawn + flags.recovery_bound_s)
        def b2_recovered():
            if a.poll() is not None:  # its broker is gone: B can never rejoin
                raise SystemExit(f"FAIL: peer A ended (rc={a.returncode}) before the "
                                 "respawned peer B recovered")
            return recovered_line(b2_log)

        rec = _soak.wait_for(b2_recovered, rec_deadline,
                             f"waiting for respawned peer B to recover "
                             f"(bound {flags.recovery_bound_s:.0f}s)", procs=(a, b2))
        took = time.monotonic() - t_respawn
        log(f"respawned peer B contributing after {took:.1f}s "
            f"(bound {flags.recovery_bound_s:.0f}s): {rec}")
        _finish(a, a_log, max(5.0, deadline - time.monotonic()), "peer A")
        steps = logged_steps(a_log)
        assert steps and steps[-1] >= target - 10, steps[-10:]
        ff = exit_line(a_log, "frame_faults")
        if not ff or ff["drop"] <= 0 or ff["dup"] <= 0:
            raise SystemExit(f"FAIL: peer A ran without frame chaos (frame_faults: {ff})")
        log(f"phase 2 OK (peer A reached step {steps[-1]}/{target}; "
            f"B recovered in {took:.1f}s; A's frame faults {ff})")
        return {"target": target, "reached": steps[-1], "recovery_s": took,
                "recovery_bound_s": flags.recovery_bound_s, "recovered": json.loads(rec),
                "frame_faults": ff, "kernel_launches": exit_line(a_log, "kernel_launches")}
    finally:
        _soak.kill_tree(a)
        _soak.kill_tree(b)
        if b2 is not None:
            _soak.kill_tree(b2)


def phase_kill_resume(flags, plan, sched, workdir: str, reached: int) -> dict:
    """SIGKILL the leader once fresh checkpoints land, truncate the newest,
    and assert the relaunch resumes from the newest INTACT one."""
    from ..checkpoint import Checkpointer

    log("phase 3: forced kill, checkpoint truncation, resume")
    port = _soak.free_port()
    ckpt_dir = os.path.join(workdir, "ckpt")
    a_log = os.path.join(workdir, "peerA_openended.log")
    # Open-ended relaunch (huge target): resumes from phase 2's final
    # checkpoint, keeps training and checkpointing until we kill it.
    a = spawn_lm(lm_args(flags, reached + 1_000_000, ckpt_dir, port=port, name="peerA"), a_log)
    deadline = time.monotonic() + flags.phase_deadline
    ck = Checkpointer(ckpt_dir)
    try:
        _soak.wait_for(lambda: (ck.latest_step() or 0) > reached, deadline,
                       "waiting for a post-resume checkpoint", procs=(a,))
        plan.kill_process(a)  # forced kill: no finally-block save
        a.wait()
        log(f"killed open-ended peer A (pid {a.pid}) at checkpoint step {ck.latest_step()}")
    finally:
        _soak.kill_tree(a)
    assert resumed_step(a_log), "open-ended run did not resume from checkpoint"

    victim = plan.truncate_checkpoint(ckpt_dir)
    log(f"truncated newest checkpoint payload: {victim}")
    expect_resume = ck.latest_intact_step()
    assert expect_resume is not None, "no intact checkpoint left"

    final_log = os.path.join(workdir, "peerA_final.log")
    target = expect_resume + sched["resume_extra"]
    a = spawn_lm(lm_args(flags, target, ckpt_dir, port=_soak.free_port(), name="peerA"),
                 final_log)
    _finish(a, final_log, flags.phase_deadline, "resumed run")
    got = resumed_step(final_log)
    steps = logged_steps(final_log)
    assert got == expect_resume, f"resumed from {got}, expected newest intact {expect_resume}"
    # Step-counter continuity: the first logged step continues past the
    # resume point (no restart from zero), and the target was reached.
    assert steps and steps[0] >= got and steps[-1] >= target - 10, steps
    log(f"phase 3 OK (resumed from intact step {got}, reached {steps[-1]})")
    return {"truncated": victim, "resumed_from": got, "reached": steps[-1]}


def phase_ckpt_distributed(flags, plan, sched, workdir: str) -> dict:
    """2-peer sharded cohort writing DISTRIBUTED checkpoints into one
    shared directory; peer B is SIGKILLed mid-shard-write.  The torn step
    dir is never eligible; the relaunched 1-host cohort resumes from the
    newest COMMITTED snapshot with step continuity; the per-capture stall
    stays under 10% of the mean step time."""
    from ..checkpoint import DistributedCheckpointer

    log("phase 4: distributed checkpoints; kill peer B mid-shard-write")
    port = _soak.free_port()
    dckpt_dir = os.path.join(workdir, "dckpt")
    a_log = os.path.join(workdir, "dpeerA.log")
    b_log = os.path.join(workdir, "dpeerB.log")
    target = sched["dckpt_target"]
    shard_args = ["--shard_grads", "--form_cohort", "2"]
    a = spawn_lm(shard_args + lm_args(flags, target, dckpt_dir, port=port, name="dpeerA"), a_log)
    # The victim's shard writes dawdle between staging and rename
    # (MOOLIB_CKPT_WRITE_DELAY) so the mid-write kill window is wide enough
    # to hit deterministically.
    b = spawn_lm(shard_args + lm_args(flags, target, dckpt_dir, connect=port, name="dpeerB"),
                 b_log, extra_env={"MOOLIB_CKPT_WRITE_DELAY": "0.4"})
    ck = DistributedCheckpointer(dckpt_dir)
    deadline = time.monotonic() + flags.phase_deadline
    try:
        _soak.wait_for(lambda: ck.latest_committed_step() is not None, deadline,
                       "waiting for the first committed cohort checkpoint", procs=(a, b))
        victim_tmp = plan.kill_mid_shard_write(b, dckpt_dir,
                                               timeout=max(5.0, deadline - time.monotonic()))
        if victim_tmp is None:
            raise SystemExit("FAIL: no shard write observed to kill under")
        log(f"killed peer B (pid {b.pid}) mid-shard-write: {victim_tmp}")
        # A absorbs the loss (cohort shrinks to 1, checkpointing continues)
        # and must still reach its target.
        _finish(a, a_log, max(5.0, deadline - time.monotonic()), "peer A after mid-write kill")
    finally:
        _soak.kill_tree(a)
        _soak.kill_tree(b)

    committed = ck.committed_steps()
    assert committed, "no committed distributed checkpoint survived"
    expect_resume = committed[-1]
    # Zero eligible torn checkpoints: everything restore can select is
    # committed, and every torn/uncommitted husk is verifiably NOT.
    torn = [name for name in os.listdir(dckpt_dir)
            if name.startswith("step_") and not name.endswith(".tmp")
            and not os.path.exists(os.path.join(dckpt_dir, name, "cohort_manifest.json"))]
    for name in torn:
        assert int(name[len("step_"):]) not in committed
    log(f"committed steps {committed}; torn/uncommitted dirs ignored: {torn}")

    # Non-stalling capture, measured: per-capture stall < 10% of step time.
    s = _ckpt_async_stats(a_log)
    assert s and s["captures"] >= 1, f"no capture stats in peer A log: {s}"
    step_time = s["train_s"] / max(s["steps"], 1.0)
    stall = s["stall_s"] / s["captures"]
    assert stall < 0.10 * step_time, (
        f"async capture stalls the step: {stall:.4f}s/capture vs 10% of {step_time:.4f}s step")
    log(f"capture stall {stall * 1e3:.2f}ms vs step {step_time * 1e3:.1f}ms "
        f"({s['captures']:.0f} captures, {s['commits']:.0f} commits)")

    # Elastic M<N restore: the 2-host checkpoint restores onto a 1-host
    # cohort from the newest COMMITTED step, with step continuity.
    final_log = os.path.join(workdir, "dpeerA_final.log")
    final_target = expect_resume + sched["resume_extra"]
    a = spawn_lm(["--shard_grads"] + lm_args(flags, final_target, dckpt_dir,
                                             port=_soak.free_port(), name="dpeerA"), final_log)
    _finish(a, final_log, flags.phase_deadline, "distributed-resume run")
    got = resumed_step(final_log)
    steps = logged_steps(final_log)
    assert got == expect_resume, f"resumed from {got}, expected newest committed {expect_resume}"
    assert steps and steps[0] >= got and steps[-1] >= final_target - 10, steps
    log(f"phase 4 OK (resumed 1-host from committed step {got} of a 2-host cohort, "
        f"reached {steps[-1]})")
    return {"committed": committed, "torn": torn, "ckpt_async": s,
            "stall_per_capture_s": stall, "step_s": step_time,
            "resumed_from": got, "reached": steps[-1],
            "resumed_kernel_launches": exit_line(final_log, "kernel_launches")}


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="seeded chaos soak")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="~60 s CI profile (small step targets, tight deadlines)")
    ap.add_argument("--steps", type=int, default=None,
                    help="phase-2 target optimizer steps (default 60 smoke / 300 full)")
    ap.add_argument("--checkpoint_interval", type=float, default=1.0)
    ap.add_argument("--rpc_drop", type=float, default=0.02)
    ap.add_argument("--rpc_dup", type=float, default=0.01)
    ap.add_argument("--recovery_bound_s", type=float, default=None,
                    help="respawned-peer rejoin SLO: kill-to-contributing seconds "
                    "(default 60 smoke / 90 full)")
    ap.add_argument("--phase_deadline", type=float, default=None,
                    help="per-phase wall deadline, seconds")
    _soak.add_lm_shape_flags(ap, vocab=16, seq_len=16, batch_size=2, d_model=16, layers=1,
                             heads=1)
    ap.add_argument("--device", default=None, help="the LM peers' torch device (default: cuda)")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--out", default=None, help="write a JSON summary of the phases here")
    return ap


def parse_flags(argv=None):
    flags = make_parser().parse_args(argv)
    if flags.steps is None:
        flags.steps = 60 if flags.smoke else 300
    if flags.phase_deadline is None:
        flags.phase_deadline = 150.0 if flags.smoke else 600.0
    if flags.recovery_bound_s is None:
        flags.recovery_bound_s = 60.0 if flags.smoke else 90.0
    return flags


def main(argv=None) -> int:
    flags = parse_flags(argv)
    flags.device = _soak.device_arg(flags.device)
    workdir = _soak.workdir(flags.workdir, "chaos_soak_")

    from ..testing import FaultPlan

    plan = FaultPlan(flags.seed)
    sched = schedule(flags, plan)
    log(f"seed={flags.seed} workdir={workdir} steps={flags.steps} "
        f"recovery_bound={flags.recovery_bound_s:.0f}s device={flags.device}")
    summary = {"soak": "chaos", "seed": flags.seed, "smoke": flags.smoke, "device": flags.device,
               "lm": {k: getattr(flags, k) for k in _soak.LM_SHAPE_FLAGS}}
    summary["envpool"] = phase_envpool(plan, sched["envpool_worker"])
    summary["cohort"] = phase_cohort(flags, plan, sched, workdir)
    summary["kill_resume"] = phase_kill_resume(flags, plan, sched, workdir,
                                               summary["cohort"]["target"])
    summary["ckpt_distributed"] = phase_ckpt_distributed(flags, plan, sched, workdir)
    summary["plan_actions"] = [list(a) for a in plan.actions]
    if flags.out:
        with open(flags.out, "w") as f:
            json.dump(summary, f, indent=1, default=str)
    log(f"CHAOS SOAK OK (fault log: {plan.actions})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
