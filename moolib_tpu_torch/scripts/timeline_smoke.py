"""Timeline/overlap CI smoke: periodic capture windows on a live 2-peer cohort.

The port of the JAX package's ``scripts/timeline_smoke.py``: the
acceptance drive for the fused host+device step timeline, end to end with
real subprocesses:

1. Two peer subprocesses (peer 0 hosts the broker) form an accumulator
   cohort with ``MOOLIB_TIMELINE_INTERVAL`` windows enabled.  Each peer
   runs instrumented steps (a ``torch.matmul`` on ``--device`` through
   ``devmon.instrument``) with an in-mesh share-down
   (``parallel.redistribute`` over the peer's own one-rank gloo group →
   ``accum_psum_seconds`` and the window's comm span) and a cohort
   ``reduce_gradients`` round per step, then checks its last ingested
   window: ``step_time_fraction{bucket}`` sums to 1.0 ± 0.02, finite
   ``exposed_comm_seconds``, and timeline-measured collective seconds
   within [0.5, 2.0]× of the host ``accum_psum_seconds`` growth.  On a
   card the window must also hold the card's own records: CUDA kernel
   slices on a device track of the window's ``bubble``, and the card's
   memory sampled by devmon.
2. While the cohort lingers, ``python -m moolib_tpu_torch.scripts.mtop
   --once`` scrapes it through the broker and must render both peers (MFU
   / HBM / skew columns) plus the flight-ring tail.

Each peer emits one ``{"metric": "step_overlap", ...}`` JSON row (the JAX
row's keys) and one ``{"metric": "step_overlap_device", ...}`` row (the
window's device slices, kernel records and tracks, and the memory labels
devmon sampled); the parent process reprints both.  No benchmark file is
written.

Usage::

    python -m moolib_tpu_torch.scripts.timeline_smoke --smoke --device cpu
    python -m moolib_tpu_torch.scripts.timeline_smoke --steps 80 --interval 10
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from . import _soak

log = _soak.logger("timeline_smoke")


def _device_row(flags, report, timeline, devmon) -> dict:
    """What the last window holds of the card: its device slices, the CUDA
    kernel records among them (count, seconds inside the window's steps),
    the device tracks, and the memory labels devmon sampled."""
    slices = timeline.load_profiler_trace(report.get("logdir"))
    unix_ns, perf_ns = report["anchor"]
    first_us = (unix_ns + report["dispatches"][0][1] - perf_ns) / 1e3
    kernels = [s for s in slices if s["cat"] == "kernel"]
    return {
        "metric": "step_overlap_device",
        "peer": f"tl-peer-{flags.index}",
        "device": flags.device,
        "slices": report["slices"],
        "kernel_records": len(kernels),
        "kernel_seconds_in_steps": sum(s["dur_us"] for s in kernels
                                       if s["ts_us"] >= first_us) / 1e6,
        "device_tracks": sorted({s["track"] for s in slices if s["cat"] in timeline.DEVICE_CATS}),
        "bubble": report["bubble"],
        "memory": sorted(devmon.sample_memory()),
    }


# -------------------------------------------------------------------- worker
def worker_peer(flags) -> int:
    """One cohort peer: instrumented step loop with timeline windows on,
    self-validates the last window, prints its step_overlap rows, lingers
    until the stop file so mtop can scrape a live cohort."""
    os.environ["MOOLIB_TIMELINE_INTERVAL"] = str(flags.interval)
    os.environ["MOOLIB_TIMELINE_WINDOW_S"] = str(flags.window_s)
    os.environ.setdefault("MOOLIB_PROFILE_DIR", os.path.dirname(flags.out))

    import torch

    from .. import Accumulator, Broker, parallel, telemetry
    from ..telemetry import devmon, profiling, timeline

    telemetry.init_from_env()
    if timeline.status()["interval"] != flags.interval:
        print(f"peer {flags.index}: timeline interval {timeline.status()}", flush=True)
        return 4
    dev = torch.device(flags.device)
    cuda = dev.type == "cuda"
    # The share-down's mesh: this peer alone, over a gloo group of its own
    # (its own store and port), so the two peers never join one world.
    parallel.initialize_distributed(f"127.0.0.1:{flags.pg_port}", 1, 0, device=dev,
                                    backend="gloo")
    mesh = parallel.make_mesh({"dp": 1}, device_type=dev.type)
    sharding = parallel.replicated(mesh)

    # Warm the profiler before the cohort forms: the first start of a
    # process pays seconds of one-time set-up (CUPTI on a card), which would
    # otherwise push the first timeline windows past this short loop.
    warm = profiling.start_device_trace(
        os.path.join(os.path.dirname(flags.out), f"warmup-{flags.index}"))
    if warm.get("ok"):
        profiling.stop_device_trace()

    broker = None
    if flags.index == 0:
        broker = Broker()
        broker.set_name("broker")
        broker.listen(f"127.0.0.1:{flags.port}")
    acc = Accumulator("tlsmoke", {"w": torch.zeros(8)})
    acc.set_name(f"tl-peer-{flags.index}")
    acc.listen("127.0.0.1:0")
    acc.connect(f"127.0.0.1:{flags.port}")

    def pump():
        if broker is not None:
            broker.update()
        acc.update()
        if acc.wants_state():
            acc.set_state({"v": 0})

    def wait(cond, what, deadline_s=None):
        deadline = time.monotonic() + (deadline_s or flags.deadline)
        while time.monotonic() < deadline:
            pump()
            if cond():
                return True
            time.sleep(0.02)
        print(f"peer {flags.index}: timeout waiting for {what}", flush=True)
        return False

    if not wait(lambda: acc.connected() and len(acc._group.members()) == 2,
                "cohort formation"):
        return 3

    # The instrumented step: a matmul on the device (the dispatch anchor
    # every timeline window keys on) + a blocking share-down
    # (accum_psum_seconds and the window's comm plane) + one cohort reduce
    # round (real RPC comm, so the loop is paced like a train loop).
    w = torch.ones(192, 192, device=dev)

    def fn(x):
        return torch.matmul(x, x).sum()

    step = devmon.instrument(fn, "smoke.train_step")
    cost = devmon.step_cost("smoke.train_step", fn, w)

    t_loop = time.monotonic()
    for k in range(flags.steps):
        t_step = time.monotonic()
        step(w)
        if cuda:
            torch.cuda.synchronize(dev)
        parallel.redistribute({"w": w}, sharding, block=True)
        grads = {"w": torch.full((8,), float(flags.index + 1))}
        acc.reduce_gradients(4, grads)
        # Cohort churn (an epoch bump) cancels in-flight rounds and hands
        # the contribution back: wants_gradients() comes true again and the
        # caller re-contributes (the standard accumulator loop contract).
        round_deadline = time.monotonic() + 60.0
        while not acc.has_gradients():
            if time.monotonic() >= round_deadline:
                print(f"peer {flags.index}: timeout waiting for round {k}", flush=True)
                return 3
            pump()
            if acc.wants_gradients():
                acc.reduce_gradients(4, grads)
            time.sleep(0.02)
        acc.zero_gradients()
        devmon.publish_step("smoke.train_step", cost, time.monotonic() - t_step)
        time.sleep(0.01)  # pace the loop so windows span several steps
    steps_per_s = flags.steps / (time.monotonic() - t_loop)
    devmon.sample_memory()

    # Windows ingest on a daemon thread; wait for the last one to land.
    wait(lambda: not timeline.status()["active"] and timeline.status()["windows"] >= 1,
         "timeline window ingest", deadline_s=30.0)
    st = timeline.status()
    report = st["last_report"]
    ok = True
    if not st["windows"] or not report or not report.get("fns"):
        print(f"peer {flags.index}: no ingested timeline window: {st}", flush=True)
        ok = False
    else:
        fracs = {b: 0.0 for b in timeline.BUCKETS}
        total_s = 0.0
        window_steps = 0
        for fname, row in report["fns"].items():
            s = sum(row["fractions"].values())
            if abs(s - 1.0) > 0.02:
                print(f"peer {flags.index}: fractions for {fname} sum to {s}", flush=True)
                ok = False
            for b in timeline.BUCKETS:
                fracs[b] += row["seconds"][b]
            total_s += row["total_seconds"]
            window_steps += row["steps"]
        fracs = {b: v / max(total_s, 1e-9) for b, v in fracs.items()}
        exposed = report["exposed_comm_seconds"]
        ratio = report["comm_vs_psum_ratio"]
        if not (exposed >= 0.0 and exposed == exposed):  # finite, non-negative
            print(f"peer {flags.index}: bad exposed_comm {exposed}", flush=True)
            ok = False
        if ratio is None or not (0.5 <= ratio <= 2.0):
            print(f"peer {flags.index}: comm_vs_psum_ratio {ratio} outside [0.5, 2.0]",
                  flush=True)
            ok = False
        row = {
            "metric": "step_overlap",
            "peer": f"tl-peer-{flags.index}",
            "steps": flags.steps,
            "steps_per_s": round(steps_per_s, 3),
            "windows": st["windows"],
            "window_steps": window_steps,
            "frac_compute": round(fracs["compute"], 4),
            "frac_comm": round(fracs["comm"], 4),
            "frac_host": round(fracs["host"], 4),
            "frac_idle": round(fracs["idle"], 4),
            "exposed_comm_seconds": round(exposed, 6),
            "exposed_comm_s_per_step": round(exposed / max(window_steps, 1), 6),
            "overlapped_comm_seconds": round(report["overlapped_comm_seconds"], 6),
            "comm_vs_psum_ratio": round(ratio, 3) if ratio is not None else None,
        }
        print(json.dumps(row), flush=True)
        drow = _device_row(flags, report, timeline, devmon)
        print(json.dumps(drow), flush=True)
        # On a card the window must hold the card's own records, not only
        # the host's dispatch intervals.
        if cuda and not (drow["kernel_records"] and drow["kernel_seconds_in_steps"] > 0
                         and set(drow["device_tracks"]) & set(drow["bubble"])
                         and any(m.startswith("cuda") for m in drow["memory"])):
            print(f"peer {flags.index}: the window holds no device slices of the card: "
                  f"{drow}", flush=True)
            ok = False

    # Linger (pumping) so mtop scrapes a LIVE cohort, then drain.
    stop = flags.out + ".stop"
    wait(lambda: os.path.exists(stop), "stop file", deadline_s=flags.deadline)
    acc.close()
    if broker is not None:
        broker.close()
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0 if ok else 4


# -------------------------------------------------------------------- parent
def _rows(text: str, metric: str) -> list:
    out = []
    for line in text.splitlines():
        try:
            row = json.loads(line)
        except ValueError:
            continue
        if isinstance(row, dict) and row.get("metric") == metric:
            out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI profile (the defaults; flag kept for symmetry)")
    ap.add_argument("--steps", type=int, default=48)
    ap.add_argument("--interval", type=int, default=8,
                    help="MOOLIB_TIMELINE_INTERVAL for the workers")
    ap.add_argument("--window-s", type=float, default=0.4)
    ap.add_argument("--deadline", type=float, default=240.0)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device of the peers' steps (default: cuda)")
    # Worker mode (internal).
    ap.add_argument("--worker", choices=("peer",), default=None)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--pg-port", type=int, default=0)
    ap.add_argument("--index", type=int, default=0)
    ap.add_argument("--out", default=None)
    flags = ap.parse_args(argv)
    flags.device = _soak.device_arg(flags.device)

    if flags.worker == "peer":
        return worker_peer(flags)

    workdir = _soak.workdir(flags.workdir, "timeline_smoke_")
    port = _soak.free_port()
    log(f"workdir={workdir} steps={flags.steps} interval={flags.interval} device={flags.device}")
    procs, logs, outs = {}, {}, []
    for i in range(2):
        out = os.path.join(workdir, f"peer{i}.out")
        # A stale stop file from a previous run in a reused --workdir would
        # make the peer skip its linger and strand mtop on a dead cohort.
        try:
            os.unlink(out + ".stop")
        except OSError:
            pass
        outs.append(out)
        logs[f"peer{i}"] = os.path.join(workdir, f"peer{i}.log")
        procs[f"peer{i}"] = _soak.spawn(
            "moolib_tpu_torch.scripts.timeline_smoke",
            ["--worker", "peer", "--port", str(port), "--pg-port", str(_soak.free_port()),
             "--index", str(i), "--steps", str(flags.steps), "--interval", str(flags.interval),
             "--window-s", str(flags.window_s), "--out", out, "--deadline", str(flags.deadline),
             "--device", flags.device],
            logs[f"peer{i}"])

    rows, device_rows = [], []
    try:
        # Wait until both peers printed their step_overlap row (== the step
        # loop and timeline validation finished; they now linger pumping).
        deadline = time.monotonic() + flags.deadline
        pending = set(logs)
        while pending and time.monotonic() < deadline:
            for name in list(pending):
                p = procs[name]
                if p.poll() is not None:
                    _soak.dump_tail(logs[name], 4000)
                    raise SystemExit(f"FAIL: {name} exited rc={p.returncode} before its row")
                if '"step_overlap_device"' in _soak.read(logs[name]):
                    pending.discard(name)
            time.sleep(0.2)
        if pending:
            for name in pending:
                _soak.dump_tail(logs[name], 4000)
            raise SystemExit(f"FAIL: {sorted(pending)} never emitted a row")
        log("both peers validated their timeline windows; running mtop --once")

        # mtop console smoke against the live, lingering cohort.
        mtop_log = os.path.join(workdir, "mtop.log")
        mtop = _soak.spawn("moolib_tpu_torch.scripts.mtop",
                           ["--broker", f"127.0.0.1:{port}", "--group", "tlsmoke", "--once",
                            "--require-peers", "2", "--timeout", "10"], mtop_log)
        rc = mtop.wait(timeout=120)
        mtop_out = _soak.read(mtop_log)
        if rc != 0:
            _soak.dump_tail(mtop_log, 4000)
            raise SystemExit(f"FAIL: mtop --once rc={rc}")
        for needed in ("tl-peer-0", "tl-peer-1", "MFU%", "HBM", "SKEW"):
            if needed not in mtop_out:
                _soak.dump_tail(mtop_log, 4000)
                raise SystemExit(f"FAIL: mtop frame is missing {needed!r}")
        if "flight ring" not in mtop_out:
            _soak.dump_tail(mtop_log, 4000)
            raise SystemExit("FAIL: mtop frame has no flight-ring tail")
        log("mtop --once rendered both peers + flight ring")

        # Release the cohort and collect the rows.
        for out in outs:
            open(out + ".stop", "w").close()
        deadline = time.monotonic() + 60
        for name, p in procs.items():
            rest = max(1.0, deadline - time.monotonic())
            try:
                rc = p.wait(timeout=rest)
            except subprocess.TimeoutExpired:
                p.kill()
                _soak.dump_tail(logs[name], 4000)
                raise SystemExit(f"FAIL: {name} never exited")
            if rc != 0:
                _soak.dump_tail(logs[name], 4000)
                raise SystemExit(f"FAIL: {name} exited rc={rc}")
        for name in sorted(logs):
            text = _soak.read(logs[name])
            rows += _rows(text, "step_overlap")
            device_rows += _rows(text, "step_overlap_device")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()

    if len(rows) != 2:
        raise SystemExit(f"FAIL: expected 2 step_overlap rows, got {len(rows)}")
    for row in rows + device_rows:
        print(json.dumps(row), flush=True)
    log("TIMELINE SMOKE OK: " + ", ".join(
        f"{r['peer']} {r['steps_per_s']}st/s exposed {r['frac_comm']:.0%}" for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
