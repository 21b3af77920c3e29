"""Distributed-tracing CI smoke: real subprocesses, one merged timeline.

The port of the JAX package's ``scripts/trace_smoke.py``: the
trace-propagation acceptance gate, driven end to end with real processes
so the cross-process parent/child edges are genuine (an in-process test
shares one tracer and proves nothing about the wire):

1. **Allreduce cohort**: N peer subprocesses (peer 0 hosts the broker) form
   an accumulator cohort and run a few ``reduce_gradients`` rounds of
   gradients held as tensors on ``--device``.  Each round is a
   ``root_span`` in the reducing peer, and the tree-op RPCs carry its
   context to the others.  Every peer exports its host Chrome trace;
   ``moolib_tpu_torch.scripts.trace_merge`` must stitch them with >= 1
   cross-process parent/child edge (``--require-edges``).
2. **Serve request**: a replica subprocess (broker + ServeReplica, its step
   a scale on ``--device``) answers requests from a ServeClient in this
   process; each request is a client-side root trace whose context crosses
   into the replica's ``rpc.recv`` / ``serve.batch`` spans.  Both traces
   merge the same way.

Exit 0 only when both merges validate as JSON with the required edges and
the expected span names present.  Each merge's stats line is logged
(``trace_merge {...}``: edges, traces, per-pid skew offsets).  This process
never touches the card; ``--device`` (no value: the card, which must be
present) is where the workers hold their tensors.

Usage::

    python -m moolib_tpu_torch.scripts.trace_smoke --smoke --device cpu
    python -m moolib_tpu_torch.scripts.trace_smoke --peers 3 --rounds 3
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from . import _soak

log = _soak.logger("trace_smoke")


def spawn_worker(args, log_path):
    return _soak.spawn("moolib_tpu_torch.scripts.trace_smoke", args, log_path)


def await_procs(procs, logs, deadline_s, what):
    deadline = time.monotonic() + deadline_s
    pending = dict(procs)
    while pending and time.monotonic() < deadline:
        for name, p in list(pending.items()):
            rc = p.poll()
            if rc is None:
                continue
            if rc != 0:
                _soak.dump_tail(logs[name], 3000)
                raise SystemExit(f"FAIL: {name} exited rc={rc} during {what}")
            del pending[name]
        time.sleep(0.1)
    if pending:
        for name in pending:
            _soak.dump_tail(logs[name], 3000)
            pending[name].kill()
        raise SystemExit(f"FAIL: {sorted(pending)} never finished {what}")


def run_merge(inputs, out, require_edges: int) -> dict:
    """trace_merge as a subprocess (the exact CLI operators use); returns
    the stats line and re-validates the merged file as JSON."""
    cmd = [sys.executable, "-m", "moolib_tpu_torch.scripts.trace_merge",
           "--out", out, "--require-edges", str(require_edges)] + inputs
    res = subprocess.run(cmd, capture_output=True, text=True, cwd=_soak.ROOT,
                         env=_soak.child_env())
    sys.stderr.write(res.stderr)
    if res.returncode != 0:
        raise SystemExit(f"FAIL: trace_merge rc={res.returncode}: {res.stdout}")
    line = res.stdout.strip().splitlines()[-1]
    log(f"trace_merge {line}")
    stats = json.loads(line)
    with open(out) as f:
        merged = json.load(f)  # must be valid JSON
    names = {e.get("name") for e in merged["traceEvents"]}
    return {"stats": stats, "names": names}


# ------------------------------------------------------------------- workers
def worker_allreduce(flags) -> int:
    """One cohort peer: join, run the rounds in lockstep, export the trace."""
    import torch

    from .. import Accumulator, Broker, telemetry

    dev = torch.device(flags.device)
    broker = None
    if flags.index == 0:
        broker = Broker()
        broker.set_name("broker")
        broker.listen(f"127.0.0.1:{flags.port}")
    acc = Accumulator("tracesmoke", {"w": torch.zeros(8, device=dev)})
    acc.set_name(f"peer{flags.index}")
    acc.listen("127.0.0.1:0")
    acc.connect(f"127.0.0.1:{flags.port}")

    def pump():
        if broker is not None:
            broker.update()
        acc.update()
        if acc.wants_state():
            acc.set_state({"v": 0})

    def wait(cond, what):
        deadline = time.monotonic() + flags.deadline
        while time.monotonic() < deadline:
            pump()
            if cond():
                return
            time.sleep(0.02)
        print(f"worker {flags.index}: timeout waiting for {what}", flush=True)
        sys.exit(3)

    wait(lambda: acc.connected() and len(acc._group.members()) == flags.peers,
         "cohort formation")
    for k in range(flags.rounds):
        acc.reduce_gradients(4, {"w": torch.full((8,), float(flags.index + 1), device=dev)})
        wait(acc.has_gradients, f"round {k}")
        acc.zero_gradients()
    # Drain briefly so late share-down frames land in every peer's trace
    # before export (the broker host must outlive the slowest peer's round).
    t_end = time.monotonic() + 1.0
    while time.monotonic() < t_end:
        pump()
        time.sleep(0.02)
    telemetry.get_tracer().export_chrome_trace(flags.out)
    acc.close()
    if broker is not None:
        broker.close()
    return 0


def worker_replica(flags) -> int:
    """Broker + one ServeReplica; serves until the stop file appears, then
    exports this process's trace."""
    import asyncio
    import threading

    import torch

    from .. import Broker, Rpc, telemetry
    from ..serving import ServeReplica

    dev = torch.device(flags.device)
    broker = Broker()
    broker.set_name("broker")
    broker.listen(f"127.0.0.1:{flags.port}")
    rpc = Rpc()
    rpc.set_name("replica0")
    rpc.listen("127.0.0.1:0")

    def step(params, batch):
        x = torch.as_tensor(batch, dtype=torch.float64).to(dev)
        return (x * params["scale"]).cpu()

    replica = ServeReplica(rpc, step, {"scale": torch.tensor(2.0, dtype=torch.float64, device=dev)},
                           broker=f"127.0.0.1:{flags.port}", batch_size=4)
    t = threading.Thread(target=lambda: asyncio.run(replica.loop()), daemon=True)
    t.start()
    print("REPLICA READY", flush=True)
    stop = flags.out + ".stop"
    deadline = time.monotonic() + flags.deadline
    while time.monotonic() < deadline and not os.path.exists(stop):
        broker.update()
        time.sleep(0.05)
    telemetry.get_tracer().export_chrome_trace(flags.out)
    replica.close()
    broker.close()
    return 0 if os.path.exists(stop) else 3


# -------------------------------------------------------------------- phases
def phase_allreduce(flags, workdir: str) -> None:
    outdir = os.path.join(workdir, "allreduce")
    os.makedirs(outdir, exist_ok=True)
    port = _soak.free_port()
    log(f"phase 1: {flags.peers}-peer allreduce cohort, {flags.rounds} rounds")
    procs, logs, outs = {}, {}, []
    for i in range(flags.peers):
        out = os.path.join(outdir, f"peer{i}.json")
        outs.append(out)
        logs[f"peer{i}"] = os.path.join(outdir, f"peer{i}.log")
        procs[f"peer{i}"] = spawn_worker(
            ["--worker", "allreduce", "--port", str(port), "--index", str(i),
             "--peers", str(flags.peers), "--rounds", str(flags.rounds), "--out", out,
             "--deadline", str(flags.deadline), "--device", flags.device],
            logs[f"peer{i}"])
    try:
        await_procs(procs, logs, flags.deadline + 30, "the allreduce rounds")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    merged = os.path.join(outdir, "merged.json")
    got = run_merge(outs, merged, require_edges=1)
    if "accum.reduce_gradients" not in got["names"]:
        raise SystemExit("FAIL: merged allreduce trace has no round root span")
    log(f"phase 1 OK: {got['stats']['cross_process_edges']} cross-process "
        f"edges across {got['stats']['traces']} traces -> {merged}")


def phase_serve(flags, workdir: str) -> None:
    import numpy as np

    from .. import telemetry
    from ..serving import ServeClient

    outdir = os.path.join(workdir, "serve")
    os.makedirs(outdir, exist_ok=True)
    port = _soak.free_port()
    log("phase 2: serve request through a replica subprocess")
    rep_out = os.path.join(outdir, "replica.json")
    rep_log = os.path.join(outdir, "replica.log")
    proc = spawn_worker(["--worker", "replica", "--port", str(port), "--out", rep_out,
                         "--deadline", str(flags.deadline), "--device", flags.device], rep_log)
    client = None
    try:
        _soak.await_line(rep_log, proc, "REPLICA READY", flags.deadline)
        client = ServeClient(broker=f"127.0.0.1:{port}", deadline_s=20.0)
        client.wait_for_replicas(1, timeout=flags.deadline)
        prompt = np.arange(4, dtype=np.float32)
        for _ in range(flags.requests):
            out = np.asarray(client.call(prompt))
            if not np.allclose(out, prompt * 2.0):
                raise SystemExit(f"FAIL: replica answered {out}")
        cli_out = os.path.join(outdir, "client.json")
        telemetry.get_tracer().export_chrome_trace(cli_out)
        open(rep_out + ".stop", "w").close()
        await_procs({"replica": proc}, {"replica": rep_log}, flags.deadline,
                    "the replica trace export")
    finally:
        if client is not None:
            client.close()
        if proc.poll() is None:
            proc.kill()
    merged = os.path.join(outdir, "merged.json")
    got = run_merge([cli_out, rep_out], merged, require_edges=1)
    for needed in ("serve.request", "serve.batch generate"):
        if needed not in got["names"]:
            raise SystemExit(f"FAIL: merged serve trace is missing {needed!r}")
    log(f"phase 2 OK: {got['stats']['cross_process_edges']} cross-process "
        f"edges across {got['stats']['traces']} traces -> {merged}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI profile (the defaults; flag kept for symmetry)")
    ap.add_argument("--peers", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--deadline", type=float, default=120.0)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device of the workers' tensors (default: cuda)")
    # Worker mode (internal): run one subprocess role and exit.
    ap.add_argument("--worker", choices=("allreduce", "replica"), default=None)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--index", type=int, default=0)
    ap.add_argument("--out", default=None)
    flags = ap.parse_args(argv)
    flags.device = _soak.device_arg(flags.device)

    if flags.worker == "allreduce":
        return worker_allreduce(flags)
    if flags.worker == "replica":
        return worker_replica(flags)

    workdir = _soak.workdir(flags.workdir, "trace_smoke_")
    log(f"workdir={workdir} peers={flags.peers} rounds={flags.rounds} device={flags.device}")
    phase_allreduce(flags, workdir)
    phase_serve(flags, workdir)
    log("TRACE SMOKE OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
