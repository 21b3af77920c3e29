"""Cohort launcher: bring up a broker + N training peers (the port's copy
of the JAX package's ``examples/launch.py``).

Counterpart of the reference's SLURM generator (``examples/sbatch_experiment.py
:96-219``), extended for multi-host GPU clusters:

- ``local`` mode: spawn the broker and N peers as local processes (smoke
  tests, single-host multi-peer; each peer can pin a different card via
  ``--peer_env CUDA_VISIBLE_DEVICES={i}``).
- ``sbatch`` mode: emit a SLURM batch script (one broker task + array of
  peers), like the reference.
- ``pod`` mode: emit per-host command lines — host 0 runs the broker,
  every host runs the agent, with the ``torch.distributed`` rendezvous
  flags for the collective plane (``--ici``); paste into your cluster
  runner.

Run: ``python -m moolib_tpu_torch.examples.launch local --num_peers 2 --
    python -m moolib_tpu_torch.examples.a2c --connect 127.0.0.1:4431``
"""

from __future__ import annotations

import argparse
import os
import shlex
import signal
import subprocess
import sys
import time


def launch_local(args, agent_cmd):
    procs = []
    env = dict(os.environ)
    broker_cmd = [
        sys.executable,
        "-m",
        "moolib_tpu_torch.broker",
        "--address",
        args.broker_address,
    ]
    print("+", " ".join(broker_cmd))
    procs.append(subprocess.Popen(broker_cmd, env=env))
    time.sleep(1.0)
    for i in range(args.num_peers):
        peer_env = dict(env)
        for kv in args.peer_env:
            k, _, v = kv.partition("=")
            peer_env[k] = v.replace("{i}", str(i))
        cmd = [c.replace("{i}", str(i)) for c in agent_cmd]
        print(f"+ peer{i}:", " ".join(cmd))
        procs.append(subprocess.Popen(cmd, env=peer_env))

    def shutdown(*_):
        for p in procs:
            p.terminate()

    signal.signal(signal.SIGINT, shutdown)
    signal.signal(signal.SIGTERM, shutdown)
    # Exit when all peers (not the broker) finish.
    for p in procs[1:]:
        p.wait()
    procs[0].terminate()


def emit_sbatch(args, agent_cmd):
    agent = " ".join(shlex.quote(c) for c in agent_cmd)
    script = f"""#!/bin/bash
#SBATCH --job-name={args.job_name}
#SBATCH --ntasks={args.num_peers + 1}
#SBATCH --cpus-per-task={args.cpus_per_task}
#SBATCH --output={args.job_name}-%j.out

BROKER_HOST=$(scontrol show hostnames $SLURM_JOB_NODELIST | head -n1)
BROKER_ADDR=$BROKER_HOST:{args.broker_port}

# srun fans one instance of this block out per task; task 0 is the broker.
srun bash -c '
if [ "$SLURM_PROCID" -eq 0 ]; then
  python -m moolib_tpu_torch.broker --address 0.0.0.0:{args.broker_port}
else
  sleep 5  # let the broker come up (reference waits for broker-online)
  {agent} --connect '"$BROKER_ADDR"'
fi
'
"""
    print(script)


def emit_pod(args, agent_cmd):
    agent = " ".join(shlex.quote(c) for c in agent_cmd)
    print(f"# host 0 (also runs the broker on :{args.broker_port}):")
    print(f"python -m moolib_tpu_torch.broker --address 0.0.0.0:{args.broker_port} &")
    print("# every host (replace $HOST0 with host 0's address):")
    print(f"{agent} --connect $HOST0:{args.broker_port}")
    print("# collective plane (--ici): also pass on host $i of $N:")
    print(f"#   --coordinator tcp://$HOST0:{args.coordinator_port} "
          "--num_processes $N --process_id $i")


def main(argv=None):
    p = argparse.ArgumentParser(description="moolib_tpu_torch cohort launcher")
    p.add_argument("mode", choices=["local", "sbatch", "pod"])
    p.add_argument("--num_peers", type=int, default=2)
    p.add_argument("--broker_address", default="127.0.0.1:4431")
    p.add_argument("--broker_port", type=int, default=4431)
    p.add_argument("--coordinator_port", type=int, default=8476)
    p.add_argument("--job_name", default="moolib-tpu-torch")
    p.add_argument("--cpus-per-task", dest="cpus_per_task", type=int, default=10)
    p.add_argument(
        "--peer_env",
        action="append",
        default=[],
        help="KEY=VALUE for peers; '{i}' expands to the peer index",
    )
    argv = sys.argv[1:] if argv is None else argv
    if "--" in argv:
        split = argv.index("--")
        argv, agent_cmd = argv[:split], argv[split + 1 :]
    else:
        agent_cmd = [sys.executable, "-m", "moolib_tpu_torch.examples.a2c"]
    args = p.parse_args(argv)
    if args.mode == "local":
        launch_local(args, agent_cmd)
    elif args.mode == "sbatch":
        emit_sbatch(args, agent_cmd)
    else:
        emit_pod(args, agent_cmd)


if __name__ == "__main__":
    main()
