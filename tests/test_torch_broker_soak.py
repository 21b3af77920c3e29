"""The port's broker-HA soak end to end on the CPU: a primary + standby
broker pair of ``python -m moolib_tpu_torch.broker`` processes, the primary
SIGKILLed mid-allreduce and mid-serve, under the JAX script's gates."""

import json
import os
import subprocess
import sys

from conftest import subprocess_env

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_broker_soak_smoke_passes_every_gate(tmp_path):
    out = tmp_path / "verdict.json"
    env = dict(subprocess_env(ROOT), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "moolib_tpu_torch.scripts.broker_soak", "--smoke",
                        "--device", "cpu", "--workdir", str(tmp_path / "work"),
                        "--out", str(out)], env=env, cwd=ROOT, capture_output=True,
                       text=True, timeout=240)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-2000:]
    verdict = json.loads(out.read_text())
    assert verdict["pass"] and verdict["device"] == "cpu"
    assert verdict["gates"] and all(verdict["gates"].values()), verdict["gates"]
    assert verdict["serving"]["lost_requests"] == 0
    assert verdict["training"]["post_kill_rounds_ok"] >= 3
    # Every child log stayed under the soak's own work directory.
    assert sorted(os.listdir(tmp_path / "work")) == [
        "broker0_serve.log", "broker0_train.log", "broker1_serve.log", "broker1_train.log"]
