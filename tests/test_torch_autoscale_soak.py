"""The port's autoscaling soak end to end on the CPU: an ``Autoscaler``
over a ``SubprocessFleet`` of ``examples.lm`` workers under seeded Poisson
preemption and one graceful decommission, under the JAX script's gates.
Marked slow: its own profile is minutes of windows."""

import json
import os
import subprocess
import sys

import pytest

from conftest import subprocess_env

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
def test_autoscale_soak_smoke_passes_every_gate(tmp_path):
    out = tmp_path / "verdict.json"
    env = dict(subprocess_env(ROOT), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "moolib_tpu_torch.scripts.autoscale_soak",
                        "--smoke", "--device", "cpu", "--workdir", str(tmp_path / "work"),
                        "--out", str(out)], env=env, cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-3000:]
    v = json.loads(out.read_text())
    assert v["ok"] and v["unrecovered_kills"] == 0 and v["kills"] >= 1
    assert v["vbatch_violations"] == 0 and v["final_cohort"] >= v["target_peers"]
    assert v["graceful_leave_s"] < 1.0
