"""The port's two-process replay smoke on the CPU under the lock-order
graph: memfd-multicast ingest to an in-process and a child-process
``DeviceReplayShard``, the two-level cohort draw and the write-back."""

import os
import subprocess
import sys

from conftest import subprocess_env

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_replay_smoke_passes_every_gate_under_lockgraph():
    env = dict(subprocess_env(ROOT), OMP_NUM_THREADS="1", MOOLIB_LOCKGRAPH="1")
    r = subprocess.run([sys.executable, "-m", "moolib_tpu_torch.scripts.replay_smoke", "--smoke",
                        "--device", "cpu"], env=env, cwd=ROOT, capture_output=True, text=True,
                       timeout=180)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-2000:]
    assert "replay_smoke: OK (device=cpu)" in r.stdout
    gates = [ln for ln in r.stdout.splitlines() if ln.startswith(("ok  ", "FAIL"))]
    assert len(gates) == 7 and all(ln.startswith("ok  ") for ln in gates), gates
    assert "cycles=0" in r.stdout + r.stderr
