"""The port's seeded chaos soak end to end on the CPU: an EnvPool worker
killed mid-step, the two-peer elastic LM under seeded RPC frame faults with
a peer killed and respawned, a forced kill with a truncated checkpoint and
the resume from the newest intact one, and a mid-shard-write kill under
distributed checkpoints with the resume from the newest commit, under the
JAX script's gates.  Captures every 0.25 s instead of the smoke's 1 s: at
the JAX widths a CPU runs phase 4's whole two-peer target in ~2 s, inside
two captures at 1 s, and the mid-write kill needs a shard write after the
first commit."""

import json
import os
import subprocess
import sys

from conftest import subprocess_env

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chaos_soak_smoke_passes_every_phase(tmp_path):
    out = tmp_path / "summary.json"
    env = dict(subprocess_env(ROOT), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "moolib_tpu_torch.scripts.chaos_soak", "--smoke",
                        "--device", "cpu", "--checkpoint_interval", "0.25",
                        "--workdir", str(tmp_path / "work"),
                        "--out", str(out)], env=env, cwd=ROOT, capture_output=True,
                       text=True, timeout=420)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-3000:]
    assert "CHAOS SOAK OK" in r.stdout
    s = json.loads(out.read_text())
    assert s["envpool"]["restarts"] >= 1
    # Phase 2 ran with the frame chaos on: the peer's seeded drops and dups.
    ff = s["cohort"]["frame_faults"]
    assert ff["drop"] > 0 and ff["dup"] > 0, ff
    assert s["cohort"]["recovery_s"] < s["cohort"]["recovery_bound_s"]
    assert s["kill_resume"]["resumed_from"] >= 1
    d = s["ckpt_distributed"]
    assert d["resumed_from"] == d["committed"][-1]
    assert d["stall_per_capture_s"] < 0.1 * d["step_s"]
    # The resumed peer's exit line counts its learns (no kernel on the CPU).
    k = d["resumed_kernel_launches"]
    assert k["learns"] >= 1 and k["flash_fwd"] == 0, k
