"""CPU rehearsals of chip_smoke.py's two observability phases:
``trace_smoke`` (the tracing smoke through the phase's re-merge and span
checks) and ``timeline_smoke`` (the timeline smoke through the phase's
window, row and mtop-frame checks), each on ``device="cpu"`` and each
leaving no process of its own behind; the phase's reading of an mtop
frame; and the script's end-of-run sweep of the processes it started,
in-process and through ``supervise`` (the script's entry point)."""

import json

import os
import subprocess
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("phase", ["trace_smoke", "timeline_smoke"])
def test_obs_phase_rehearsal(phase, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv(chip_smoke.RUN_MARK, f"{phase}-{os.getpid()}-{time.time_ns()}")
    run = chip_smoke.start_obs_tool(phase, device="cpu")
    if phase == "trace_smoke":
        res = chip_smoke.phase_trace_smoke(device="cpu", running=run)
        assert set(res["merges"]) == {"allreduce", "serve"}
        for stats in res["merges"].values():
            assert stats["cross_process_edges"] >= 1 and stats["traces"] >= 1
            assert stats["skew_offsets_us"]
    else:
        res = chip_smoke.phase_timeline_smoke(device="cpu", running=run)
        assert sorted(res["step_overlap"]) == ["tl-peer-0", "tl-peer-1"]
        assert all(m["HBM"] not in ("", "-") for m in res["mtop"].values())
    assert res["device"] == "cpu" and res["tool_s"] > 0
    assert chip_smoke._marked_processes() == {}


def test_mtop_rows_read_the_frame_columns():
    from moolib_tpu_torch.scripts import mtop

    state = {"time": 0.0, "live": 1, "skew_ratio": 1.0, "straggler": None, "errors": {},
             "flights": [], "rows": [
                 {"name": "tl-peer-0", "role": "member", "step_rate": None, "mfu": 0.5,
                  "hbm": 3.0 * 2**30, "hbm_peak": None, "step_s": None, "exposed": None,
                  "qps": None, "p99": None, "occupancy": None, "gone": False, "error": None},
                 {"name": "tl-peer-1", "role": "member", "step_rate": None, "mfu": None,
                  "hbm": None, "hbm_peak": None, "step_s": None, "exposed": None,
                  "qps": None, "p99": None, "occupancy": None, "gone": True, "error": None}]}
    rows = chip_smoke._mtop_rows(mtop.render_plain(state))
    assert rows["tl-peer-0"]["HBM"] == "3.0G" and rows["tl-peer-0"]["MFU%"] == "50.00"
    assert rows["~tl-peer-1"]["HBM"] == "-" and rows["~tl-peer-1"]["ROLE"] == "gone"


# A process that starts a sleeper in a session of its own and exits at
# once: the sleeper is an orphan, no longer this process's descendant.
ORPHAN = ("import subprocess, sys; subprocess.Popen([sys.executable, '-c', "
          "'import time; time.sleep(600)'], start_new_session=True)")


def test_stop_leftovers_stops_children_and_orphans(monkeypatch):
    monkeypatch.setenv(chip_smoke.RUN_MARK, f"sweep-{os.getpid()}-{time.time_ns()}")
    child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(600)"])
    subprocess.run([sys.executable, "-c", ORPHAN], check=True)
    deadline = time.monotonic() + 30
    while len(chip_smoke._marked_processes()) < 2 and time.monotonic() < deadline:
        time.sleep(0.05)
    marked = chip_smoke._marked_processes()
    assert child.pid in marked and len(marked) == 2, marked
    found = chip_smoke.stop_leftovers(settle=0.5, grace=5.0)
    assert sorted(f["pid"] for f in found) == sorted(marked)
    assert all("time.sleep(600)" in f["cmd"] for f in found)
    assert chip_smoke._marked_processes() == {}
    assert child.poll() is not None


# A script whose run leaves a child it never waits for and an orphan, then
# returns or raises; the supervisor must stop both and keep the run's code.
SUPERVISED = """
import subprocess, sys
sys.path.insert(0, {root!r})
import chip_smoke

def run():
    subprocess.run([sys.executable, "-c", {orphan!r}], check=True)
    subprocess.Popen([sys.executable, "-c", "import time; time.sleep(600)"])
    print("ran", flush=True)
    if {fail!r}:
        raise RuntimeError("the run failed")

sys.exit(chip_smoke.supervise(run, settle=0.5))
"""


@pytest.mark.parametrize("fail", [False, True])
def test_supervise_stops_what_the_run_left(fail, tmp_path):
    script = tmp_path / "supervised.py"
    script.write_text(SUPERVISED.format(root=ROOT, orphan=ORPHAN, fail=fail))
    res = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == (1 if fail else 0), res.stderr[-3000:]
    assert res.stdout.strip() == "ran"
    assert ("RuntimeError: the run failed" in res.stderr) == fail
    left = json.loads(res.stderr.strip().splitlines()[-1])["leftover_processes"]
    assert len(left) == 2 and all("time.sleep(600)" in f["cmd"] for f in left), left
    for f in left:
        assert not os.path.exists(f"/proc/{f['pid']}") or \
            b"time.sleep(600)" not in chip_smoke._proc_entry(str(f["pid"]), "cmdline")
