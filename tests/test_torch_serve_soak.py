"""The port's serving-plane soak end to end on the CPU: two
``examples.lm_serve`` replica processes behind a broker, one SIGKILLed
mid-stream and a hot-swap published under load, through the
batch-synchronous replica and through the continuous-batching engine, under
the JAX script's gates.  The load-swing arm (an autoscaled engine fleet,
~70 s of windows) is marked slow."""

import json
import os
import subprocess
import sys

import pytest

from conftest import subprocess_env

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _soak(tmp_path, *args, timeout: float) -> dict:
    out = tmp_path / "verdict.json"
    env = dict(subprocess_env(ROOT), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "moolib_tpu_torch.scripts.serve_soak", "--smoke",
                        "--device", "cpu", "--workdir", str(tmp_path / "work"),
                        "--out", str(out), *args], env=env, cwd=ROOT, capture_output=True,
                       text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-2000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("arm", ["main", "engine"])
def test_serve_soak_smoke_passes_every_gate(tmp_path, arm):
    verdict = _soak(tmp_path, *(["--engine"] if arm == "engine" else []), timeout=240)
    assert verdict["pass"] and verdict["engine"] == (arm == "engine")
    assert all(verdict["gates"].values()), verdict["gates"]
    assert verdict["lost_requests"] == 0 and verdict["swap"]["hot_swaps"] >= 1
    assert verdict["swap"]["rejects_during_swap"] == 0
    # The survivor left through SIGINT and printed its exit line; on the CPU
    # no kernel launches (the plain versions run).
    launches = verdict["survivor_kernel_launches"]
    assert launches is not None
    assert launches["flash_fwd"] == launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] == 0
    if arm == "engine":
        # Every request the survivor answered was one prefill: at least its
        # share of the offered load.
        assert launches["prefills"] >= verdict["requests"] // 4, launches
    assert sorted(os.listdir(tmp_path / "work")) == ["rep0.log", "rep1.log"]


@pytest.mark.slow
def test_serve_soak_swing_grows_and_shrinks(tmp_path):
    verdict = _soak(tmp_path, "--swing", timeout=420)
    assert verdict["pass"] and all(verdict["gates"].values()), verdict["gates"]
    assert verdict["lost_requests"] == 0
    assert verdict["phase_cohorts"]["surge"]["peak"] == 2
