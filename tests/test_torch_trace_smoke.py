"""The port's distributed-tracing smoke (``moolib_tpu_torch.scripts.
trace_smoke``) end to end on the CPU: three cohort peer processes and a
replica process, both merges through the port's ``trace_merge`` CLI with
cross-process edges and the JAX script's span names, then the merged files
read again here; plus the card check of ``--device``."""

import json
import os
import subprocess
import sys

import pytest

from conftest import subprocess_env

from moolib_tpu_torch._device import NoCudaError
from moolib_tpu_torch.scripts import trace_merge, trace_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_trace_smoke_passes_on_the_cpu(tmp_path):
    env = dict(subprocess_env(ROOT), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "moolib_tpu_torch.scripts.trace_smoke", "--smoke",
                        "--device", "cpu", "--workdir", str(tmp_path)], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-2000:]
    lines = r.stdout.splitlines()
    assert lines[-1].endswith("TRACE SMOKE OK")
    assert any("phase 1 OK:" in ln for ln in lines) and any("phase 2 OK:" in ln for ln in lines)
    stats = [json.loads(ln.split("trace_merge ", 1)[1]) for ln in lines if "] trace_merge {" in ln]
    assert len(stats) == 2 and all(s["cross_process_edges"] >= 1 for s in stats)
    # The merged files hold what the gates read: the span names, and every
    # cross-process edge a parent in one process and a child in another.
    want = {"allreduce": {"accum.reduce_gradients"},
            "serve": {"serve.request", "serve.batch generate"}}
    for phase, names in want.items():
        with open(tmp_path / phase / "merged.json") as f:
            events = json.load(f)["traceEvents"]
        assert names <= {e.get("name") for e in events}
        edges = trace_merge.cross_edges(events)
        assert edges and all(p["pid"] != c["pid"] for p, c in edges)
        assert any(c["name"].startswith("rpc.recv") for _p, c in edges)


def test_trace_smoke_needs_the_card_by_default(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(NoCudaError):
        trace_smoke.main(["--smoke"])
