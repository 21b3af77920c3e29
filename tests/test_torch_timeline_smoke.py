"""The port's timeline smoke (``moolib_tpu_torch.scripts.timeline_smoke``)
end to end on the CPU: two cohort peers with periodic timeline windows,
each validating its last window (fractions sum to 1, finite exposed comm,
the comm/psum ratio in [0.5, 2.0]), then ``mtop --once`` over the live
cohort; the ``step_overlap`` rows carry exactly the JAX script's keys."""

import ast
import json
import os
import subprocess
import sys

import pytest

from conftest import subprocess_env

from moolib_tpu_torch._device import NoCudaError
from moolib_tpu_torch.scripts import timeline_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_row_keys() -> set:
    """The keys of the dict literal holding ``"metric": "step_overlap"`` in
    the JAX script."""
    tree = ast.parse(open(os.path.join(ROOT, "scripts", "timeline_smoke.py")).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys if isinstance(k, ast.Constant)]
            vals = [v.value for v in node.values if isinstance(v, ast.Constant)]
            if "metric" in keys and "step_overlap" in vals:
                return set(keys)
    raise AssertionError("no step_overlap row in the JAX script")


def test_timeline_smoke_passes_on_the_cpu(tmp_path):
    env = dict(subprocess_env(ROOT), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "moolib_tpu_torch.scripts.timeline_smoke",
                        "--smoke", "--device", "cpu", "--workdir", str(tmp_path)], env=env,
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-2000:]
    lines = r.stdout.splitlines()
    assert "TIMELINE SMOKE OK: " in lines[-1]
    rows = [json.loads(ln) for ln in lines if ln.startswith("{")]
    overlap = [x for x in rows if x["metric"] == "step_overlap"]
    device = [x for x in rows if x["metric"] == "step_overlap_device"]
    assert sorted(x["peer"] for x in overlap) == ["tl-peer-0", "tl-peer-1"]
    keys = _jax_row_keys()
    for row in overlap:
        assert set(row) == keys
        assert 0.5 <= row["comm_vs_psum_ratio"] <= 2.0 and row["exposed_comm_seconds"] >= 0
        fracs = sum(row[f"frac_{b}"] for b in ("compute", "comm", "host", "idle"))
        assert abs(fracs - 1.0) <= 0.02
    # On the CPU the window holds the profiler's CPU operators, no kernel.
    assert [(d["kernel_records"], d["memory"]) for d in device] == [(0, ["host"])] * 2
    mtop_out = (tmp_path / "mtop.log").read_text()
    for needed in ("tl-peer-0", "tl-peer-1", "MFU%", "HBM", "SKEW", "flight ring"):
        assert needed in mtop_out


def test_timeline_smoke_needs_the_card_by_default(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(NoCudaError):
        timeline_smoke.main(["--smoke"])
