"""CPU rehearsals of chip_smoke.py's two fleet-soak phases: ``serve_soak``
(the serving soak's engine arm through the phase's checks, an LM of
d_model 32) and ``chaos_soak`` (all four chaos phases, LM peers of
d_model 16 with flash attention, which takes its plain version on the
CPU), and the kernels phase's rows at the soaks' shapes."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


def test_soak_shapes_are_held_by_the_kernels_phase():
    for shape in (chip_smoke.SERVE_SOAK_SHAPE, chip_smoke.CHAOS_SOAK_SHAPE):
        assert shape in chip_smoke.KERNEL_SHAPES
    # The phases' widths give those shapes: a 512-token prompt of the
    # engine's LM, and a chaos peer's B 2 x T 256 with 2 heads of d 256.
    serve, chaos = chip_smoke.SERVE_SOAK_ARGS, chip_smoke.CHAOS_SOAK_ARGS

    def flag(args, name):
        return int(args[args.index(name) + 1])

    assert chip_smoke.SERVE_SOAK_SHAPE == (
        1, flag(serve, "--seq_len"), flag(serve, "--heads"),
        flag(serve, "--d_model") // flag(serve, "--heads"))
    assert chip_smoke.CHAOS_SOAK_SHAPE == (
        flag(chaos, "--batch_size"), flag(chaos, "--seq_len"), flag(chaos, "--heads"),
        flag(chaos, "--d_model") // flag(chaos, "--heads"))


@pytest.mark.parametrize("phase", ["serve_soak", "chaos_soak"])
def test_soak_phase_rehearsal(phase, capsys, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    if phase == "serve_soak":
        res = chip_smoke.phase_serve_soak(0, device="cpu", args=[
            "--engine", "--vocab", "64", "--d_model", "32", "--layers", "2", "--heads", "2",
            "--attention", "flash", "--seq_len", "16", "--max_new_tokens", "4",
            "--batch_size", "8", "--window_s", "8", "--qps", "10", "--fit_qps"])
        assert res["lost_requests"] == 0 and res["swap"]["hot_swaps"] >= 1
        assert res["survivor_prefills"] > 0 and res["replica_rate_rps"] > 0
    else:
        res = chip_smoke.phase_chaos_soak(0, device="cpu", args=[
            "--smoke", "--vocab", "16", "--d_model", "16", "--layers", "1", "--heads", "1",
            "--seq_len", "16", "--batch_size", "2", "--attention", "flash",
            # A capture every 0.25 s: at these widths a CPU runs phase 4's
            # target in ~2 s, and its mid-write kill needs a second write.
            "--checkpoint_interval", "0.25"])
        assert res["frame_faults"]["drop"] > 0 and res["resumed_learns"] > 0
        assert res["stall_per_capture_s"] < 0.1 * res["step_s"]
    # The plain attention on the CPU: no kernel launches.
    assert res["launches"] == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    assert res["memory_before"] == res["memory_after"] == {}
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert json.loads(lines[-1])["phase"] == phase
