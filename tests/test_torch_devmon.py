"""The port's device monitor (``telemetry.devmon``): FLOPs counted with
``FlopCounterMode`` once per input signature, the card's peaks, memory
samples, and the MFU/roofline arithmetic of ``publish_step``."""

import numpy as np
import pytest
import torch

from moolib_tpu_torch import bench
from moolib_tpu_torch.models.impala import ImpalaNet
from moolib_tpu_torch.telemetry import devmon

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh():
    devmon.reset_for_tests()
    yield
    devmon.reset_for_tests()


@pytest.mark.parametrize("m,k,n", [(16, 64, 32), (3, 7, 5)])
def test_step_cost_of_a_linear_is_exact(m, k, n):
    lin = torch.nn.Linear(k, n, bias=False)
    x = torch.zeros(m, k)
    cost = devmon.step_cost(f"linear{m}", lin, x)
    assert cost.flops == 2 * m * n * k
    # inputs and parameters, each read once
    assert cost.bytes_accessed == 4 * (m * k + n * k)
    assert devmon.step_cost(f"linear{m}", lin, x) is cost  # cached per signature


def test_step_cost_of_the_full_width_impalanet_forward():
    """Counted on meta tensors at [T+1, B] = [21, 32]: within 2% of the
    72.9 GFLOP the analytic count of benchmarks/impala_roofline.py gives."""
    model = ImpalaNet(num_actions=6, device="meta")
    batch = {"state": torch.zeros(21, 32, 84, 84, 4, dtype=torch.uint8, device="meta"),
             "reward": torch.zeros(21, 32, device="meta"),
             "done": torch.zeros(21, 32, dtype=torch.bool, device="meta"),
             "prev_action": torch.zeros(21, 32, dtype=torch.long, device="meta")}
    cost = devmon.step_cost("impala.forward", model, batch)
    want = bench.analytic_forward_flops()
    assert abs(cost.flops - want) / want < 0.02, (cost.flops, want)
    assert abs(want - 72.9e9) / 72.9e9 < 0.001


def test_sample_memory_on_the_cpu():
    out = devmon.sample_memory()
    assert "host" in out
    row = out["host"]
    assert row["bytes_in_use"] > 0 and row["bytes_limit"] >= row["bytes_in_use"]
    assert row["bytes_peak"] >= row["bytes_in_use"]
    assert "memory host" in devmon.summary_text()


def test_h100_peaks_and_publish_step():
    pf, src = devmon.peak_flops("NVIDIA H100 80GB HBM3")
    pb, _ = devmon.peak_bandwidth("NVIDIA H100 80GB HBM3")
    assert (pf, src, pb) == (989e12, "table", 3.35e12)
    assert devmon.peak_flops("cpu") == (devmon.NOMINAL_PEAK_FLOPS, "nominal")
    cost = devmon.StepCost(989e12 * 0.01, 1e9)
    info = devmon.publish_step("t", cost, 0.02, device_kind="NVIDIA H100 80GB HBM3")
    assert np.isclose(info["mfu"], 0.5) and info["bound"] == "compute"
    roof = devmon.roofline(1e9, 1e9, "NVIDIA H100 80GB HBM3")
    assert roof["bound"] == "memory" and np.isclose(roof["min_step_s_memory"], 1e9 / 3.35e12)
    assert devmon.publish_step("t", None, 1.0) is None
