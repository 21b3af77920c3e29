"""The port's device monitor (``telemetry.devmon``): FLOPs counted with
``FlopCounterMode`` once per input signature, the card's peaks, memory
samples, the MFU/roofline arithmetic of ``publish_step``, the devmon
section of the diagnostics dump, and the cohort sub-plane: the
``step_skew`` and peer-sample cases of ``tests/test_devmon.py`` against
the port's ``CohortAggregator``, each held equal to the JAX aggregator's
result on the same samples.  The JAX file's recompile-detector and
``instrument_jit`` cases are JAX-only (eager torch compiles nothing per
signature), and its bench-gate and fold cases wait for the port's
benchmark."""

import numpy as np
import pytest
import torch

from moolib_tpu import telemetry as jax_telemetry
from moolib_tpu_torch import bench, telemetry
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


# -------------------------------------------------------------- cohort skew
# The step_skew and peer-sample cases of tests/test_devmon.py against the
# port's CohortAggregator, each also run through the JAX aggregator on the
# same samples.
class _FakeRpc:
    def get_name(self):
        return "observer"


def _hist_fam(total, count):
    return {"kind": "histogram", "help": "", "buckets": [0.1, 1.0],
            "series": [{"labels": {}, "value": {"buckets": [1, 1, 0], "sum": total,
                                                "count": count}}]}


def _peer_row(t, dispatch_sum, count, psum_sum=0.0, psum_count=0.0, steps=None):
    met = {"train_step_dispatch_seconds": _hist_fam(dispatch_sum, count),
           "accum_psum_seconds": _hist_fam(psum_sum, psum_count)}
    if steps is not None:
        met["train_steps_total"] = {"kind": "counter", "help": "",
                                    "series": [{"labels": {}, "value": steps}]}
    return {"time": t, "pid": 1, "metrics": met}


def _aggs():
    """A port and a JAX aggregator over the same fake roster."""
    return (telemetry.CohortAggregator(_FakeRpc(), "broker"),
            jax_telemetry.CohortAggregator(_FakeRpc(), "broker"))


def _events(name):
    return [(n, args) for _, n, args in telemetry.get_flight_recorder().events() if n == name]


def _skew_both(aggs, fused, **kw):
    """step_skew of both aggregators on the same fused scrape; the port's
    must equal the JAX one's."""
    outs = []
    for agg in aggs:
        agg._fused = fused
        outs.append(agg.step_skew(**kw))
    assert outs[0] == outs[1]
    return outs[0]


def test_step_skew_flags_delayed_peer():
    telemetry.get_flight_recorder().clear()
    aggs = _aggs()
    fused = {"time": 1.0, "errors": {}, "peers": {
        "fast-1": _peer_row(1.0, dispatch_sum=10.0, count=100),
        "fast-2": _peer_row(1.0, dispatch_sum=11.0, count=100),
        "slow": _peer_row(1.0, dispatch_sum=40.0, count=100, psum_sum=10.0, psum_count=100),
    }}
    out = _skew_both(aggs, fused, threshold=1.5, sustain=3)
    assert out["straggler"] == "slow"
    assert out["ratio"] > 1.5
    assert out["peers"]["slow"]["psum_seconds"] == pytest.approx(0.1)
    assert not out["sustained"]
    assert not _events("devmon.straggler")
    _skew_both(aggs, fused, threshold=1.5, sustain=3)
    out = _skew_both(aggs, fused, threshold=1.5, sustain=3)
    assert out["sustained"]
    evs = _events("devmon.straggler")
    assert len(evs) == 1 and evs[0][1]["peer"] == "slow"
    _skew_both(aggs, fused, threshold=1.5, sustain=3)
    assert len(_events("devmon.straggler")) == 1
    vals = telemetry.get_registry().snapshot()["cohort_step_skew_ratio"]
    assert vals["series"][0]["value"] == pytest.approx(out["ratio"])


def test_step_skew_single_peer_is_neutral():
    out = _skew_both(_aggs(), {"time": 1.0, "errors": {}, "peers": {
        "only": _peer_row(1.0, dispatch_sum=10.0, count=10)}})
    assert out == {"ratio": 1.0, "peers": {
        "only": {"step_seconds": 1.0, "dispatch_seconds": 1.0, "psum_seconds": 0.0}},
        "straggler": None, "sustained": False}


def test_step_skew_uses_window_deltas():
    aggs = _aggs()
    _skew_both(aggs, {"time": 1.0, "errors": {}, "peers": {
        "a": _peer_row(1.0, dispatch_sum=100.0, count=100),
        "b": _peer_row(1.0, dispatch_sum=10.0, count=100)}})
    out = _skew_both(aggs, {"time": 2.0, "errors": {}, "peers": {
        "a": _peer_row(2.0, dispatch_sum=101.0, count=110),
        "b": _peer_row(2.0, dispatch_sum=11.0, count=110)}}, threshold=1.5)
    assert out["peers"]["a"]["step_seconds"] == pytest.approx(0.1)
    assert out["straggler"] is None


@pytest.mark.parametrize("seed", range(3))
def test_step_skew_equals_the_jax_package_on_random_samples(seed):
    """Seeded cohorts of 2-6 peers over five scrapes, with restarts
    (counters that drop) and departures: both aggregators return the same
    per-peer figures, ratio, straggler and sustain streak every time."""
    rng = np.random.default_rng(seed)
    aggs = _aggs()
    names = [f"p{i}" for i in range(int(rng.integers(2, 7)))]
    totals = {n: [0.0, 0.0, 0.0, 0.0] for n in names}
    for t in range(5):
        peers = {}
        for n in names:
            if rng.random() < 0.15:
                continue  # absent from this scrape
            tot = totals[n]
            if rng.random() < 0.1:
                tot[:] = [0.0, 0.0, 0.0, 0.0]  # restarted
            steps = float(rng.integers(1, 20))
            tot[0] += steps * float(rng.uniform(0.05, 0.5))
            tot[1] += steps
            if rng.random() < 0.7:
                tot[2] += steps * float(rng.uniform(0.0, 0.2))
                tot[3] += steps
            peers[n] = _peer_row(float(t), tot[0], tot[1], tot[2], tot[3])
        _skew_both(aggs, {"time": float(t), "errors": {}, "peers": peers},
                   threshold=1.3, sustain=2)


def test_peer_samples_parity_and_counter_reset():
    from moolib_tpu import autoscaler as jax_autoscaler
    from moolib_tpu_torch import autoscaler

    agg, jagg = _aggs()
    row = _peer_row(100.0, dispatch_sum=1.0, count=10, steps=500.0)
    row["metrics"]["serve_qps"] = {"kind": "gauge", "help": "",
                                   "series": [{"labels": {}, "value": 7.5}]}
    fields = ("steps", "serve_qps", "queue_depth", "vbatch_fill", "serve_depth", "serve_wait",
              "slot_occupancy", "step_rate")

    def both(fused):
        agg._fused = jagg._fused = fused
        (s,), (js,) = agg.peer_samples(), jagg.peer_samples()
        assert {f: getattr(s, f) for f in fields} == {f: getattr(js, f) for f in fields}
        return s

    s = both({"time": 100.0, "errors": {}, "peers": {"p1": row}})
    ref = autoscaler.sample_from_snapshot("p1", row)
    jref = jax_autoscaler.sample_from_snapshot("p1", row)
    for f in fields[:-1]:
        assert getattr(s, f) == getattr(ref, f) == getattr(jref, f)
    assert s.step_rate is None
    s2 = both({"time": 110.0, "errors": {}, "peers": {
        "p1": _peer_row(110.0, dispatch_sum=2.0, count=20, steps=600.0)}})
    assert s2.step_rate == pytest.approx(10.0)
    s3 = both({"time": 120.0, "errors": {}, "peers": {
        "p1": _peer_row(120.0, dispatch_sum=0.1, count=1, steps=50.0)}})
    assert s3.step_rate is None
    s4 = both({"time": 130.0, "errors": {}, "peers": {
        "p1": _peer_row(130.0, dispatch_sum=0.2, count=2, steps=150.0)}})
    assert s4.step_rate == pytest.approx(10.0)


def test_peer_samples_prunes_departed_peers():
    for agg in _aggs():
        agg._fused = {"time": 1.0, "errors": {}, "peers": {
            "p1": _peer_row(1.0, 1.0, 10, steps=100.0),
            "p2": _peer_row(1.0, 1.0, 10, steps=100.0)}}
        agg.peer_samples()
        assert set(agg._last_steps) == {"p1", "p2"}
        agg._fused = {"time": 2.0, "errors": {}, "peers": {
            "p1": _peer_row(2.0, 2.0, 20, steps=200.0)}}
        agg.peer_samples()
        assert set(agg._last_steps) == {"p1"}


def test_summary_text_in_dump_diagnostics():
    """The devmon section rides the diagnostics dump (the JAX package's
    ``dump_diagnostics`` appends it after the lock-graph tail)."""
    import io

    devmon.step_cost("t.dump", torch.nn.Linear(3, 2, bias=False), torch.zeros(1, 3))
    devmon.sample_memory()
    buf = io.StringIO()
    telemetry.dump_diagnostics(file=buf, stacks=False)
    out = buf.getvalue()
    assert "devmon (device performance plane)" in out
    assert "t.dump" in out and "memory host" in out
    assert out.index("devmon (device performance plane)") < out.index("end telemetry dump")
