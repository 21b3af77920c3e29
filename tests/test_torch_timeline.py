"""Fused host+device step timeline on the port (the cases of
``tests/test_timeline.py``): attribution is pure interval math over
synthetic records — fractions partition each step exactly, exposed vs
overlapped comm split on concurrent compute — and the scheduler drives
``on_dispatch`` with device capture off.  The port's own cases: torch's
trace names land in the right bucket (NCCL kernels, memcpys and memsets,
the flash kernels, cuBLAS GEMMs); the loader reads torch.profiler's Chrome
trace (device categories, or CPU operators on a CPU-only trace) and
rebases it through the window's clock marker, a marker's rebased start
within 1 ms of its host time; ``classify_name``, the interval math and
``ingest_window`` give the JAX package's results on the same synthetic
events (exactly: both run the same float arithmetic); and an explicit
window over a few steps partitions each step's wall time.
"""

import gzip
import json
import os
import time

import pytest

import numpy as np
import torch

from moolib_tpu_torch import telemetry
from moolib_tpu_torch.telemetry import devmon, profiling, timeline

torch.set_num_threads(1)

MS = 1_000_000  # ns per millisecond


@pytest.fixture(autouse=True)
def _clean_timeline():
    timeline.reset_for_tests()
    yield
    timeline.reset_for_tests()


# ------------------------------------------------------------ classification
def test_classify_name_buckets():
    assert timeline.classify_name("all-reduce-start.1") == "comm"
    assert timeline.classify_name("ncclAllReduce") == "comm"
    assert timeline.classify_name("psum.3") == "comm"
    assert timeline.classify_name("collective-permute-done") == "comm"
    assert timeline.classify_name("infeed-dequeue") == "host"
    assert timeline.classify_name("memcpyD2H") == "host"
    assert timeline.classify_name("fusion.123") == "compute"
    assert timeline.classify_name("") == "compute"
    # Collectives take precedence over host patterns in one name.
    assert timeline.classify_name("all-reduce-copy") == "comm"


# ---------------------------------------------------------- interval algebra
def test_interval_union_subtract_measure():
    u = timeline._union([(3.0, 4.0), (1.0, 2.0), (1.5, 2.5), (5.0, 5.0)])
    assert u == [(1.0, 2.5), (3.0, 4.0)]
    assert timeline._measure(u) == pytest.approx(2.5)
    assert timeline._clip(u, 2.0, 3.5) == [(2.0, 2.5), (3.0, 3.5)]
    # a \ b with b splitting one interval of a in two.
    rem = timeline._subtract([(0.0, 10.0)], [(2.0, 3.0), (5.0, 6.0)])
    assert rem == [(0.0, 2.0), (3.0, 5.0), (6.0, 10.0)]
    assert timeline._subtract([(0.0, 1.0)], [(0.0, 1.0)]) == []


# -------------------------------------------------------------- attribution
def _anchor():
    # Arbitrary but consistent: unix origin 1e9 s, perf origin 0.
    return (1_000_000_000_000_000_000, 0)


def test_ingest_window_fractions_partition_each_step():
    # Two steps of 100 ms each; window end closes the last step at 200 ms.
    steps = [("train", 0, 10 * MS), ("train", 100 * MS, 110 * MS)]
    report = timeline.ingest_window(
        steps,
        comm_spans=[("psum", 20 * MS, 40 * MS)],    # outside dispatch: exposed
        host_spans=[("fetch", 50 * MS, 60 * MS)],
        anchor=_anchor(),
        window_end_ns=200 * MS,
        publish=False,
    )
    assert report["steps"] == 2
    row = report["fns"]["train"]
    assert sum(row["fractions"].values()) == pytest.approx(1.0, abs=0.02)
    # 200 ms total: 20 ms compute (the dispatch intervals), 20 ms exposed
    # comm, 10 ms host, 150 ms idle.
    assert row["seconds"]["compute"] == pytest.approx(0.020)
    assert row["seconds"]["comm"] == pytest.approx(0.020)
    assert row["seconds"]["host"] == pytest.approx(0.010)
    assert row["seconds"]["idle"] == pytest.approx(0.150)
    assert report["exposed_comm_seconds"] == pytest.approx(0.020)
    assert report["overlapped_comm_seconds"] == pytest.approx(0.0)


def test_ingest_window_overlapped_vs_exposed_comm():
    # One 100 ms step whose dispatch (compute on CPU) covers 0-40 ms; a
    # 30 ms comm span sits half under it: 20 ms overlapped, 10 ms exposed.
    steps = [("train", 0, 40 * MS)]
    report = timeline.ingest_window(
        steps,
        comm_spans=[("allreduce", 20 * MS, 50 * MS)],
        anchor=_anchor(),
        window_end_ns=100 * MS,
        publish=False,
    )
    assert report["exposed_comm_seconds"] == pytest.approx(0.010)
    assert report["overlapped_comm_seconds"] == pytest.approx(0.020)
    row = report["fns"]["train"]
    # Overlapped comm counts inside compute's share, not comm's.
    assert row["seconds"]["compute"] == pytest.approx(0.040)
    assert row["seconds"]["comm"] == pytest.approx(0.010)
    assert sum(row["fractions"].values()) == pytest.approx(1.0, abs=0.02)


def test_ingest_window_device_slices_rebase_and_bubble():
    # Device slices on a private origin far from the unix axis get rebased
    # so the first slice lands at the window start; per-track idle share
    # becomes pipeline_bubble_fraction{stage}.
    steps = [("step", 0, 1 * MS)]
    slices = [
        {"name": "fusion.1", "ts_us": 7_000.0, "dur_us": 40_000.0,
         "track": "TPU:0", "bucket": "compute"},
        {"name": "all-reduce.1", "ts_us": 47_000.0, "dur_us": 10_000.0,
         "track": "TPU:0", "bucket": "comm"},
    ]
    report = timeline.ingest_window(
        steps,
        slices=slices,
        anchor=_anchor(),
        window_end_ns=100 * MS,
        publish=False,
    )
    row = report["fns"]["step"]
    # 40 ms device compute + 1 ms dispatch (disjoint after rebase: the
    # first slice is pinned to the window start, the dispatch is inside it).
    assert row["seconds"]["compute"] == pytest.approx(0.040, abs=0.002)
    assert report["exposed_comm_seconds"] == pytest.approx(0.010, abs=0.002)
    assert "TPU:0" in report["bubble"]
    assert report["bubble"]["TPU:0"] == pytest.approx(0.5, abs=0.02)
    assert sum(row["fractions"].values()) == pytest.approx(1.0, abs=0.02)


def test_ingest_window_overlapping_bucket_spans_union_once():
    # Streaming gradient pipeline: per-bucket wire spans overlap each other
    # AND the backward compute.  Buckets [0,10] and [5,15] union to [0,15];
    # compute covers [0,12], so 12 ms is overlapped and only [12,15] (3 ms)
    # is exposed — double-counting the [5,10] overlap region would report
    # 20 ms of comm out of 15 ms of wall clock.
    steps = [("train", 0, 12 * MS)]
    report = timeline.ingest_window(
        steps,
        comm_spans=[
            ("accum.stream_bucket", 0, 10 * MS),
            ("accum.stream_bucket", 5 * MS, 15 * MS),
        ],
        anchor=_anchor(),
        window_end_ns=20 * MS,
        psum_host_seconds=0.015,
        publish=False,
    )
    assert report["exposed_comm_seconds"] == pytest.approx(0.003, abs=1e-3)
    assert report["overlapped_comm_seconds"] == pytest.approx(0.012, abs=1e-3)
    # The psum cross-check counts the UNIONED comm measure (15 ms), so the
    # ratio stays ~1.0 against a 15 ms host-side psum account.
    assert report["comm_vs_psum_ratio"] == pytest.approx(1.0, abs=0.05)
    row = report["fns"]["train"]
    assert row["seconds"]["comm"] == pytest.approx(0.003, abs=1e-3)
    assert sum(row["fractions"].values()) == pytest.approx(1.0, abs=0.02)


def test_comm_mark_interval_records_retroactive_span():
    # No window open: mark is None and interval is a no-op.
    assert timeline.comm_mark() is None
    timeline.comm_interval("accum.stream_bucket", None)
    w = timeline._open_window(seq=1)
    assert w is not None
    timeline._state["window"] = w
    try:
        t0 = timeline.comm_mark()
        assert t0 is not None
        timeline.comm_interval("accum.stream_bucket", t0)
        timeline.comm_interval("explicit", 100, 200)
        names = [n for n, _, _ in w["comm"]]
        assert names == ["accum.stream_bucket", "explicit"]
        (_, a0, a1), (_, b0, b1) = w["comm"]
        assert a0 == t0 and a1 >= a0
        assert (b0, b1) == (100, 200)
    finally:
        timeline._state["window"] = None
        timeline._discard_window(w)


def test_ingest_window_psum_ratio_cross_check():
    steps = [("t", 0, 10 * MS)]
    report = timeline.ingest_window(
        steps,
        comm_spans=[("psum", 20 * MS, 40 * MS)],
        anchor=_anchor(),
        window_end_ns=50 * MS,
        psum_host_seconds=0.020,
        publish=False,
    )
    assert report["comm_vs_psum_ratio"] == pytest.approx(1.0, abs=0.05)
    # No psum growth -> no ratio (never a divide-by-zero inf).
    report = timeline.ingest_window(
        steps, anchor=_anchor(), psum_host_seconds=0.0, publish=False
    )
    assert report["comm_vs_psum_ratio"] is None


def test_ingest_window_empty_and_publish_path():
    assert timeline.ingest_window([], publish=False)["steps"] == 0
    # publish=True lands the gauges + counters in the shared registry.
    timeline.ingest_window(
        [("pub", 0, 10 * MS)],
        comm_spans=[("psum", 20 * MS, 30 * MS)],
        anchor=_anchor(),
        window_end_ns=40 * MS,
    )
    snap = telemetry.get_registry().snapshot()
    fr = {
        (s["labels"]["bucket"], s["labels"]["fn"]): s["value"]
        for s in snap["step_time_fraction"]["series"]
    }
    assert sum(v for (b, fn), v in fr.items() if fn == "pub") == pytest.approx(
        1.0, abs=0.02
    )
    assert snap["timeline_windows_total"]["series"][0]["value"] >= 1


# ------------------------------------------------------------- trace loading
def _write_trace(tmp_path, events, gz=False, anchor=None):
    d = str(tmp_path)
    os.makedirs(d, exist_ok=True)
    payload = json.dumps({"traceEvents": events}).encode()
    if gz:
        path = os.path.join(d, "host_1.pt.trace.json.gz")
        with gzip.open(path, "wb") as f:
            f.write(payload)
    else:
        with open(os.path.join(d, "host_1.pt.trace.json"), "wb") as f:
            f.write(payload)
    if anchor is not None:
        with open(os.path.join(d, profiling.ANCHOR_FILE), "w") as f:
            json.dump(anchor, f)
    return d


def test_classify_name_torch_names():
    assert timeline.classify_name("ncclDevKernel_AllReduce_Sum_f32_RING_LL") == "comm"
    assert timeline.classify_name("ncclKernel_AllGather_RING_LL_Sum_int8_t") == "comm"
    assert timeline.classify_name("Memcpy DtoH (Device -> Pinned)") == "host"
    assert timeline.classify_name("Memcpy HtoD (Pageable -> Device)") == "host"
    assert timeline.classify_name("Memset (Device)") == "compute"
    for k in ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
              "flash_bwd_dkv_wgmma_kernel"):
        assert timeline.classify_name(f"void {k}<__nv_bfloat16, 128, true>(Params)") == "compute"
    assert timeline.classify_name(
        "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1"
        "_execute_segment_k_off_kernel__5x_cublas") == "compute"
    assert timeline.classify_name("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_TNT") == "compute"


def _torch_trace_events():
    return [
        {"ph": "M", "pid": 0, "name": "process_name", "args": {"name": "GPU 0"}},
        {"ph": "M", "pid": 0, "tid": 7, "name": "thread_name", "args": {"name": "stream 7"}},
        {"ph": "M", "pid": 11, "tid": 11, "name": "thread_name", "args": {"name": "python"}},
        {"ph": "X", "cat": "user_annotation", "pid": 11, "tid": 11,
         "name": profiling.CLOCK_MARKER, "ts": 1000.0, "dur": 2.0},
        {"ph": "X", "cat": "cpu_op", "pid": 11, "tid": 11, "name": "aten::mm",
         "ts": 1010.0, "dur": 30.0},
        {"ph": "X", "cat": "cuda_runtime", "pid": 11, "tid": 11, "name": "cudaLaunchKernel",
         "ts": 1012.0, "dur": 3.0},
        {"ph": "X", "cat": "python_function", "pid": 11, "tid": 11,
         "name": "collectives.py(92): redistribute", "ts": 1000.0, "dur": 80.0},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7,
         "name": "void flash_fwd_wgmma_kernel<__nv_bfloat16, 128, true>(Params)",
         "ts": 1020.0, "dur": 50.0},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7,
         "name": "ncclDevKernel_AllReduce_Sum_f32_RING_LL", "ts": 1080.0, "dur": 20.0},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7,
         "name": "void at::native::elementwise_kernel<direct_copy_kernel_cuda>()",
         "ts": 1100.0, "dur": 5.0},
        {"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 7,
         "name": "Memcpy DtoH (Device -> Pinned)", "ts": 1110.0, "dur": 8.0},
        {"ph": "X", "cat": "gpu_memset", "pid": 0, "tid": 7, "name": "Memset (Device)",
         "ts": 1120.0, "dur": 0.0},
        {"ph": "B", "pid": 0, "tid": 7, "name": "not-complete", "ts": 1.0},
    ]


def test_load_profiler_trace_reads_device_events_and_skips_host_frames(tmp_path):
    slices = timeline.load_profiler_trace(_write_trace(tmp_path, _torch_trace_events()))
    assert [(s["name"][:24], s["bucket"]) for s in slices] == [
        ("void flash_fwd_wgmma_ker", "compute"),
        ("ncclDevKernel_AllReduce_", "comm"),
        # A copy KERNEL runs on the SMs: compute, whatever its name says.
        ("void at::native::element", "compute"),
        ("Memcpy DtoH (Device -> P", "host"),
    ]
    assert slices[0]["track"] == "stream 7"
    assert slices[0]["ts_us"] == 1020.0  # no anchor file: the trace's own clock


def test_load_profiler_trace_cpu_only_and_missing(tmp_path):
    events = [e for e in _torch_trace_events() if e.get("cat") not in
              ("kernel", "gpu_memcpy", "gpu_memset")]
    slices = timeline.load_profiler_trace(_write_trace(tmp_path, events, gz=True))
    assert [(s["name"], s["bucket"], s["track"]) for s in slices] == [
        ("aten::mm", "compute", "python")]
    assert timeline.load_profiler_trace(None) == []
    assert timeline.load_profiler_trace(str(tmp_path / "nowhere")) == []


def test_load_profiler_trace_rebases_through_the_clock_marker(tmp_path):
    # The marker sat at trace time 1000 us and host perf time 5_000_000 ns;
    # the window's anchors map perf 4_000_000 ns to unix 7e18 ns.
    anchor = {"unix_time_ns": 7 * 10**18, "perf_counter_ns": 4_000_000,
              "marker": profiling.CLOCK_MARKER, "marker_perf_ns": 5_000_000}
    slices = timeline.load_profiler_trace(
        _write_trace(tmp_path, _torch_trace_events(), anchor=anchor))
    marker_unix_us = (7 * 10**18 + 1_000_000) / 1e3
    assert slices[0]["ts_us"] == pytest.approx(marker_unix_us + 20.0)


def test_real_window_marker_rebases_within_a_millisecond(tmp_path):
    """A real torch.profiler window on the CPU: record_function probes at
    known perf_counter_ns land, after the rebase through the window's
    marker, within 1 ms of their host time on the unix axis."""
    from torch.profiler import record_function

    res = profiling.start_device_trace(str(tmp_path / "w"))
    assert res["ok"]
    probes = []
    x = torch.randn(64, 64)
    for i in range(5):
        x @ x
        # Of a few tries, the probe with the tightest host-clock bracket
        # (a preempted thread would misplace a probe, not the rebase).
        tries = []
        for j in range(5):
            t0 = time.perf_counter_ns()
            with record_function(f"probe{i}.{j}"):
                t1 = time.perf_counter_ns()
            tries.append((t1 - t0, f"probe{i}.{j}", (t0 + t1) // 2))
        probes.append(min(tries)[1:])
        time.sleep(0.005)
    out = profiling.stop_device_trace()
    assert out["ok"]
    with open(out["trace"]) as f:
        events = {e["name"]: e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"}
    with open(os.path.join(res["logdir"], profiling.ANCHOR_FILE)) as f:
        anchor = json.load(f)
    off_us = ((anchor["unix_time_ns"] + anchor["marker_perf_ns"] - anchor["perf_counter_ns"])
              / 1e3 - events[anchor["marker"]]["ts"])
    for name, t_ns in probes:
        host_unix_us = (res["unix_time_ns"] + t_ns - res["perf_counter_ns"]) / 1e3
        assert abs(events[name]["ts"] + off_us - host_unix_us) < 1000.0, name


def _synthetic(seed):
    """Random steps, comm/host spans and device slices on one window."""
    rng = np.random.default_rng(seed)
    steps, comm, host, slices = [], [], [], []
    t = 0
    for i in range(6):
        dur = int(rng.integers(2, 12)) * MS
        steps.append(("train" if i % 3 else "apply", t, t + dur))
        if rng.random() < 0.7:
            a = t + int(rng.integers(0, 20)) * MS
            comm.append(("allreduce", a, a + int(rng.integers(1, 15)) * MS))
        if rng.random() < 0.5:
            a = t + int(rng.integers(0, 20)) * MS
            host.append(("fetch", a, a + int(rng.integers(1, 6)) * MS))
        t += int(rng.integers(15, 30)) * MS
    names = ["fusion.3", "all-reduce.1", "copy-start", "ncclDevKernel_AllReduce", "gemm"]
    for _ in range(12):
        name = names[int(rng.integers(0, len(names)))]
        slices.append({"name": name, "ts_us": float(rng.integers(0, t // 1000)),
                       "dur_us": float(rng.integers(100, 9000)),
                       "track": f"dev{int(rng.integers(0, 2))}",
                       "bucket": timeline.classify_name(name)})
    return steps, comm, host, slices, t


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ingest_window_matches_the_jax_package(seed):
    from moolib_tpu.telemetry import timeline as jax_timeline

    steps, comm, host, slices, end = _synthetic(seed)
    for name in ("all-reduce-start.1", "Memcpy DtoH (Device -> Pinned)", "Memset (Device)",
                 "ncclDevKernel_AllReduce_Sum_f32_RING_LL", "infeed", "fusion.9", ""):
        assert timeline.classify_name(name) == jax_timeline.classify_name(name)
    iv = [(float(a), float(b)) for _, a, b in comm + host]
    assert timeline._union(iv) == jax_timeline._union(iv)
    u = timeline._union(iv)
    assert timeline._subtract(u, u[1::2]) == jax_timeline._subtract(u, u[1::2])
    assert timeline._clip(u, 1e7, 9e7) == jax_timeline._clip(u, 1e7, 9e7)
    kw = dict(comm_spans=comm, host_spans=host, slices=slices, anchor=_anchor(),
              window_end_ns=end, psum_host_seconds=0.05, publish=False)
    assert timeline.ingest_window(steps, **kw) == jax_timeline.ingest_window(steps, **kw)


def test_explicit_window_partitions_each_step(tmp_path, monkeypatch):
    """begin_window / end_window over 4 dispatches of a CPU step: the
    window's capture is a real torch.profiler trace, every step's buckets
    sum to its wall time, and the dispatch hook is gone afterwards."""
    monkeypatch.setenv("MOOLIB_PROFILE_DIR", str(tmp_path))
    x = torch.randn(96, 96)
    assert timeline.begin_window()
    assert not timeline.begin_window()  # one window at a time
    assert not profiling.start_device_trace()["ok"]  # the slot is shared
    for _ in range(4):
        with devmon.dispatch_span("cpu.step"):
            for _ in range(4):
                x = torch.tanh(x @ x)
        with timeline.host_span("fetch"):
            float(x.sum())
    rep = timeline.end_window()
    assert devmon._dispatch_hook is None and not profiling.profile_status()["active"]
    assert rep["steps"] == 4 and rep["slices"] > 0
    row = rep["fns"]["cpu.step"]
    assert row["steps"] == 4
    assert sum(row["seconds"].values()) == pytest.approx(row["total_seconds"], rel=1e-9)
    assert sum(row["fractions"].values()) == pytest.approx(1.0, abs=1e-9)
    assert row["seconds"]["compute"] > 0
    assert timeline.status()["windows"] == 1 and timeline.end_window() is None


def test_instrument_feeds_the_dispatch_hook():
    seen = []
    devmon.set_dispatch_hook(lambda name, t0, t1: seen.append((name, t1 >= t0)))
    try:
        f = devmon.instrument(lambda a: a + 1, "plus")
        assert devmon.instrument(f, "again") is f
        assert f(1) == 2
        with devmon.dispatch_span("span"):
            pass
    finally:
        devmon.set_dispatch_hook(None)
    assert seen == [("plus", True), ("span", True)]
    with devmon.dispatch_span("untimed"):
        pass
    assert len(seen) == 2


# ------------------------------------------------------- periodic scheduling
def _wait(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


def test_scheduler_opens_ingests_and_reports(monkeypatch):
    # Host-only windows (device=False): no profiler in the loop, so this
    # exercises exactly the scheduler — open on the Nth dispatch, record
    # steps + phase spans, close past the deadline, ingest off-thread.
    timeline.configure(interval=2, window_s=0.05, device=False)
    t = time.perf_counter_ns()
    step = 20 * MS
    n = 0
    deadline = time.monotonic() + 5.0
    while timeline.status()["windows"] < 1:
        assert time.monotonic() < deadline, "window never ingested"
        timeline.on_dispatch("sched", t + n * step, t + n * step + 2 * MS)
        with timeline.comm_span("fake-psum"):
            pass
        n += 1
        time.sleep(0.01)
    st = timeline.status()
    assert st["interval"] == 2 and st["windows"] >= 1
    rep = st["last_report"]
    assert rep["steps"] >= 1
    assert "sched" in rep["fns"]
    fr = rep["fns"]["sched"]["fractions"]
    assert sum(fr.values()) == pytest.approx(1.0, abs=0.02)


def test_scheduler_never_overlaps_user_profile(monkeypatch):
    # A user-held profiler slot wins: the periodic window is skipped (None),
    # not queued behind the user's capture.
    
    timeline.configure(interval=1, window_s=0.05, device=True)
    monkeypatch.setattr(
        profiling, "profile_status", lambda: {"active": True,
                                              "logdir": "/tmp/user"}
    )
    assert timeline._open_window(seq=1) is None
    # start_device_trace losing the slot race reports "already active".
    monkeypatch.setattr(
        profiling, "profile_status", lambda: {"active": False}
    )
    monkeypatch.setattr(
        profiling,
        "start_device_trace",
        lambda logdir=None: {"ok": False, "error": "profile already active"},
    )
    assert timeline._open_window(seq=2) is None
    # No profiler at all degrades to a host-only window, never an exception.
    monkeypatch.setattr(
        profiling,
        "start_device_trace",
        lambda logdir=None: {"ok": False, "error": "torch unavailable"},
    )
    w = timeline._open_window(seq=3)
    assert w is not None and w["logdir"] is None
    timeline._discard_window(w)


def test_finish_window_skips_empty_windows():
    # A window that saw no dispatches must release the slot without
    # clobbering the last real report.
    timeline._state["last_report"] = {"steps": 3}
    w = {"id": 99, "logdir": None, "anchor": _anchor(), "steps": [],
         "comm": [], "host": [], "psum0": 0.0, "timer": None}
    timeline._finish_window(w)
    assert timeline.status()["windows"] == 0
    assert timeline.status()["last_report"] == {"steps": 3}


def test_install_from_env_and_reset(monkeypatch):
    monkeypatch.setenv("MOOLIB_TIMELINE_INTERVAL", "50")
    monkeypatch.setenv("MOOLIB_TIMELINE_WINDOW_S", "0.5")
    monkeypatch.setenv("MOOLIB_TIMELINE_DEVICE", "0")
    cfg = timeline.install_from_env()
    assert cfg == {"interval": 50, "window_s": 0.5, "device": False}
    st = timeline.status()
    assert st["interval"] == 50 and st["window_s"] == 0.5
    assert devmon._dispatch_hook is timeline.on_dispatch
    timeline.reset_for_tests()
    assert timeline.status()["interval"] == 0
    assert devmon._dispatch_hook is None
    # Unset/garbage env means off — and leaves any existing hook alone.
    monkeypatch.setenv("MOOLIB_TIMELINE_INTERVAL", "banana")
    assert timeline.install_from_env()["interval"] == 0
