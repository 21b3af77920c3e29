"""Profiling on the port (the cases of ``tests/test_profiling.py``): the
loop ``StepTimer``, ``utils.profiling.trace``/``annotate``, and the
on-demand trace windows of ``telemetry.profiling`` — the
``__telemetry_profile`` RPC surface, the SIGUSR2 toggle, the max-window
guard.  The window-logic cases swap the profiler for a recorder (one
capture slot exists per process); the port's own cases drive the real
``torch.profiler`` on the CPU: a window started and stopped from
different threads, recording the calling thread's operators and the
window's clock marker, over a loopback Rpc too."""

import json
import os
import signal
import threading
import time

import pytest
import torch

from moolib_tpu_torch import telemetry
from moolib_tpu_torch.telemetry import profiling as devprof
from moolib_tpu_torch.utils.profiling import StepTimer, annotate, trace

torch.set_num_threads(1)


def test_step_timer_sections_and_report():
    t = StepTimer(alpha=0.5)
    for _ in range(3):
        with t.section("act"):
            time.sleep(0.002)
        with t.section("learn"):
            time.sleep(0.005)
    s = t.summary()
    assert set(s) == {"act", "learn"}
    assert s["learn"] > s["act"] > 0
    rep = t.report()
    assert "learn=" in rep and "%" in rep


def test_trace_and_annotate(tmp_path):
    with trace(str(tmp_path)):
        with annotate("matmul_region"):
            x = torch.ones((64, 64))
            x @ x
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "matmul_region" in names and "aten::mm" in names


def test_step_timer_publishes_to_registry():
    reg = telemetry.Registry()
    tracer = telemetry.Tracer()
    t = StepTimer(alpha=0.5, registry=reg, tracer=tracer)
    with t.section("act"):
        time.sleep(0.001)
    hist = reg.histogram("loop_section_seconds", labelnames=("section",))
    s = hist.labels(section="act").get()
    assert s["count"] == 1 and s["sum"] >= 0.001
    assert [sp.name for sp in tracer.spans()] == ["act"]


def test_step_timer_publish_opt_out():
    before = len(telemetry.get_tracer().spans())
    t = StepTimer(publish=False)
    with t.section("quiet"):
        pass
    assert t.summary()["quiet"] >= 0
    assert len(telemetry.get_tracer().spans()) == before


# ---------------------------------------------- on-demand trace windows


@pytest.fixture
def fake_profiler(monkeypatch):
    calls = {"start": 0, "stop": [], "threads": set()}

    def _start():
        calls["start"] += 1
        calls["threads"].add(threading.current_thread().name)
        return object(), devprof.CLOCK_MARKER + ".0", time.perf_counter_ns()

    def _stop(prof, logdir, anchors):
        calls["stop"].append(logdir)
        calls["threads"].add(threading.current_thread().name)
        return os.path.join(logdir, "fake.pt.trace.json")

    monkeypatch.setattr(devprof, "_start_profiler", _start)
    monkeypatch.setattr(devprof, "_stop_profiler", _stop)
    if devprof.profile_status()["active"]:
        devprof.stop_device_trace()
    yield calls
    if devprof.profile_status()["active"]:
        devprof.stop_device_trace()


def test_profile_window_lifecycle_and_anchors(fake_profiler, tmp_path):
    logdir = str(tmp_path / "win")
    res = devprof.start_device_trace(logdir)
    assert res["ok"] and res["logdir"] == logdir
    assert res["unix_time_ns"] > 0 and res["perf_counter_ns"] > 0
    assert fake_profiler["start"] == 1
    assert devprof.profile_status() == {"active": True, "logdir": logdir}
    dup = devprof.start_device_trace()
    assert not dup["ok"] and "already active" in dup["error"]
    assert fake_profiler["start"] == 1
    out = devprof.stop_device_trace()
    assert out["ok"] and out["logdir"] == logdir and out["duration_s"] >= 0
    assert fake_profiler["stop"] == [logdir]
    assert devprof.profile_status() == {"active": False}
    spans = [s for s in telemetry.get_tracer().spans() if s.name == "device_profile"]
    assert spans and spans[-1].args["logdir"] == logdir
    again = devprof.stop_device_trace()
    assert not again["ok"] and "no profile active" in again["error"]
    # Start and stop both ran on the one profiler-owner thread.
    assert fake_profiler["threads"] == {"torch-profiler-owner"}


def test_profile_handle_command_rpc_surface(fake_profiler, tmp_path):
    assert devprof.handle_command("status") == {"active": False}
    res = devprof.handle_command("start", logdir=str(tmp_path / "rpc"))
    assert res["ok"]
    assert devprof.handle_command("status")["active"]
    assert devprof.handle_command("stop")["ok"]
    bad = devprof.handle_command("rewind")
    assert not bad["ok"] and "unknown action" in bad["error"]
    res = devprof.handle_command("window", seconds=0.1)
    assert res["ok"] and res["window_s"] == pytest.approx(0.1)
    deadline = time.monotonic() + 5.0
    while devprof.profile_status()["active"]:
        assert time.monotonic() < deadline, "window never auto-closed"
        time.sleep(0.01)
    assert len(fake_profiler["stop"]) == 2


def test_profile_no_torch_degrades_to_error(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "torch.profiler", None)
    res = devprof.start_device_trace()
    assert res == {"ok": False, "error": "torch unavailable"}
    assert not devprof.profile_status()["active"]


def test_profile_start_failure_is_reported_not_raised(monkeypatch, tmp_path):
    def _boom():
        raise RuntimeError("kineto exploded")

    monkeypatch.setattr(devprof, "_start_profiler", _boom)
    res = devprof.start_device_trace(str(tmp_path / "x"))
    assert not res["ok"] and "kineto exploded" in res["error"]
    assert not devprof.profile_status()["active"]


def test_profile_sigusr2_toggle(fake_profiler, tmp_path):
    old = signal.getsignal(signal.SIGUSR2)
    try:
        assert devprof.install_signal_toggle(logdir=str(tmp_path / "sig"))
        os.kill(os.getpid(), signal.SIGUSR2)
        deadline = time.monotonic() + 5.0
        while not devprof.profile_status()["active"]:
            assert time.monotonic() < deadline, "toggle-on never landed"
            time.sleep(0.01)
        os.kill(os.getpid(), signal.SIGUSR2)
        while devprof.profile_status()["active"]:
            assert time.monotonic() < deadline, "toggle-off never landed"
            time.sleep(0.01)
        assert fake_profiler["start"] and len(fake_profiler["stop"]) == 1
    finally:
        signal.signal(signal.SIGUSR2, old)


def test_profile_abandoned_window_force_stopped(fake_profiler, monkeypatch, tmp_path):
    monkeypatch.setenv("MOOLIB_PROFILE_MAX_WINDOW_S", "0.15")
    telemetry.get_flight_recorder().clear()
    res = devprof.start_device_trace(str(tmp_path / "dead"))
    assert res["ok"]
    deadline = time.monotonic() + 10.0
    while devprof.profile_status()["active"]:
        assert time.monotonic() < deadline, "guard never fired"
        time.sleep(0.02)
    assert len(fake_profiler["stop"]) == 1
    names = [n for _t, n, _a in telemetry.get_flight_recorder().events()]
    assert "profile.abandoned" in names


def test_profile_guard_disabled_and_bad_env(fake_profiler, monkeypatch):
    monkeypatch.setenv("MOOLIB_PROFILE_MAX_WINDOW_S", "0")
    res = devprof.start_device_trace()
    assert res["ok"]
    with devprof._lock:
        assert devprof._active["guard"] is None
    devprof.stop_device_trace()
    monkeypatch.setenv("MOOLIB_PROFILE_MAX_WINDOW_S", "not-a-number")
    assert devprof._max_window_s() == devprof.DEFAULT_MAX_WINDOW_S


# ------------------------------------------------ the real torch.profiler


def _trace_events(res):
    with open(res["trace"]) as f:
        return json.load(f)["traceEvents"]


def test_real_window_across_threads_writes_trace_and_anchor(tmp_path):
    """Started on one thread, stopped on another (as the RPC handler and
    the window timer do): the Chrome trace holds the working thread's
    operators and the clock marker, and the anchor file names the
    marker's host time."""
    logdir = str(tmp_path / "real")
    box = {}
    t = threading.Thread(target=lambda: box.update(res=devprof.start_device_trace(logdir)))
    t.start()
    t.join()
    assert box["res"]["ok"]
    x = torch.randn(64, 64)
    with annotate("work_on_main"):
        x @ x
    res = devprof.stop_device_trace()
    assert res["ok"] and os.path.exists(res["trace"])
    names = {e.get("name") for e in _trace_events(res)}
    with open(os.path.join(logdir, devprof.ANCHOR_FILE)) as f:
        anchor = json.load(f)
    assert anchor["marker"].startswith(devprof.CLOCK_MARKER)
    assert anchor["marker"] in names and "work_on_main" in names
    assert anchor["perf_counter_ns"] <= anchor["marker_perf_ns"]


def test_telemetry_profile_over_loopback_rpc(tmp_path, free_port):
    from moolib_tpu_torch.rpc import Rpc

    host, client = Rpc(), Rpc()
    try:
        host.set_name("host")
        host.listen(f"127.0.0.1:{free_port}")
        telemetry.install_rpc_handlers(host)
        client.set_name("client")
        client.connect(f"127.0.0.1:{free_port}")
        logdir = str(tmp_path / "remote")
        res = client.sync("host", "__telemetry_profile", "start", logdir)
        assert res["ok"] and res["logdir"] == logdir
        again = client.sync("host", "__telemetry_profile", "start")
        assert not again["ok"] and "already active" in again["error"]
        torch.ones(32, 32) @ torch.ones(32, 32)
        out = client.sync("host", "__telemetry_profile", "stop")
        assert out["ok"] and os.path.exists(out["trace"])
        assert client.sync("host", "__telemetry_profile", "status") == {"active": False}
    finally:
        client.close()
        host.close()


def test_experiment_trace_dir_writes_a_window(tmp_path, free_port):
    """examples.vtrace.experiment --trace_dir opens a profiler window at the
    start of training and closes it (here, in the finally block: the run is
    shorter than the window)."""
    from moolib_tpu_torch.examples.vtrace import experiment

    trace_dir = str(tmp_path / "trace")
    experiment.train(experiment.make_flags([
        "--env", "catch", "--device", "cpu", "--trace_dir", trace_dir,
        "--address", f"127.0.0.1:{free_port}", "--total_steps", "400",
        "--actor_batch_size", "8", "--batch_size", "2", "--virtual_batch_size", "2",
        "--num_env_processes", "1", "--quiet"]))
    assert not devprof.profile_status()["active"]
    traces = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
    assert traces and os.path.exists(os.path.join(trace_dir, devprof.ANCHOR_FILE))
