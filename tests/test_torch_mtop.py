"""The port's cohort console (``moolib_tpu_torch.scripts.mtop``) against the
JAX package's ``scripts/mtop.py``: ``Console.refresh`` and ``render_plain``
give the same state and frame over one scripted aggregator's scrapes
(a departed peer, a counter reset, scrape errors, a straggler, serving
and timeline gauges); a port ``CohortAggregator`` scrapes a JAX peer's
``__telemetry_snapshot`` through a JAX broker; and ``mtop --once`` renders
a live port cohort without initialising CUDA."""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import mtop as jax_mtop  # noqa: E402

import moolib_tpu  # noqa: E402
import moolib_tpu_torch  # noqa: E402
from moolib_tpu import telemetry as jt  # noqa: E402
from moolib_tpu_torch import telemetry as tt  # noqa: E402
from moolib_tpu_torch.scripts import mtop  # noqa: E402

torch.set_num_threads(1)


def _fam(kind, series, buckets=None):
    fam = {"kind": kind, "help": "", "series": series}
    if buckets is not None:
        fam["buckets"] = buckets
    return fam


def _row(t, steps, role="member", mfu=None, hbm=None, serve=False, flights=()):
    met = {"train_steps_total": _fam("counter", [{"labels": {}, "value": steps}]),
           "step_time_fraction": _fam("gauge", [
               {"labels": {"bucket": "comm", "fn": "f"}, "value": 0.125},
               {"labels": {"bucket": "compute", "fn": "f"}, "value": 0.5}])}
    if mfu is not None:
        met["step_mfu"] = _fam("gauge", [{"labels": {"fn": "f"}, "value": mfu}])
    if hbm is not None:
        met["hbm_bytes_in_use"] = _fam("gauge", [{"labels": {"device": "cuda:0"}, "value": hbm}])
        met["hbm_bytes_peak"] = _fam("gauge", [{"labels": {"device": "cuda:0"},
                                                "value": 2 * hbm}])
    if serve:
        met["serve_qps"] = _fam("gauge", [{"labels": {}, "value": 12.5}])
        met["serve_engine_slot_occupancy"] = _fam("gauge", [{"labels": {}, "value": 0.75}])
        met["serve_phase_seconds"] = _fam("histogram", [
            {"labels": {"phase": "step"}, "value": {"buckets": [3, 5, 1, 1], "sum": 2.0,
                                                   "count": 10}}], buckets=[0.01, 0.1, 1.0])
    return {"time": t, "pid": 1, "role": role, "metrics": met,
            "flight": [{"time": t - 0.5 + i, "name": n, "args": a}
                       for i, (n, a) in enumerate(flights)]}


T0 = 1_700_000_000.0
SCRAPES = [
    ({"time": T0, "errors": {}, "peers": {
        "a": _row(T0, 100.0, mfu=0.31, hbm=3.5e9, flights=[("group.epoch", {"members": 3})]),
        "b": _row(T0, 90.0, hbm=2.0e6),
        "srv": _row(T0, 0.0, role="observer", serve=True)}},
     {"ratio": 1.0, "straggler": None, "peers": {"a": {"step_seconds": 0.1},
                                                 "b": {"step_seconds": 0.1}}}),
    ({"time": T0 + 10, "errors": {"b": "timeout"}, "peers": {
        "a": _row(T0 + 10, 150.0, mfu=0.29, hbm=3.6e9, flights=[("timeline.window", None)]),
        "srv": _row(T0 + 10, 0.0, role="observer", serve=True)}},
     {"ratio": 2.5, "straggler": "a", "peers": {"a": {"step_seconds": 0.25}}}),
    # "a" restarted (its counter dropped): no rate this refresh, then a
    # fresh baseline; "b" stays gone.
    ({"time": T0 + 20, "errors": {}, "peers": {
        "a": _row(T0 + 20, 5.0, mfu=0.3, hbm=1.0e3),
        "srv": _row(T0 + 20, 0.0, role="observer", serve=True)}},
     {"ratio": 1.0, "straggler": None, "peers": {}}),
    ({"time": T0 + 30, "errors": {}, "peers": {
        "a": _row(T0 + 30, 45.0, mfu=0.3, hbm=1.0e3)}},
     {"ratio": None, "straggler": None, "peers": {}}),
]


class _ScriptedAggregator:
    def __init__(self):
        self._i = -1

    def scrape(self):
        self._i += 1
        return SCRAPES[self._i][0]

    def step_skew(self):
        return SCRAPES[self._i][1]


def test_console_state_and_frame_equal_the_jax_console():
    mine, theirs = mtop.Console(_ScriptedAggregator()), jax_mtop.Console(_ScriptedAggregator())
    frames = []
    for _ in SCRAPES:
        a, b = mine.refresh(), theirs.refresh()
        assert a == b
        frame = mtop.render_plain(a)
        assert frame == jax_mtop.render_plain(b)
        frames.append((a, frame))
    # What the frames hold: the rate from the counter deltas, the reset
    # skipped, the departed peer kept and marked, the straggler flagged.
    (s1, f1), (s2, f2), (s3, f3), (s4, f4) = frames
    rows2 = {r["name"]: r for r in s2["rows"]}
    assert rows2["a"]["step_rate"] == pytest.approx(5.0) and rows2["b"]["gone"]
    assert "~b" in f2 and "gone" in f2 and "SLOW" in f2 and "scrape_errors=1" in f2
    assert {r["name"]: r for r in s3["rows"]}["a"]["step_rate"] is None
    assert {r["name"]: r for r in s4["rows"]}["a"]["step_rate"] == pytest.approx(4.0)
    assert "3.3G" in f1 and "12.5" in f1 and "75" in f1 and "flight ring" in f1
    for head in ("PEER", "ROLE", "ST/S", "MFU%", "HBM", "PEAK", "STEP_S", "SKEW", "EXPC%",
                 "QPS", "P99MS", "OCC%"):
        assert head in f1.splitlines()[1]
    assert mtop.COLUMNS == jax_mtop.COLUMNS


def test_snapshot_readers_equal_the_jax_readers():
    met = SCRAPES[0][0]["peers"]["srv"]["metrics"]
    for q in (0.5, 0.9, 0.99, 1.0):
        assert (mtop._hist_quantile(met, "serve_phase_seconds", q)
                == jax_mtop._hist_quantile(met, "serve_phase_seconds", q))
    for v in (None, 0, 1023, 1024, 5.5e6, 3e12, 7e15):
        assert mtop._fmt_bytes(v) == jax_mtop._fmt_bytes(v)


def _pump_until(pumps, until, seconds=30.0):
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        for p in pumps:
            p()
        if until():
            return True
        time.sleep(0.02)
    return until()


def test_port_aggregator_scrapes_a_jax_peer(free_port):
    """A JAX broker and a JAX Accumulator peer; the port's aggregator and
    console discover and scrape it."""
    broker = moolib_tpu.Broker()
    broker.set_name("broker")
    broker.listen(f"127.0.0.1:{free_port}")
    acc = moolib_tpu.Accumulator("mixtele", {"w": np.zeros(2, np.float32)})
    acc._rpc.set_name("jax-peer")
    acc.listen("127.0.0.1:0")
    acc.connect(f"127.0.0.1:{free_port}")
    rpc = moolib_tpu_torch.Rpc()
    rpc.set_name("port-scraper")
    rpc.connect(f"127.0.0.1:{free_port}")
    try:
        agg = tt.CohortAggregator(rpc, "broker", group="mixtele", scrape_timeout=5.0)
        assert _pump_until([broker.update, acc.update], lambda: set(agg.discover()) == {"jax-peer"})
        jt.flight_event("jax.marker", k=2)
        fused = agg.scrape()
        assert fused["errors"] == {} and set(fused["peers"]) == {"jax-peer"}
        row = fused["peers"]["jax-peer"]
        assert row["pid"] == os.getpid() and "accum_is_leader" in row["metrics"]
        assert "jax.marker" in [e["name"] for e in row["flight"]]
        assert 'peer="jax-peer"' in agg.prometheus_text()
        frame = mtop.render_plain(mtop.Console(agg).refresh())
        assert "jax-peer" in frame and "jax.marker" in frame
    finally:
        rpc.close()
        acc.close()
        broker.close()


def test_mtop_once_renders_a_live_cohort_without_cuda(free_port, monkeypatch, capsys):
    """``mtop --once --require-peers 2`` over a live two-peer port cohort:
    both rows and the flight-ring tail, exit 0 (2 with too few peers), and
    no CUDA initialisation on the way."""
    def no_cuda(*a, **k):
        raise AssertionError("mtop initialised CUDA")

    monkeypatch.setattr(torch.cuda, "_lazy_init", no_cuda)
    monkeypatch.setattr(torch.cuda, "init", no_cuda)
    broker = moolib_tpu_torch.Broker()
    broker.set_name("broker")
    broker.listen(f"127.0.0.1:{free_port}")
    accs = []
    for i in range(2):
        acc = moolib_tpu_torch.Accumulator("mtopgrp", {"w": torch.zeros(2)})
        acc._rpc.set_name(f"mtop-peer-{i}")
        acc.listen("127.0.0.1:0")
        acc.connect(f"127.0.0.1:{free_port}")
        accs.append(acc)
    pumps = [broker.update] + [a.update for a in accs]
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            for p in pumps:
                p()
            time.sleep(0.02)

    t = threading.Thread(target=loop, daemon=True)
    try:
        assert _pump_until(pumps, lambda: all(len(a._group.members()) == 2 for a in accs))
        t.start()
        argv = ["--broker", f"127.0.0.1:{free_port}", "--group", "mtopgrp", "--once",
                "--timeout", "10"]
        assert mtop.main(argv + ["--require-peers", "2"]) == 0
        out = capsys.readouterr().out
        assert "mtop-peer-0" in out and "mtop-peer-1" in out and "flight ring" in out
        assert "live=2" in out
        assert mtop.main(argv + ["--require-peers", "3"]) == 2
    finally:
        stop.set()
        t.join(10)
        for a in accs:
            a.close()
        broker.close()
