"""The port's telemetry plane (``moolib_tpu_torch.telemetry``) held against
the JAX package's, case for case of ``tests/test_telemetry.py``: registry
semantics and the Prometheus text (the same operations give the same
exposition in both packages), the HTTP endpoint, the JSONL snapshotter and
the SIGUSR1 dump, the Chrome-trace export and its ``metadata.clock_sync``,
the bounded ring, the trace context's wire bytes (encoded by one package,
decoded by the other), ``attach_context``, root and child spans, the
cardinality guard, the flight recorder and ``dump_diagnostics``, the
cohort delta helpers, the Rpc handlers' reply shape, ``CohortAggregator``
through a peer kill and its per-peer timeouts, and the single-process
wiring smoke over the port's Rpc, Accumulator and EnvPool.

Every case of the JAX file has a twin here; none is JAX-only.
``test_wiring_smoke_rpc_accumulator_envpool`` runs on the port's EnvPool
with a picklable module-level env, as the JAX one does.
"""

import io
import json
import os
import signal
import time
import urllib.request

import numpy as np
import pytest
import torch

from moolib_tpu import telemetry as jt
from moolib_tpu_torch import telemetry as tt

torch.set_num_threads(1)


@pytest.fixture
def reg():
    return tt.Registry()


def _same_ops(registry):
    """One fixed sequence of registry operations (every instrument kind,
    labels that need escaping, a histogram's overflow bucket)."""
    registry.counter("c_total", "a counter").inc(2)
    registry.counter("bytes_total", "", ("transport",)).inc(10, transport="tcp")
    registry.gauge("g", "a gauge", ("k",)).set(1.5, k='va"l\\x\ny')
    g = registry.gauge("depth", "", ("q",))
    g.set(4, q="a")
    g.inc(2, q="a")
    g.dec(1, q="a")
    h = registry.histogram("h_seconds", "a hist", buckets=(0.1, 1.0))
    for v in (0.05, 2.0, 0.5):
        h.observe(v)
    return registry


# --------------------------------------------------------------- instruments
def test_counter_semantics(reg):
    c = reg.counter("events_total", "help text")
    c.inc()
    c.inc(2.5)
    assert reg.counter_values() == {"events_total": 3.5}
    with pytest.raises(ValueError):
        c.inc(-1)


def test_labeled_counter_and_label_validation(reg):
    c = reg.counter("bytes_total", "", ("transport",))
    c.inc(10, transport="tcp")
    c.labels(transport="ipc").inc(5)
    vals = reg.counter_values()
    assert vals['bytes_total{transport="tcp"}'] == 10
    assert vals['bytes_total{transport="ipc"}'] == 5
    with pytest.raises(ValueError):
        c.labels(transport="tcp", extra="x")
    with pytest.raises(ValueError):
        c.labels()
    with pytest.raises(ValueError):
        c.inc(1)


def test_registration_idempotent_and_type_conflicts(reg):
    c1 = reg.counter("n_total", "h")
    assert reg.counter("n_total", "h") is c1
    with pytest.raises(ValueError):
        reg.gauge("n_total")
    with pytest.raises(ValueError):
        reg.counter("n_total", "h", ("lab",))


def test_gauge_semantics(reg):
    g = reg.gauge("depth", "", ("q",))
    g.set(4, q="a")
    g.inc(2, q="a")
    g.dec(1, q="a")
    assert g.labels(q="a").get() == 5
    assert g.samples() == [({"q": "a"}, 5.0)]


def test_histogram_buckets_sum_count(reg):
    h = reg.histogram("lat", "", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0):
        h.observe(v)
    s = h.labels().get()
    assert s["buckets"] == [1, 1, 1, 1]
    assert s["count"] == 4
    assert abs(s["sum"] - 5.555) < 1e-9
    with h.time():
        pass
    assert h.labels().get()["count"] == 5


def test_registry_state_equals_the_jax_package():
    """The same operations leave the same values and the same snapshot in
    both packages' registries."""
    a, b = _same_ops(jt.Registry()), _same_ops(tt.Registry())
    assert a.counter_values() == b.counter_values()
    assert a.snapshot() == b.snapshot()


# ----------------------------------------------------------------- exporters
def test_prometheus_exposition_format(reg):
    reg.counter("c_total", "a counter").inc(2)
    reg.gauge("g", "a gauge", ("k",)).set(1.5, k='va"l')
    h = reg.histogram("h_seconds", "a hist", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(2.0)
    lines = tt.prometheus_text(reg).splitlines()
    assert "# TYPE c_total counter" in lines
    assert "c_total 2" in lines
    assert "# TYPE g gauge" in lines
    assert 'g{k="va\\"l"} 1.5' in lines
    assert 'h_seconds_bucket{le="0.1"} 1' in lines
    assert 'h_seconds_bucket{le="1"} 1' in lines
    assert 'h_seconds_bucket{le="+Inf"} 2' in lines
    assert "h_seconds_count 2" in lines
    assert any(line.startswith("h_seconds_sum ") for line in lines)


def test_prometheus_text_equals_the_jax_package():
    """Byte for byte: a scraper cannot tell a port peer from a JAX one."""
    text = tt.prometheus_text(_same_ops(tt.Registry()))
    assert text == jt.prometheus_text(_same_ops(jt.Registry()))
    assert 'g{k="va\\"l\\\\x\\ny"} 1.5' in text.splitlines()


def test_http_endpoint(reg):
    reg.counter("served_total").inc()
    tracer = tt.Tracer()
    with tracer.span("probe"):
        pass
    port = tt.serve_http(0, registry=reg, tracer=tracer)
    body = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=5).read()
    assert b"served_total 1" in body
    trace = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/trace", timeout=5).read())
    assert any(e.get("name") == "probe" for e in trace["traceEvents"])
    with pytest.raises(urllib.request.HTTPError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/nope", timeout=5)


def test_jsonl_snapshotter(tmp_path, reg):
    reg.counter("snap_total").inc(7)
    snap = tt.JsonlSnapshotter(str(tmp_path), interval=3600, registry=reg)
    snap.snapshot_now()
    snap.close()
    lines = (tmp_path / "telemetry.jsonl").read_text().splitlines()
    assert len(lines) >= 2
    row = json.loads(lines[0])
    assert row["metrics"]["snap_total"]["series"][0]["value"] == 7
    trace = json.loads((tmp_path / "host_trace.json").read_text())
    assert "traceEvents" in trace


def test_jsonl_row_shape_equals_the_jax_package(tmp_path):
    """The snapshot row the autoscaler and the aggregator read: the same
    keys, and the same metrics for the same operations."""
    rows = {}
    for name, pkg in (("jax", jt), ("port", tt)):
        d = tmp_path / name
        snap = pkg.JsonlSnapshotter(str(d), interval=3600, registry=_same_ops(pkg.Registry()))
        snap.snapshot_now()
        snap.close()
        rows[name] = json.loads((d / "telemetry.jsonl").read_text().splitlines()[0])
    assert set(rows["jax"]) == set(rows["port"])
    assert rows["jax"]["metrics"] == rows["port"]["metrics"]


def test_sigusr1_dump(capfd, reg, tmp_path):
    reg.counter("kicked_total").inc()
    prev = signal.getsignal(signal.SIGUSR1)
    try:
        assert tt.install_signal_dump(str(tmp_path), registry=reg)
        os.kill(os.getpid(), signal.SIGUSR1)
        deadline = time.monotonic() + 5.0
        err = ""
        while time.monotonic() < deadline and "kicked_total 1" not in err:
            time.sleep(0.01)
            err += capfd.readouterr().err
        assert "telemetry dump" in err and "kicked_total 1" in err
        assert (tmp_path / "host_trace.json").exists()
    finally:
        signal.signal(signal.SIGUSR1, prev)


# ------------------------------------------------------------------- tracing
def test_chrome_trace_nested_spans():
    tracer = tt.Tracer()
    with tracer.span("outer", step=1):
        with tracer.span("inner"):
            time.sleep(0.002)
    data = tracer.chrome_trace()
    json.dumps(data)
    ev = {e["name"]: e for e in data["traceEvents"] if e["ph"] == "X"}
    assert set(ev) == {"outer", "inner"}
    assert ev["outer"]["args"] == {"step": 1}
    o, i = ev["outer"], ev["inner"]
    assert o["tid"] == i["tid"]
    assert o["ts"] <= i["ts"]
    assert i["ts"] + i["dur"] <= o["ts"] + o["dur"] + 1e-3
    assert i["dur"] >= 2000


def test_chrome_trace_metadata_and_ids_match_the_jax_package():
    """``metadata.clock_sync`` carries the JAX keys, and span, trace and
    parent ids are written in the JAX form (fixed-width lower-case hex),
    so trace_merge links a mixed cohort's files."""
    exports = {}
    for name, pkg in (("jax", jt), ("port", tt)):
        tracer = pkg.Tracer()
        ctx = pkg.TraceContext(0xABC, 0x12)
        with tracer.span("outer", step=1):
            tracer.record("rpc.recv echo", time.perf_counter_ns(), 1000, trace_id=ctx.trace_id,
                          span_id=0x34, parent_id=ctx.span_id, args={"rid": 3})
        exports[name] = tracer.chrome_trace()
    j, p = exports["jax"], exports["port"]
    assert set(j) == set(p)
    assert set(j["metadata"]) == set(p["metadata"])
    assert set(j["metadata"]["clock_sync"]) == set(p["metadata"]["clock_sync"])
    assert all(isinstance(v, int) for v in p["metadata"]["clock_sync"].values())

    def recv(data):
        return next(e for e in data["traceEvents"] if e["name"] == "rpc.recv echo")

    assert recv(j)["args"] == recv(p)["args"] == {
        "rid": 3, "trace_id": f"{0xABC:032x}", "span_id": f"{0x34:016x}",
        "parent_id": f"{0x12:016x}"}
    assert {k for k in recv(j) if k not in ("ts", "pid", "tid")} == {
        k for k in recv(p) if k not in ("ts", "pid", "tid")}


def test_tracer_ring_is_bounded():
    tracer = tt.Tracer(capacity=8)
    for k in range(20):
        with tracer.span(f"s{k}"):
            pass
    names = [s.name for s in tracer.spans()]
    assert len(names) == 8 and names[-1] == "s19"


# -------------------------------------------------------- distributed context
def test_trace_context_wire_roundtrip():
    from moolib_tpu_torch.telemetry.tracing import new_span_id, new_trace_id

    ctx = tt.TraceContext(new_trace_id(), new_span_id())
    data = tt.encode_context(ctx)
    assert len(data) == 24
    assert tt.decode_context(data) == ctx
    assert tt.encode_context(None) == b""
    assert tt.decode_context(b"") is None
    assert tt.decode_context(b"\x00" * 24) is None
    assert tt.decode_context(b"short") is None


@pytest.mark.parametrize("seed", range(4))
def test_trace_context_wire_bytes_cross_packages(seed):
    """Encoded by one package, decoded by the other, both ways: the same 24
    bytes for the same ids, and the same ids back."""
    rng = np.random.default_rng(seed)
    trace_id = int.from_bytes(rng.bytes(16), "little") | 1
    span_id = int.from_bytes(rng.bytes(8), "little") | 1
    jctx, pctx = jt.TraceContext(trace_id, span_id), tt.TraceContext(trace_id, span_id)
    jb, pb = jt.encode_context(jctx), tt.encode_context(pctx)
    assert jb == pb and len(pb) == 24
    from_port = jt.decode_context(pb)
    from_jax = tt.decode_context(jb)
    assert (from_port.trace_id, from_port.span_id) == (trace_id, span_id)
    assert (from_jax.trace_id, from_jax.span_id) == (trace_id, span_id)
    for bad in (b"", b"\x00" * 24, b"short", pb + b"\x00"):
        assert jt.decode_context(bad) is None and tt.decode_context(bad) is None


def test_attach_context_is_ambient_but_records_nothing():
    from moolib_tpu_torch.telemetry.tracing import new_span_id, new_trace_id

    ctx = tt.TraceContext(new_trace_id(), new_span_id())
    assert tt.current_context() is None
    with tt.attach_context(ctx):
        assert tt.current_context() is ctx
        with tt.span("attached_child"):
            pass
    assert tt.current_context() is None
    spans = [s for s in tt.get_tracer().spans() if s.trace_id == ctx.trace_id]
    assert [s.name for s in spans] == ["attached_child"]
    assert spans[0].parent_id == ctx.span_id
    with tt.attach_context(None):
        assert tt.current_context() is None


def test_root_and_child_span_link_up():
    with tt.root_span("op_root") as root:
        ctx = root.context
        assert ctx is not None and tt.current_context() is ctx
    with tt.child_span("op_remote", ctx):
        pass
    spans = {s.name: s for s in tt.get_tracer().spans() if s.trace_id == ctx.trace_id}
    assert spans["op_root"].parent_id is None
    assert spans["op_remote"].parent_id == ctx.span_id
    assert spans["op_remote"].span_id != ctx.span_id


def test_child_span_links_to_a_jax_context():
    """A context the JAX package made, carried as wire bytes, parents a
    port span (the handler side of a mixed call)."""
    with jt.root_span("jax_root") as root:
        wire = jt.encode_context(root.context)
    ctx = tt.decode_context(wire)
    with tt.child_span("port_child", ctx):
        pass
    (child,) = [s for s in tt.get_tracer().spans() if s.trace_id == ctx.trace_id]
    assert child.parent_id == root.context.span_id


# --------------------------------------------------------- cardinality guard
def test_cardinality_guard_caps_labelsets(reg, monkeypatch):
    monkeypatch.setenv("MOOLIB_TELEMETRY_MAX_LABELSETS", "3")
    c = reg.counter("fanout_total", "", ("shard",))
    for k in range(5):
        c.inc(1, shard=f"s{k}")
    vals = reg.counter_values()
    exported = [k for k in vals if k.startswith("fanout_total{")]
    assert len(exported) == 3
    assert sum(vals[k] for k in exported) == 3
    assert vals["telemetry_dropped_labelsets_total"] == 2
    c.inc(1, shard="s0")
    assert reg.counter_values()['fanout_total{shard="s0"}'] == 2
    reg.counter("plain_total").inc()
    assert reg.counter_values()["plain_total"] == 1


def test_cardinality_guard_exposition_equals_the_jax_package(monkeypatch):
    monkeypatch.setenv("MOOLIB_TELEMETRY_MAX_LABELSETS", "3")
    texts = []
    for pkg in (jt, tt):
        r = pkg.Registry()
        c = r.counter("fanout_total", "", ("shard",))
        for k in range(5):
            c.inc(1, shard=f"s{k}")
        texts.append(pkg.prometheus_text(r))
    assert texts[0] == texts[1]


# ------------------------------------------------------------ flight recorder
def test_flight_recorder_ring_and_tail():
    rec = tt.FlightRecorder(capacity=4)
    for k in range(6):
        rec.event("evt", k=k)
    evs = rec.events()
    assert len(evs) == 4
    assert evs[-1][1] == "evt" and evs[-1][2] == {"k": 5}
    tail = rec.format_tail(2)
    assert "last 2 events" in tail and "evt k=5" in tail
    rec.clear()
    assert "empty" in rec.format_tail()


def test_flight_event_mirrors_into_tracer():
    tt.flight_event("test.flight_marker", q=1)
    assert any(e[1] == "test.flight_marker" for e in tt.get_flight_recorder().events())
    assert any(s.name == "test.flight_marker" and s.dur_ns is None
               for s in tt.get_tracer().spans())


def test_dump_diagnostics_includes_flight_tail(reg):
    tt.flight_event("diag.marker", x=42)
    buf = io.StringIO()
    tt.dump_diagnostics(reason="test", registry=reg, file=buf, stacks=False)
    out = buf.getvalue()
    assert "flight recorder" in out and "diag.marker" in out


def test_read_snapshot_tail_shared_with_autoscaler(tmp_path, reg):
    from moolib_tpu_torch import autoscaler

    assert autoscaler.read_snapshot_tail is tt.read_snapshot_tail
    reg.counter("tailed_total").inc(3)
    snap = tt.JsonlSnapshotter(str(tmp_path), interval=3600, registry=reg)
    snap.snapshot_now()
    snap.close()
    row = tt.read_snapshot_tail(str(tmp_path / "telemetry.jsonl"))
    assert row["metrics"]["tailed_total"]["series"][0]["value"] == 3
    assert tt.read_snapshot_tail(str(tmp_path / "missing.jsonl")) is None


# -------------------------------------------------------------------- cohort
def test_cohort_counters_delta_protocol(reg):
    c = reg.counter("work_total")
    c.inc(10)
    stat = tt.CohortCounters(reg)
    snap = stat.snapshot()
    c.inc(5)
    assert stat.delta(snap) == {"work_total": 5.0}
    stat.apply_delta({"work_total": 100.0, "other_total": 3.0})
    assert stat.value("work_total") == 115.0
    assert stat.value("other_total") == 3.0
    assert reg.counter_values()["work_total"] == 15.0
    snap.apply_delta({"work_total": 100.0})
    c.inc(1)
    assert stat.delta(snap)["work_total"] == 6.0


def test_common_delta_helpers_handle_dicts():
    from moolib_tpu.examples import common as jc
    from moolib_tpu_torch.examples.common import _delta_add, _delta_reduce_op, _delta_sub

    a, b = {"x": 1.0}, {"x": 2.0, "y": 3.0}
    assert _delta_add(a, b) == jc._delta_add(a, b) == {"x": 3.0, "y": 3.0}
    assert _delta_sub(b, a) == jc._delta_sub(b, a) == {"x": 1.0, "y": 3.0}
    assert (_delta_reduce_op({"t": a}, {"t": b}) == jc._delta_reduce_op({"t": a}, {"t": b})
            == {"t": {"x": 3.0, "y": 3.0}})


# ------------------------------------------------------------- wiring smoke
class _TeleEnv:
    """Minimal env (module-level: picklable for the pool's workers)."""

    def reset(self):
        return np.zeros(2, np.float32)

    def step(self, action):
        return np.zeros(2, np.float32), 1.0, False, {}


def _pump(broker, acc, seconds, until):
    deadline = time.time() + seconds
    while time.time() < deadline:
        broker.update()
        acc.update()
        if until():
            return True
        time.sleep(0.02)
    return until()


def test_wiring_smoke_rpc_accumulator_envpool(free_port, tmp_path):
    """An Rpc echo, one accumulator reduction and one EnvPool batch step
    populate the port's rpc/accum/envpool metric families; the Prometheus
    dump, Chrome trace and JSONL snapshot all come out valid."""
    from moolib_tpu_torch import Accumulator, Broker, Rpc
    from moolib_tpu_torch.envpool import EnvPool

    pool = EnvPool(_TeleEnv, num_processes=2, batch_size=4, num_batches=1)
    try:
        pool.step(0, np.zeros(4, np.int64)).result()
    finally:
        pool.close()

    a, b = Rpc(), Rpc()
    a.set_name("tele-a")
    b.set_name("tele-b")
    b.define("echo", lambda x: x)
    b.listen("127.0.0.1:0")
    addr = next(x for x in b._listen_addrs if x.startswith("tcp://127"))
    a.connect(addr)
    try:
        assert a.sync("tele-b", "echo", 1) == 1
    finally:
        a.close()
        b.close()

    with tt.span("accum_round"):
        broker = Broker()
        broker.set_name("broker")
        broker.listen(f"127.0.0.1:{free_port}")
        acc = Accumulator("tele", {"w": torch.zeros(2)})
        acc._rpc.set_name("tele-peer")
        acc.listen("127.0.0.1:0")
        acc.connect(f"127.0.0.1:{free_port}")
        try:
            assert _pump(broker, acc, 30, lambda: acc.connected())
            acc.reduce_gradients(1, {"w": torch.ones(2)})
            assert _pump(broker, acc, 30, lambda: acc.has_gradients())
            np.testing.assert_allclose(np.asarray(acc.gradients()["w"]), 1.0)
            acc.zero_gradients()
        finally:
            acc.close()
            broker.close()

    text = tt.prometheus_text()
    for family in ("rpc_tx_bytes_total", "rpc_rx_bytes_total", "rpc_rtt_seconds_count",
                   "rpc_peer_latency_seconds", "accum_reduces_total", "accum_gradients_total",
                   "accum_elections_total", "envpool_steps_total",
                   "envpool_step_wait_seconds_count"):
        assert family in text, f"{family} missing from exposition:\n{text[:2000]}"
    assert 'accum_reduces_total{plane="rpc"}' in text
    assert 'accum_is_leader{accumulator="tele",peer="tele-peer"} 1' in text

    path = tt.get_tracer().export_chrome_trace(str(tmp_path / "trace.json"))
    with open(path) as f:
        trace = json.load(f)
    assert any(e.get("name") == "accum_round" for e in trace["traceEvents"])

    snap = tt.JsonlSnapshotter(str(tmp_path), interval=3600)
    snap.snapshot_now()
    snap.close()
    rows = [json.loads(ln) for ln in (tmp_path / "telemetry.jsonl").read_text().splitlines()]
    assert rows and "envpool_steps_total" in rows[0]["metrics"]


def test_queue_stats_readable_through_registry():
    """define_queue service counters export as rpc_queue_*{queue=<name>}
    while Queue.stats() keeps working."""
    import asyncio
    import threading

    from moolib_tpu_torch import Rpc

    a, b = Rpc(), Rpc()
    a.set_name("tele-qa")
    b.set_name("tele-qb")
    q = b.define_queue("tele_q")
    b.listen("127.0.0.1:0")
    addr = next(x for x in b._listen_addrs if x.startswith("tcp://127"))
    a.connect(addr)

    async def serve_one():
        ret, args, kwargs = await q
        ret(args[0] * 2)

    t = None
    try:
        fut = a.async_("tele-qb", "tele_q", 21)
        loop = asyncio.new_event_loop()
        t = threading.Thread(target=lambda: loop.run_until_complete(serve_one()))
        t.start()
        assert fut.result(30) == 42
    finally:
        if t is not None:
            t.join(10)
        a.close()
        b.close()
    st = q.stats()
    assert st["items"] == 1 and st["takes"] == 1
    text = tt.prometheus_text()
    assert 'rpc_queue_items_total{queue="tele_q"} 1' in text
    assert 'rpc_queue_wait_seconds_count{queue="tele_q"} 1' in text


# -------------------------------------------------------- cohort aggregation
def test_telemetry_rpc_handlers_shape():
    """install_rpc_handlers exposes the snapshot and trace endpoints with
    the JSONL row shape — and is idempotent."""
    from moolib_tpu_torch import Rpc

    a, b = Rpc(), Rpc()
    a.set_name("scrape-a")
    b.set_name("scrape-b")
    assert tt.install_rpc_handlers(b)
    assert not tt.install_rpc_handlers(b)
    b.listen("127.0.0.1:0")
    addr = next(x for x in b._listen_addrs if x.startswith("tcp://127"))
    a.connect(addr)
    try:
        tt.flight_event("test.marker", k=1)
        row = a.sync("scrape-b", "__telemetry_snapshot")
        assert row["name"] == "scrape-b" and row["pid"] == os.getpid()
        assert isinstance(row["metrics"], dict)
        assert "test.marker" in [ev["name"] for ev in row["flight"]]
        trace = a.sync("scrape-b", "__telemetry_trace")
        assert "traceEvents" in trace and "clock_sync" in trace["metadata"]
    finally:
        a.close()
        b.close()


def test_telemetry_rpc_handlers_reply_shape_equals_the_jax_package():
    """A JAX caller scrapes a port peer and a JAX peer: the two snapshot
    rows and trace replies carry the same keys, flight entries alike."""
    import moolib_tpu
    import moolib_tpu_torch

    client = moolib_tpu.Rpc()
    client.set_name("shape-client")
    peers = {"jax": moolib_tpu.Rpc(), "port": moolib_tpu_torch.Rpc()}
    try:
        for name, (peer, pkg) in {"jax": (peers["jax"], jt), "port": (peers["port"], tt)}.items():
            peer.set_name(f"shape-{name}")
            assert pkg.install_rpc_handlers(peer)
            peer.listen("127.0.0.1:0")
            client.connect(next(x for x in peer._listen_addrs if x.startswith("tcp://127")))
        jt.flight_event("shape.marker", k=1)
        tt.flight_event("shape.marker", k=1)
        rows = {n: client.sync(f"shape-{n}", "__telemetry_snapshot") for n in peers}
        traces = {n: client.sync(f"shape-{n}", "__telemetry_trace") for n in peers}
    finally:
        client.close()
        for p in peers.values():
            p.close()
    assert set(rows["jax"]) == set(rows["port"])
    fj = next(e for e in rows["jax"]["flight"] if e["name"] == "shape.marker")
    fp = next(e for e in rows["port"]["flight"] if e["name"] == "shape.marker")
    assert set(fj) == set(fp) and fj["args"] == fp["args"] == {"k": 1}
    assert set(traces["jax"]) == set(traces["port"])
    assert set(traces["jax"]["metadata"]["clock_sync"]) == set(
        traces["port"]["metadata"]["clock_sync"])


def test_cohort_aggregator_survives_peer_kill(free_port):
    """A broker-discovered two-peer cohort scrapes clean; killing one peer
    costs that peer an entry in ``errors``, never the scrape."""
    from moolib_tpu_torch import Accumulator, Broker, Rpc

    broker = Broker()
    broker.set_name("broker")
    broker.listen(f"127.0.0.1:{free_port}")
    accs = []
    for i in range(2):
        acc = Accumulator("aggtele", {"w": torch.zeros(2)})
        acc._rpc.set_name(f"agg-peer-{i}")
        acc.listen("127.0.0.1:0")
        acc.connect(f"127.0.0.1:{free_port}")
        accs.append(acc)
    agg_rpc = Rpc()
    agg_rpc.set_name("agg-scraper")
    agg_rpc.connect(f"127.0.0.1:{free_port}")

    def pump_all(seconds, until):
        deadline = time.time() + seconds
        while time.time() < deadline:
            broker.update()
            for acc in accs:
                acc.update()
            if until():
                return True
            time.sleep(0.02)
        return until()

    try:
        agg = tt.CohortAggregator(agg_rpc, "broker", group="aggtele", scrape_timeout=5.0)
        assert pump_all(60, lambda: set(agg.discover()) == {"agg-peer-0", "agg-peer-1"})
        roster = agg.discover()
        fused = agg.scrape()
        assert set(fused["peers"]) == {"agg-peer-0", "agg-peer-1"}
        assert fused["errors"] == {}
        text = agg.prometheus_text()
        assert 'peer="agg-peer-0"' in text and 'peer="agg-peer-1"' in text
        assert {s.name for s in agg.peer_samples()} == set(roster)

        accs[1].close()
        fused = agg.scrape()
        assert "agg-peer-0" in fused["peers"]
        assert "agg-peer-1" in fused["errors"]
        assert "agg-peer-1" not in fused["peers"]
    finally:
        agg_rpc.close()
        for acc in accs:
            acc.close()
        broker.close()


class _ScrapeFut:
    def __init__(self, fn):
        self._fn = fn

    def result(self, timeout):
        return self._fn(timeout)

    def cancel(self):
        pass


class _ScrapeRpc:
    """In-process stand-in for Rpc: one broker roster, per-peer snapshot
    results (a value, or an exception to raise), with the timeout each
    ``result()`` call received recorded."""

    def __init__(self, rows):
        self.rows = rows
        self.timeouts = {}

    def get_name(self):
        return "observer"

    def async_(self, peer, method, *args):
        if method == "__broker_list":
            return _ScrapeFut(lambda _t: {"members": sorted(self.rows)})

        def _res(timeout):
            self.timeouts.setdefault(peer, []).append(timeout)
            v = self.rows[peer]
            if isinstance(v, Exception):
                raise v
            return v

        return _ScrapeFut(_res)


def test_aggregator_peer_timeout_resolution(monkeypatch):
    rpc = _ScrapeRpc({})
    assert tt.CohortAggregator(rpc, "broker", scrape_timeout=3.0)._peer_timeout == 3.0
    monkeypatch.setenv("MOOLIB_AGGREGATOR_SCRAPE_TIMEOUT", "0.25")
    assert tt.CohortAggregator(rpc, "broker", scrape_timeout=3.0)._peer_timeout == 0.25
    agg = tt.CohortAggregator(rpc, "broker", scrape_timeout=3.0, peer_timeout=0.1)
    assert agg._peer_timeout == 0.1
    monkeypatch.setenv("MOOLIB_AGGREGATOR_SCRAPE_TIMEOUT", "soon")
    assert tt.CohortAggregator(rpc, "broker", scrape_timeout=3.0)._peer_timeout == 3.0


def test_aggregator_scrape_isolates_slow_peer_and_times_pulls():
    row = {"time": 1.0, "pid": 7, "metrics": {}}
    rpc = _ScrapeRpc({"good": row, "wedged": TimeoutError("no answer")})
    agg = tt.CohortAggregator(rpc, "broker", scrape_timeout=5.0, peer_timeout=0.2)
    fused = agg.scrape()
    assert set(fused["peers"]) == {"good"}
    assert "wedged" in fused["errors"]
    assert all(t <= 0.2 + 1e-6 for t in rpc.timeouts["wedged"])
    snap = tt.get_registry().snapshot()
    secs = {s["labels"]["peer"]: s["value"] for s in snap["aggregator_scrape_seconds"]["series"]}
    assert secs["good"]["count"] >= 1
    assert secs["wedged"]["count"] >= 1
    errs = {s["labels"]["peer"]: s["value"]
            for s in snap["aggregator_scrape_errors_total"]["series"]}
    assert errs.get("wedged", 0) >= 1


def test_fused_scrape_equals_the_jax_aggregator():
    """The same scripted cohort through both aggregators: the same fused
    peers and errors, and the same per-peer Prometheus text."""
    rows = {"good": {"time": 1.0, "pid": 7, "metrics": _same_ops(tt.Registry()).snapshot()},
            "wedged": TimeoutError("no answer")}
    fused = {}
    for name, pkg in (("jax", jt), ("port", tt)):
        agg = pkg.CohortAggregator(_ScrapeRpc(rows), "broker", scrape_timeout=5.0,
                                   peer_timeout=0.2)
        f = agg.scrape()
        fused[name] = (f["peers"], sorted(f["errors"]), agg.prometheus_text())
    assert fused["jax"] == fused["port"]
