"""Distributed trace propagation in the port: the context rides the Rpc
frame, handlers open child spans, retries show up as sibling resend spans,
and the span graph stays well-formed under ``FrameFaults`` — the five
cases of ``tests/test_tracing_distributed.py`` on the port's ``Rpc`` and
``moolib_tpu_torch.testing.faults.FrameFaults``, plus a mixed pair: a JAX
``Rpc`` calling a port ``Rpc`` and the reverse, where the callee's
``rpc.recv`` span has the caller's ``rpc.call`` span id as its parent.

None of the JAX cases is JAX-only.  In the mixed pair each package records
into its own tracer (one per package), so the caller's spans are read
from the caller's package and the callee's from the callee's.
"""

import random
import time

import pytest

import moolib_tpu
import moolib_tpu_torch
from moolib_tpu import telemetry as jt
from moolib_tpu_torch import telemetry as tt
from moolib_tpu_torch.rpc.core import KIND_REQUEST
from moolib_tpu_torch.testing.faults import FrameFaults


class _Scripted(random.Random):
    """random.Random whose random() plays back a fixed decision sequence
    (then passes forever) — pins FrameFaults onto an exact frame."""

    def __new__(cls, seq):
        return super().__new__(cls, 0)

    def __init__(self, seq):
        super().__init__(0)
        self._seq = list(seq)

    def random(self):
        return self._seq.pop(0) if self._seq else 1.0


def _rpc_pair(client_name, server_name, client_pkg=moolib_tpu_torch, server_pkg=moolib_tpu_torch):
    a, b = client_pkg.Rpc(), server_pkg.Rpc()
    a.set_name(client_name)
    b.set_name(server_name)
    b.define("echo", lambda x: x)
    b.listen("127.0.0.1:0")
    addr = next(x for x in b._listen_addrs if x.startswith("tcp://127"))
    a.connect(addr)
    return a, b


def _spans_for(trace_id, name=None, deadline=5.0, pkg=tt):
    """Poll ``pkg``'s default tracer for spans of one trace (the client-side
    rpc.call span is recorded from the response future's done callback,
    which can land a beat after sync() returns)."""
    t0 = time.monotonic()
    while True:
        spans = [s for s in pkg.get_tracer().spans()
                 if s.trace_id == trace_id and (name is None or s.name == name)]
        if spans or time.monotonic() - t0 > deadline:
            return spans
        time.sleep(0.01)


def _assert_well_formed(spans):
    """Unique span ids, and every parent id resolves to a recorded span of
    the same trace (no orphans)."""
    ids = [s.span_id for s in spans if s.span_id is not None]
    assert len(ids) == len(set(ids)), "duplicated span ids in trace"
    id_set = set(ids)
    for s in spans:
        if s.parent_id is not None:
            assert s.parent_id in id_set, f"orphaned parent on {s.name!r}"


def test_trace_propagation_clean():
    """root span -> rpc.call (child of root) -> rpc.recv (child of the call
    span: the cross-process edge trace_merge stitches on)."""
    a, b = _rpc_pair("trc-a", "trc-b")
    try:
        with tt.root_span("client.op") as root:
            ctx = root.context
            assert a.sync("trc-b", "echo", 7) == 7
    finally:
        a.close()
        b.close()

    calls = _spans_for(ctx.trace_id, "rpc.call echo")
    assert len(calls) == 1
    recvs = _spans_for(ctx.trace_id, "rpc.recv echo")
    assert len(recvs) == 1
    roots = _spans_for(ctx.trace_id, "client.op")
    assert len(roots) == 1 and roots[0].parent_id is None
    assert calls[0].parent_id == roots[0].span_id == ctx.span_id
    assert recvs[0].parent_id == calls[0].span_id
    _assert_well_formed(_spans_for(ctx.trace_id))


def test_untraced_call_records_no_ids():
    tracer = tt.get_tracer()
    before = len(tracer.spans())
    a, b = _rpc_pair("unt-a", "unt-b")
    try:
        assert tt.current_context() is None
        assert a.sync("unt-b", "echo", 3) == 3
    finally:
        a.close()
        b.close()
    new = tracer.spans()[before:]
    assert all(s.trace_id is None for s in new if s.name.startswith("rpc."))


def test_dropped_request_resend_is_sibling_span():
    """A scripted drop of exactly the first request frame: the retry is an
    rpc.resend SIBLING of the rpc.call span, never a duplicate."""
    a, b = _rpc_pair("drop-a", "drop-b")
    try:
        assert a.sync("drop-b", "echo", 0) == 0
        faults = FrameFaults(_Scripted([0.0]), drop=0.5, kinds=(KIND_REQUEST,))
        with faults:
            with tt.root_span("client.drop") as root:
                ctx = root.context
                assert a.sync("drop-b", "echo", 41) == 41
        assert faults.counts["drop"] == 1
    finally:
        a.close()
        b.close()

    calls = _spans_for(ctx.trace_id, "rpc.call echo")
    resends = _spans_for(ctx.trace_id, "rpc.resend echo")
    assert len(calls) == 1 and len(resends) >= 1
    for r in resends:
        assert r.parent_id == calls[0].parent_id
        assert r.span_id != calls[0].span_id
        assert r.args["why"] in ("nack", "blind")
    assert len(_spans_for(ctx.trace_id, "rpc.recv echo")) == 1
    _assert_well_formed(_spans_for(ctx.trace_id))


def test_duplicated_request_dedups_to_one_recv_span():
    a, b = _rpc_pair("dup-a", "dup-b")
    try:
        assert a.sync("dup-b", "echo", 0) == 0
        faults = FrameFaults(_Scripted([0.6]), drop=0.5, dup=0.4, kinds=(KIND_REQUEST,))
        with faults:
            with tt.root_span("client.dup") as root:
                ctx = root.context
                assert a.sync("dup-b", "echo", 13) == 13
        assert faults.counts["dup"] == 1
    finally:
        a.close()
        b.close()

    assert len(_spans_for(ctx.trace_id, "rpc.call echo")) == 1
    assert len(_spans_for(ctx.trace_id, "rpc.recv echo")) == 1
    _assert_well_formed(_spans_for(ctx.trace_id))


def test_fault_run_traces_stay_well_formed():
    """A seeded drop/dup run over traced calls: every call completes and
    every trace is a well-formed tree, retries only ever siblings."""
    a, b = _rpc_pair("soak-a", "soak-b")
    trace_ids = []
    faults = FrameFaults(random.Random(1234), drop=0.25, dup=0.25, kinds=(KIND_REQUEST,))
    try:
        assert a.sync("soak-b", "echo", 0) == 0
        with faults:
            for k in range(8):
                with tt.root_span("client.soak", k=k) as root:
                    trace_ids.append(root.context.trace_id)
                    assert a.sync("soak-b", "echo", k) == k
        assert faults.counts["drop"] + faults.counts["dup"] > 0
    finally:
        a.close()
        b.close()

    saw_resend = False
    for tid in trace_ids:
        calls = _spans_for(tid, "rpc.call echo")
        assert len(calls) == 1
        assert len(_spans_for(tid, "rpc.recv echo")) >= 1
        spans = _spans_for(tid)
        _assert_well_formed(spans)
        for r in (s for s in spans if s.name == "rpc.resend echo"):
            saw_resend = True
            assert r.parent_id == calls[0].parent_id
            assert r.span_id != calls[0].span_id
    if faults.counts["drop"] > 0:
        assert saw_resend


@pytest.mark.parametrize("caller", ["jax", "port"])
def test_mixed_pair_recv_span_parents_on_the_callers_call_span(caller):
    """A JAX Rpc calling a port Rpc, and the reverse: the trace context
    crosses the wire between the packages, and the callee's rpc.recv span
    has the caller's rpc.call span id as its parent."""
    pkgs = {"jax": (moolib_tpu, jt), "port": (moolib_tpu_torch, tt)}
    callee = "port" if caller == "jax" else "jax"
    (cpkg, ctel), (spkg, stel) = pkgs[caller], pkgs[callee]
    a, b = _rpc_pair(f"mix-{caller}", f"mix-{callee}", cpkg, spkg)
    try:
        with ctel.root_span("client.mixed") as root:
            ctx = root.context
            assert a.sync(f"mix-{callee}", "echo", 5) == 5
    finally:
        a.close()
        b.close()
    (call,) = _spans_for(ctx.trace_id, "rpc.call echo", pkg=ctel)
    (recv,) = _spans_for(ctx.trace_id, "rpc.recv echo", pkg=stel)
    assert call.parent_id == ctx.span_id
    assert recv.parent_id == call.span_id
    assert recv.trace_id == call.trace_id == ctx.trace_id
    assert recv.span_id not in (call.span_id, ctx.span_id)
