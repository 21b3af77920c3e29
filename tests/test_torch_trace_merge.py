"""The port's ``moolib_tpu_torch.scripts.trace_merge`` against the JAX
package's ``scripts/trace_merge.py``: the same merged events and stats on
``tests/test_trace_merge.py``'s three synthetic exports (A calls into B, C
never exchanged an RPC) in both of its cases (skew correction on, with a
residual offset, and off), the ``--require-edges`` gate of the CLI, a
merge of one JAX and one port host trace from a real mixed call, and every
flag and default of the four JAX observability scripts kept by their port
twins."""

import ast
import copy
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import trace_merge as jax_trace_merge  # noqa: E402

import moolib_tpu  # noqa: E402
import moolib_tpu_torch  # noqa: E402
from moolib_tpu import telemetry as jt  # noqa: E402
from moolib_tpu_torch import telemetry as tt  # noqa: E402
from moolib_tpu_torch.scripts import mtop, timeline_smoke, trace_merge, trace_smoke  # noqa: E402

US = 1000  # ns per µs


def _trace_file(tmp_path, name, pid, events, perf_origin_ns=0):
    """One exported host trace, as tests/test_trace_merge.py writes it."""
    path = tmp_path / name / "host_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    data = {
        "traceEvents": [dict(ev, pid=pid, tid=1, ph="X", ts=ev["ts"] + perf_origin_ns / US)
                        for ev in events],
        "metadata": {"clock_sync": {"unix_time_ns": 2_000_000_000_000_000_000,
                                    "perf_counter_ns": perf_origin_ns}},
    }
    path.write_text(json.dumps(data))
    return str(path)


def _exports(tmp_path, b_extra_us=0.0):
    a = _trace_file(tmp_path, "proc-a", 100, [
        {"name": "rpc.call", "ts": 1000.0, "dur": 400.0,
         "args": {"span_id": "s-call", "trace_id": "t1"}}])
    b = _trace_file(tmp_path, "proc-b", 200, [
        {"name": "rpc.recv", "ts": 1100.0 + b_extra_us, "dur": 200.0,
         "args": {"span_id": "s-recv", "parent_id": "s-call", "trace_id": "t1"}}],
        perf_origin_ns=5_000_000)
    c = _trace_file(tmp_path, "proc-c", 300, [
        {"name": "env.step", "ts": 500.0, "dur": 100.0,
         "args": {"span_id": "s-env", "trace_id": "t2"}}])
    return [a, b, c]


@pytest.mark.parametrize("skew_correct,b_extra_us", [(True, 0.0), (True, 300.0), (False, 300.0)])
def test_merge_equals_the_jax_merge(tmp_path, skew_correct, b_extra_us):
    paths = _exports(tmp_path, b_extra_us)
    got = trace_merge.merge(paths, skew_correct=skew_correct)
    want = jax_trace_merge.merge(paths, skew_correct=skew_correct)
    assert got == want
    merged, stats = got
    assert stats["files"] == 3
    assert stats["cross_process_edges"] == 1
    if skew_correct:
        assert stats["anchor_only"] == ["300"]
        assert stats["skew_offsets_us"]["200"] == pytest.approx(b_extra_us, abs=1.0)
    else:
        assert stats["skew_offsets_us"] == {} and stats["anchor_only_pids"] == 3
    assert {"s", "f"} <= {e["ph"] for e in merged["traceEvents"]}


def test_merge_helpers_equal_the_jax_helpers(tmp_path):
    """load_trace, _rebase, cross_edges and skew_offsets one by one."""
    paths = _exports(tmp_path, 300.0)
    events = []
    for p in paths:
        ev, sync = trace_merge.load_trace(p)
        assert (ev, sync) == jax_trace_merge.load_trace(p)
        mine, theirs = copy.deepcopy(ev), copy.deepcopy(ev)
        trace_merge._rebase(mine, sync)
        jax_trace_merge._rebase(theirs, sync)
        assert mine == theirs
        events += mine
    edges = trace_merge.cross_edges(events)
    assert edges == jax_trace_merge.cross_edges(events) and len(edges) == 1
    assert trace_merge.skew_offsets(edges, 100) == jax_trace_merge.skew_offsets(edges, 100)


def test_merge_cli_require_edges_gate(tmp_path):
    solo = _trace_file(tmp_path, "proc-solo", 300, [
        {"name": "env.step", "ts": 500.0, "dur": 100.0,
         "args": {"span_id": "s-env", "trace_id": "t2"}}])
    out = str(tmp_path / "merged.json")
    assert trace_merge.main([solo, "--out", out]) == 0
    assert os.path.exists(out)
    assert trace_merge.main([solo, "--out", out, "--require-edges", "1"]) == 1
    # The module runs as a CLI and prints the stats line.
    res = subprocess.run([sys.executable, "-m", "moolib_tpu_torch.scripts.trace_merge", "--out",
                          out, "--require-edges", "1"] + _exports(tmp_path),
                         capture_output=True, text=True, cwd=ROOT, timeout=60)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.splitlines()[-1])["cross_process_edges"] == 1


@pytest.mark.parametrize("caller", ["jax", "port"])
def test_merge_of_a_real_mixed_call_has_the_edge(tmp_path, caller):
    """A traced call between a JAX Rpc and a port Rpc in one process: each
    package exports its own host trace, and the port's merge of the two
    links the caller's rpc.call span to the callee's rpc.recv span (both
    files carry this pid, so the merge gives the second its own track)."""
    pkgs = {"jax": (moolib_tpu, jt), "port": (moolib_tpu_torch, tt)}
    callee = "port" if caller == "jax" else "jax"
    (cpkg, ctel), (spkg, stel) = pkgs[caller], pkgs[callee]
    a, b = cpkg.Rpc(), spkg.Rpc()
    a.set_name(f"mrg-{caller}")
    b.set_name(f"mrg-{callee}")
    b.define("echo", lambda x: x)
    b.listen("127.0.0.1:0")
    a.connect(next(x for x in b._listen_addrs if x.startswith("tcp://127")))
    try:
        with ctel.root_span("client.mixed") as root:
            trace_id = f"{root.context.trace_id:032x}"
            assert a.sync(f"mrg-{callee}", "echo", 1) == 1
    finally:
        a.close()
        b.close()
    paths = []
    for name, tel in ((caller, ctel), (callee, stel)):
        d = tmp_path / name
        d.mkdir()
        paths.append(tel.get_tracer().export_chrome_trace(str(d / "host_trace.json")))
    merged, stats = trace_merge.merge(paths)
    assert (merged, stats) == jax_trace_merge.merge(paths)
    edges = [(p, c) for p, c in trace_merge.cross_edges(merged["traceEvents"])
             if c["args"]["trace_id"] == trace_id]
    assert [(p["name"], c["name"]) for p, c in edges] == [("rpc.call echo", "rpc.recv echo")]
    assert stats["cross_process_edges"] >= 1


def _flag_defaults(path: str) -> dict:
    """``--flag`` -> the literal default of every ``add_argument`` call."""
    out = {}
    for node in ast.walk(ast.parse(open(path).read())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument" and node.args
                and isinstance(node.args[0], ast.Constant)):
            kw = {k.arg: k.value for k in node.keywords}
            if "default" in kw:
                out[node.args[0].value] = ast.literal_eval(kw["default"])
            else:
                action = kw.get("action")
                switch = isinstance(action, ast.Constant) and action.value == "store_true"
                out[node.args[0].value] = False if switch else None
    return out


@pytest.mark.parametrize("module", [trace_merge, trace_smoke, mtop, timeline_smoke],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_every_jax_flag_and_default_is_kept(module):
    name = module.__name__.rsplit(".", 1)[1]
    want = _flag_defaults(os.path.join(ROOT, "scripts", f"{name}.py"))
    got = _flag_defaults(module.__file__)
    for flag, default in want.items():
        assert flag in got, f"{name}: the port has no {flag}"
        assert got[flag] == default, f"{name} {flag}: {got[flag]!r} != {default!r}"
    # The port adds only --device (and internal worker plumbing).
    assert set(got) - set(want) <= {"--device", "--pg-port"}
