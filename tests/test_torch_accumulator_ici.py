"""The Accumulator's collective plane in the port: ``set_ici_backend`` over
``torch.distributed`` (gloo here; NCCL on cards), held in two-rank process
groups of subprocesses on the CPU.

- the collective result equals the RPC plane's, bit for bit;
- a cohort that stops matching the process group (a third peer joins)
  falls back to the RPC plane, and returns to the collective when it
  matches again;
- a wedged collective (one rank's worker never enters it) is aborted by
  the unanimous no-progress proposal, the plane is suspended for the epoch
  and the round rides the RPC plane;
- a collective stranded by a member that left the cohort is dropped with
  its epoch, and the survivor (one member, world 2) reduces on the RPC
  plane.

The card machine has one H100, and NCCL refuses two ranks on one card, so
NCCL itself is exercised only where a deployment has a card per rank.
"""

import json
import os
import subprocess
import sys
import time

import pytest

from conftest import grab_port, subprocess_env

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r'''
import json, os, sys, time
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from moolib_tpu_torch import Accumulator, Broker

mode, rank, port, dport = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
addr = f"127.0.0.1:{port}"
broker = None
if rank == 0:
    broker = Broker(); broker.set_name("broker"); broker.set_timeout(5.0); broker.listen(addr)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{dport}", world_size=2, rank=rank)

def make(name):
    a = Accumulator("m", {"w": torch.zeros(3, 2), "b": torch.zeros(2)})
    a._rpc.set_name(name); a._rpc.set_timeout(10); a._rpc.listen("127.0.0.1:0")
    a._group.set_timeout(20)
    a.set_ici_backend(True)
    a.connect(addr)
    return a

accs = [make(f"rank{rank}")]
def pump(until, secs):
    d = time.time() + secs
    while time.time() < d:
        if broker is not None:
            broker.update()
        for a in accs:
            a.update()
            if a.wants_state():
                a.set_state({})
        if until():
            return True
        time.sleep(0.005)
    raise SystemExit(f"timed out in {mode}")

def members(n):
    return lambda: all(a.connected() and len(a._group.members()) == n for a in accs)

def grads(k):
    return {"w": torch.full((3, 2), float(k)), "b": torch.arange(2.0) * k}

def round_(values):
    for a, v in zip(accs, values):
        a.reduce_gradients(4, grads(v))
    pump(lambda: all(a.has_gradients() for a in accs), 60)
    out = []
    for a in accs:
        g = a.gradients()
        out.append({"w": g["w"].numpy().tolist(), "b": g["b"].numpy().tolist(),
                    "stats": a.get_gradient_stats(), "plane": a.debug_info()["last_plane"]})
        a.zero_gradients()
    return out

res = {}
pump(members(2), 60)
if mode == "equal":
    res["ici"] = round_([rank + 1])
    for a in accs:
        a.set_ici_backend(False)
    res["rpc"] = round_([rank + 1])
    res["eligible"] = accs[0].debug_info()["ici_eligible"]
elif mode == "fallback":
    res["before"] = round_([rank + 1])
    if rank == 1:
        accs.append(make("extra"))
    pump(members(3), 60)
    res["joined"] = round_([rank + 1] + ([10] if rank == 1 else []))
    if rank == 1:
        accs.pop().close()
    pump(members(2), 60)
    res["after"] = round_([rank + 1])
elif mode == "wedge":
    a = accs[0]
    a.set_ici_progress_bound(1.0)
    res["first"] = round_([rank + 1])  # warms the collective
    if rank == 1:
        # This rank's collective worker never enters the all_reduce.
        a._ici_allreduce = lambda flat, round_=None: time.sleep(3600)
    a.reduce_gradients(4, grads(rank + 1))
    pump(lambda: a.debug_info()["ici_aborts"] == 1, 60)
    res["aborted"] = a.debug_info()
    res["retry"] = round_([rank + 1])
elif mode == "stranded":
    a = accs[0]
    res["first"] = round_([rank + 1])
    if rank == 1:
        # Wedge this rank's collective, then leave the cohort: rank 0's
        # collective is stranded with a member gone.
        a._ici_allreduce = lambda flat, round_=None: time.sleep(3600)
        a.reduce_gradients(4, grads(rank + 1))
        time.sleep(1.0)
        a._group.leave()
        print("RESULT " + json.dumps(res), flush=True)
        os._exit(0)
    a.reduce_gradients(4, grads(rank + 1))
    pump(lambda: len(a._group.members()) == 1 and not a._inflight, 60)
    res["after_leave"] = a.debug_info()
    res["solo"] = round_([rank + 1])
print("RESULT " + json.dumps(res), flush=True)
os._exit(0)  # an abandoned collective thread may still be blocked
'''


def _run(mode):
    port, dport = grab_port(), grab_port()
    env = subprocess_env(ROOT)
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, mode, str(r), str(port), str(dport)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=ROOT)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    res = []
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
        line = [l for l in out.splitlines() if l.startswith("RESULT ")][-1]
        res.append(json.loads(line[len("RESULT "):]))
    return res


def test_collective_result_equals_the_rpc_plane():
    r0, r1 = _run("equal")
    for r in (r0, r1):
        assert r["ici"][0]["plane"] == "ici" and r["rpc"][0]["plane"] == "rpc"
        for key in ("w", "b", "stats"):
            assert r["ici"][0][key] == r["rpc"][0][key]
        assert r["ici"][0]["w"] == [[1.5, 1.5]] * 3  # mean of 1 and 2
        assert r["ici"][0]["stats"] == {"num_gradients": 2, "num_skipped": 0, "batch_size": 8}
    assert r0["ici"] == r1["ici"]


def test_epoch_change_falls_back_to_the_rpc_plane():
    r0, r1 = _run("fallback")
    for r in (r0, r1):
        assert [x["plane"] for x in r["before"]] == ["ici"]
        assert {x["plane"] for x in r["joined"]} == {"rpc"}  # 3 members != world 2
        assert [x["plane"] for x in r["after"]] == ["ici"]
    assert abs(r0["joined"][0]["w"][0][0] - 13 / 3) < 1e-6  # mean of 1, 2 and 10
    assert r0["joined"][0]["stats"]["num_gradients"] == 3


def test_wedged_collective_is_aborted_unanimously():
    r0, r1 = _run("wedge")
    for r in (r0, r1):
        assert r["first"][0]["plane"] == "ici"
        assert r["aborted"]["ici_aborts"] == 1 and r["aborted"]["ici_suspended"]
        assert r["retry"][0]["plane"] == "rpc"
        assert r["retry"][0]["stats"]["num_gradients"] == 2
        assert r["retry"][0]["w"] == [[1.5, 1.5]] * 3


def test_collective_stranded_by_a_leaving_member_falls_back():
    r0, r1 = _run("stranded")
    assert r1["first"][0]["plane"] == "ici"
    assert r0["first"][0]["plane"] == "ici"
    assert not r0["after_leave"]["ici_eligible"]  # 1 member != world 2
    assert r0["solo"][0]["plane"] == "rpc"
    assert r0["solo"][0]["stats"]["num_gradients"] == 1
    assert r0["solo"][0]["w"] == [[1.0, 1.0]] * 3
