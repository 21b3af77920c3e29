"""Hierarchical data parallelism in the port: the in-mesh reduction over a
host's ``dp`` ranks (gloo subprocesses) under the elastic Accumulator
cohort across hosts — the port of ``tests/test_hierarchical_dp.py``.

- Two hosts x dp=2 ranks: each host's step reduces its ranks' gradients
  inside the mesh (``parallel.make_train_step(grad_spec=...)``), mesh rank
  0 gathers them and contributes to the sharded cohort round; the result
  equals the global-batch gradient within 2e-5 (the JAX test's seed, sizes
  and tolerance).  The same run holds the sharded plane's guard on real
  ``DTensor`` leaves: the same tree as plain tensors raises
  ``GradientShardingError``.
- ``examples.lm --mesh dp=2 --shard_grads --overlap_grads --attention
  flash --device cpu`` on two hosts reaches the copy-task bar of
  ``tests/test_torch_lm_elastic.py``, every rank of both hosts ends with
  the same parameters, and the cohort commits a distributed checkpoint.
"""

import ast
import json
import os
import subprocess
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from conftest import grab_port, subprocess_env

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HOST = r'''
import json, os, sys, time
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from moolib_tpu_torch import Accumulator, Broker, GradientShardingError, parallel as par
from moolib_tpu_torch.parallel.mesh import NamedSharding, PartitionSpec as P

host, rank, bport, dport, work = (int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                                  int(sys.argv[4]), sys.argv[5])
par.initialize_distributed(f"127.0.0.1:{dport}", 2, rank, device="cpu")
mesh = par.make_mesh({"dp": 2}, device_type="cpu")
data = np.load(os.path.join(work, "data.npz"))
w = torch.nn.Parameter(torch.from_numpy(data["w0"].copy()))
batch = {"x": torch.from_numpy(data["xs"][host]), "y": torch.from_numpy(data["ys"][host])}
loss_fn = lambda p, b, r: ((((b["x"] @ p["w"]) - b["y"]) ** 2).mean(), {})
step = par.make_train_step(loss_fn, mesh=mesh, grad_spec={"w": NamedSharding(mesh, P("dp", None))},
                           batch_spec=P("dp"))
_, _, grads = step({"w": w}, batch, None)
if rank != 0:
    par.gather_full(grads, dst=0)  # the host's Accumulator stages it on rank 0
    dist.destroy_process_group()
    sys.exit(0)
addr = f"127.0.0.1:{bport}"
broker = None
if host == 0:
    broker = Broker(); broker.set_name("broker"); broker.set_timeout(5.0); broker.listen(addr)
acc = Accumulator("hier", {"w": torch.from_numpy(data["w0"].copy())})
acc._rpc.set_name(f"host{host}"); acc._rpc.set_timeout(10); acc._rpc.listen("127.0.0.1:0")
acc.set_sharded_allreduce(True)
acc.connect(addr)
def pump(until, secs):
    d = time.time() + secs
    while time.time() < d:
        if broker is not None:
            broker.update()
        acc.update()
        if acc.wants_state():
            acc.set_state({})
        if until():
            return
        time.sleep(0.01)
    raise SystemExit("timed out")
pump(lambda: acc.connected() and len(acc._group.members()) == 2, 60)
acc.reduce_gradients(data["xs"].shape[1], grads)
pump(acc.has_gradients, 60)
out = {"w": acc.gradients()["w"].numpy().tolist(),
       "layout_sig": acc._sharded_layouts and [str(l.shard_sig) for l in acc._sharded_layouts.values()]}
acc.zero_gradients()
try:
    acc.reduce_gradients(8, {"w": torch.ones(8, 8)})
    out["typed_error"] = None
except GradientShardingError as e:
    out["typed_error"] = str(e)
json.dump(out, open(os.path.join(work, f"host{host}.json"), "w"))
time.sleep(1.0)  # the other host's last pumps
acc.close()
if broker is not None:
    broker.close()
dist.destroy_process_group()
'''


def test_hierarchical_equals_flat(tmp_path):
    D, B = 8, 8  # feature dim, per-host batch (the JAX test's)
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(D, D)).astype(np.float32)
    xs = rng.normal(size=(2, B, D)).astype(np.float32)
    ys = rng.normal(size=(2, B, D)).astype(np.float32)
    np.savez(tmp_path / "data.npz", w0=w0, xs=xs, ys=ys)
    flat = jax.grad(lambda p, x, y: jnp.mean((x @ p - y) ** 2))(
        jnp.asarray(w0), jnp.asarray(xs.reshape(-1, D)), jnp.asarray(ys.reshape(-1, D)))
    env = subprocess_env(ROOT)
    env["OMP_NUM_THREADS"] = "1"
    bport = grab_port()
    dports = [grab_port(), grab_port()]
    procs = [subprocess.Popen([sys.executable, "-c", HOST, str(h), str(r), str(bport),
                               str(dports[h]), str(tmp_path)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for h in range(2) for r in range(2)]
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            assert p.returncode == 0, out.decode()[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for h in range(2):
        got = json.load(open(tmp_path / f"host{h}.json"))
        np.testing.assert_allclose(np.asarray(got["w"], np.float32), np.asarray(flat),
                                   rtol=2e-5, atol=2e-5)
        assert got["layout_sig"] == ["((\"PartitionSpec('dp', None)\", (2, 1)),)"]
        assert got["typed_error"] and "sharding changed" in got["typed_error"]


def test_lm_two_mesh_hosts_shard_and_overlap_reach_the_copy_bar(tmp_path):
    """The bar of tests/test_torch_lm_elastic.py (loss clearly below the
    4.13 chance floor after 250 steps at its sizes), on two hosts of two
    gloo ranks each, hook-streamed gradients on the sharded plane."""
    port = grab_port()
    env = subprocess_env(ROOT)
    env["OMP_NUM_THREADS"] = "1"
    ckpt = tmp_path / "ckpt"
    common = [
        sys.executable, "-m", "moolib_tpu_torch.examples.lm",
        "--steps", "250", "--d_model", "32", "--seq_len", "32", "--batch_size", "8",
        "--layers", "2", "--heads", "2", "--attention", "flash", "--device", "cpu",
        "--mesh", "dp=2", "--shard_grads", "--overlap_grads", "--min_cohort", "2",
        "--log_interval", "50", "--checkpoint_dir", str(ckpt), "--checkpoint_interval", "2",
    ]
    logs = [open(tmp_path / f"h{r}.log", "w") for r in range(2)]
    procs = []
    try:
        for r in range(2):
            procs.append(subprocess.Popen(
                common + (["--address", f"127.0.0.1:{port}", "--local_name", "lm0"] if r == 0
                          else ["--connect", f"127.0.0.1:{port}", "--local_name", "lm1"]),
                stdout=logs[r], stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT))
        deadline = time.time() + 420
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in logs:
            f.close()
    outs = [(tmp_path / f"h{r}.log").read_text() for r in range(2)]
    finals = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"host {r} failed:\n{out[-3000:]}"
        final = ast.literal_eval([ln for ln in out.splitlines() if ln.startswith("{'steps'")][-1])
        finals.append(final)
        assert final["steps"] == 250 and final["loss"] < 3.6, (r, final["loss"])
        assert final["accumulator"]["sharded"] and final["reduces"] >= 100
        # Streaming rounds: every bucket but the last launched before it.
        assert final["accumulator"]["last_launch_leads"]
        assert [x["rank"] for x in final["ranks"]] == [0, 1]
    assert any("cohort=2" in o for o in outs)
    shas = {final["params_sha256"] for final in finals}
    shas |= {x["params_sha256"] for final in finals for x in final["ranks"]}
    assert len(shas) == 1, shas
    from moolib_tpu_torch.checkpoint import DistributedCheckpointer

    assert DistributedCheckpointer(str(ckpt)).latest_committed_step() is not None
    assert sum(final["checkpoint_stats"]["commits"] for final in finals) >= 1
