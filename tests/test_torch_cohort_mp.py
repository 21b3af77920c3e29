"""Model-parallel mesh axes inside the elastic cohort (ROADMAP slice 9e),
against the JAX package on the CPU.

- ``parallel.make_train_step(grad_spec="params")``, the hierarchical
  learner's in-mesh half, on ``sp=2`` (ring attention), ``dp=2,ep=2``
  (Switch MoE), ``pp=2`` (the pipeline) and ``dp=2,tp=2`` (the
  tensor-parallel LM), in the layout of ``examples.lm``'s mesh host
  (``host_layout``): the gradients gathered on mesh rank 0 are within 1e-4
  of ``jax.value_and_grad`` of the flax LM on the whole batch (the
  tolerance of slices 9b and 9d).  Its ``overlap_grads=True`` form streams
  the same gradients bit for bit (every sum adds two ranks an axis), and
  so does the optimizer path's ``step.grads`` where a leaf's sum runs over
  one axis (over two, it adds the same terms in one all-reduce, in
  another order: within a few ulps).  Four gloo ranks
  (subprocesses) run the four meshes; the two-rank meshes use ranks 0-1.
- ``examples.lm --mesh sp=2 --attention ring --shard_grads`` on two
  elastic hosts, with and without ``--overlap_grads``: every rank of both
  hosts ends with the same parameters, within 1e-4 of one process taking
  the same steps on the same batches.
- ``examples.vtrace.experiment``'s mesh learner with ``sp=2`` (T=5, so
  T+1=6), with and without the LSTM, and with ``dp=2,sp=2``: one learn
  step's gradients are within 1e-5 of the JAX ``raw_grad`` on the whole
  batch (the Sebulba learner's tolerance); ``(unroll_length + 1) % sp``
  is refused with the JAX message.

Sizes: 2 blocks, ``d_model`` 32; every rank runs with one thread.
"""

import ast
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from moolib_tpu.models import transformer as jtf
from moolib_tpu_torch.models.convert import from_flax

from conftest import grab_port, subprocess_env

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM = dict(vocab_size=2048, d_model=32, num_heads=2, num_layers=2, max_len=16)
B, T, E, AUX_W = 4, 16, 4, 0.01

# name: (--mesh, ranks, attention, MoE experts)
MESHES = {
    "sp2": ("sp=2", 2, "ring", 0),
    "dp2ep2": ("dp=2,ep=2", 4, "dense", E),
    "pp2": ("pp=2", 2, "dense", 0),
    "dp2tp2": ("dp=2,tp=2", 4, "dense", 0),
}

STEP_CHILD = r'''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from moolib_tpu_torch import buckets, parallel as par
from moolib_tpu_torch.examples import lm
from moolib_tpu_torch.models.transformer import TransformerLM
from moolib_tpu_torch.parallel import tensor_parallel

rank, dport, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
par.initialize_distributed(f"127.0.0.1:{dport}", 4, rank, device="cpu")
cfg = json.load(open(os.path.join(work, "cfg.json")))
tokens = torch.from_numpy(np.load(os.path.join(work, "tokens.npy")))
buckets.set_bucket_bytes(1 << 12)  # several runs of leaves at this width
meshes = {name: par.make_mesh(par.mesh.parse_axes(spec), ranks=range(n), device_type="cpu")
          for name, (spec, n, _, _) in cfg["meshes"].items()}
out = {}


def whole(tree, held, full_shapes):
    """A {name: tensor} tree in full on mesh rank 0 (held blocks gathered)."""
    got = par.gather_full({k: (par.collectives._dtensor(v, held[k], full_shapes[k])
                               if k in held else v) for k, v in tree.items()})
    return None if got is None else {k: v.detach().numpy() for k, v in got.items()}


for name, (spec, n, attention, experts) in cfg["meshes"].items():
    if rank >= n:
        continue
    mesh = meshes[name]
    flags = lm.make_flags(["--mesh", spec, "--attention", attention, "--device", "cpu",
                           "--moe_experts", str(experts), "--moe_aux_weight", str(cfg["AUX_W"]),
                           "--seq_len", str(cfg["T"]), "--batch_size", str(cfg["B"]),
                           "--vocab", str(cfg["vocab_size"]), "--d_model", str(cfg["d_model"]),
                           "--layers", str(cfg["num_layers"]), "--heads", str(cfg["num_heads"])])
    model = TransformerLM(dtype=torch.float32, device="cpu", attention=attention,
                          moe_num_experts=experts,
                          **{k: cfg[k] for k in ("vocab_size", "d_model", "num_heads",
                                                 "num_layers", "max_len")})
    model.load_state_dict(torch.load(os.path.join(work, f"sd_{'moe' if experts else 'lm'}.pt")))
    full_shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    if "tp" in spec:
        tensor_parallel.shard_model(model, mesh)
    mp = lm._StaticMesh(flags, mesh, model)
    layout = lm.host_layout(mp.named, full_shapes, mesh, mp.shardings)
    held = {k: lm._only(sh, ("ep", "tp")) for k, sh in layout.items()
            if {"ep", "tp"} & set(sh.spec)}
    bspec = par.PartitionSpec("dp", "sp" if attention == "ring" else None)
    batch = mp.batch(tokens)
    barrier = par.make_train_step(mp.loss_fn, mesh=mesh, params_sharding=layout,
                                  grad_spec="params", batch_spec=bspec)
    loss, acc, grads = barrier(mp.named, batch, None)
    full = par.gather_full(grads, dst=0)
    overlap = par.make_train_step(mp.loss_fn, mesh=mesh, params_sharding=layout,
                                  grad_spec="params", batch_spec=bspec, overlap_grads=True)
    oloss, _, stream = overlap(mp.named, batch, None)
    log = [list(e[:3]) for e in overlap.inner.log]
    ostep = par.make_train_step(mp.loss_fn, optimizer=lm.make_optimizer(mp.named.values(), 1e-3),
                                mesh=mesh, params_sharding=layout, batch_spec=bspec)
    ploss, _ = ostep.grads(mp.named, batch, None)
    opt_grads = whole({k: p.grad for k, p in mp.named.items()}, held, full_shapes)
    out[name] = {"log": log, "loss": float(loss), "overlap_loss": float(oloss),
                 "opt_loss": float(ploss), "runs": len(log), "held": sorted(held)}
    if rank == 0:
        streamed, names = {}, sorted(mp.named)
        while True:
            c = stream.next_chunk(10)
            if c is None:
                break
            lo, leaves = c
            for i, leaf in enumerate(leaves, start=lo):
                streamed[names[i]] = np.asarray(leaf)
        np.savez(os.path.join(work, f"{name}_barrier.npz"),
                 **{k: v.detach().numpy() for k, v in full.items()})
        np.savez(os.path.join(work, f"{name}_stream.npz"), **streamed)
        np.savez(os.path.join(work, f"{name}_opt.npz"), **opt_grads)
        out[name]["shardings"] = {k: str(par.sharding_of(v).spec) for k, v in grads.items()}
    else:
        assert stream is None
json.dump(out, open(os.path.join(work, f"out{rank}.json"), "w"))
dist.destroy_process_group()
'''


def _flax_lms():
    """The flax LM (dense) and its MoE twin, their weights, and a copy-task
    batch: [B, T] with each row's second half repeating its first."""
    half = T // 2
    prefix = np.random.default_rng(11).integers(2, LM["vocab_size"], (B, half))
    tokens = np.concatenate([prefix, prefix], 1).astype(np.int32)
    dense = jtf.TransformerLM(attention="dense", dtype=jnp.float32, **LM)
    moe = jtf.TransformerLM(attention="dense", dtype=jnp.float32, moe_num_experts=E, **LM)
    pd = {"params": dense.init(jax.random.key(7), jnp.asarray(tokens))["params"]}
    pm = {"params": moe.init(jax.random.key(8), jnp.asarray(tokens))["params"]}
    return (dense, pd), (moe, pm), tokens


def _jax_grads(jm, params, tokens):
    """``jax.value_and_grad`` of the copy-task loss (plus the MoE aux
    losses) on the whole batch, named as the port's parameters."""
    half = T // 2

    def loss_fn(p):
        logits, col = jm.apply(p, jnp.asarray(tokens), mutable=["losses"])
        aux = sum(jnp.sum(jnp.asarray(v)) for v in jax.tree_util.tree_leaves(col.get("losses", {})))
        pred, tgt = logits[:, half - 1: -1], jnp.asarray(tokens)[:, half:]
        logp = jax.nn.log_softmax(pred.astype(jnp.float32), axis=-1)
        ll = jnp.take_along_axis(logp, tgt[..., None], axis=-1)[..., 0]
        return -ll.mean() + AUX_W * aux

    loss, g = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), {k: v.numpy() for k, v in
                         from_flax(jax.tree_util.tree_map(np.asarray, g)).items()}


def _run_ranks(child, n, args, work, timeout):
    dport = grab_port()
    env = subprocess_env(ROOT)
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, "-c", child, str(r), str(dport), *args],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(n)]
    try:
        for proc in procs:
            o, _ = proc.communicate(timeout=timeout)
            assert proc.returncode == 0, o.decode()[-3000:]
    finally:
        for proc in procs:
            proc.kill()


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("cohort_mp"))
    (dense, pd), (moe, pm), tokens = _flax_lms()
    for tag, p in (("lm", pd), ("moe", pm)):
        torch.save(from_flax(jax.tree_util.tree_map(np.asarray, p)),
                   os.path.join(work, f"sd_{tag}.pt"))
    np.save(os.path.join(work, "tokens.npy"), tokens)
    json.dump(dict(LM, B=B, T=T, AUX_W=AUX_W, meshes=MESHES),
              open(os.path.join(work, "cfg.json"), "w"))
    t0 = time.time()
    _run_ranks(STEP_CHILD, 4, [work], work, timeout=240)
    outs = [json.load(open(os.path.join(work, f"out{r}.json"))) for r in range(4)]
    refs = {"lm": _jax_grads(dense, pd, tokens), "moe": _jax_grads(moe, pm, tokens)}
    return work, outs, refs, time.time() - t0


@pytest.mark.parametrize("overlap", [False, True], ids=["barrier", "overlap"])
@pytest.mark.parametrize("name", list(MESHES))
def test_grad_spec_step_matches_jax(steps, name, overlap):
    """The hierarchical step's gradients (mesh rank 0, in full) and its
    global loss against the flax LM on the whole batch."""
    work, outs, refs, _ = steps
    jloss, want = refs["moe" if MESHES[name][3] else "lm"]
    got = dict(np.load(os.path.join(work, f"{name}_{'stream' if overlap else 'barrier'}.npz")))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=0, err_msg=f"{name} {k}")
    for r in range(MESHES[name][1]):
        o = outs[r][name]
        assert abs((o["overlap_loss"] if overlap else o["loss"]) - jloss) < 1e-4, (r, o)


@pytest.mark.parametrize("name", list(MESHES))
def test_overlap_and_optimizer_paths_equal_the_barrier_bitwise(steps, name):
    """One reduction for the three forms: the hook-streamed gradients equal
    the barrier's bit for bit, and so does the optimizer path's reduced
    ``.grad`` where a leaf's sum runs over one axis (where it runs over two,
    the optimizer path's one all-reduce adds the same four terms in another
    order: within OPT_SUM_ULPS of the leaf's largest element);
    every rank fired the same runs in the same order, all from inside the
    backward; the held leaves come back in the host layout's shardings."""
    work, outs, _, _ = steps
    barrier = dict(np.load(os.path.join(work, f"{name}_barrier.npz")))
    stream = dict(np.load(os.path.join(work, f"{name}_stream.npz")))
    opt = dict(np.load(os.path.join(work, f"{name}_opt.npz")))
    assert set(stream) == set(opt) == set(barrier)
    two_axes = "," in MESHES[name][0]
    for k in barrier:
        assert stream[k].tobytes() == barrier[k].tobytes(), (name, "stream", k)
        if two_axes and k not in outs[0][name]["held"]:
            # Summed over both axes in one all-reduce: the same four terms,
            # added in another order.
            np.testing.assert_allclose(opt[k], barrier[k], rtol=0, err_msg=f"{name} opt {k}",
                                       atol=OPT_SUM_ULPS * np.spacing(np.abs(barrier[k]).max()))
        else:
            assert opt[k].tobytes() == barrier[k].tobytes(), (name, "opt", k)
    logs = [outs[r][name]["log"] for r in range(MESHES[name][1])]
    assert all(log == logs[0] for log in logs) and len(logs[0]) >= 2, logs
    assert all(in_bwd for _, _, in_bwd in logs[0])
    for r in range(MESHES[name][1]):
        o = outs[r][name]
        assert o["loss"] == o["overlap_loss"] == o["opt_loss"], o
    specs = outs[0][name]["shardings"]
    if "ep" in name:
        assert all("'ep'" in specs[k] for k in specs if k.endswith((".w_in", ".w_out"))), specs
    if "tp" in name:
        assert "'tp'" in specs["lm_head.kernel"], specs
    if "dp" in name:
        assert any("'dp'" in s for s in specs.values()), specs


# A sum of four f32 terms in two orders differs by the rounding of its
# partial sums: at most 1 ulp of the leaf's largest element at these widths
# on the CPU (dp2ep2, dp2tp2); 8 leave room for another gloo ring order.
OPT_SUM_ULPS = 8

HOST_STEPS = 6
HOST_ARGS = ["--vocab", "64", "--d_model", "32", "--layers", "2", "--heads", "2",
             "--seq_len", "16", "--batch_size", "4", "--learning_rate", "1e-3",
             "--device", "cpu", "--seed", "3", "--steps", str(HOST_STEPS), "--log_interval", "1"]
# Every process of the run builds the LM in f32 (the example's default is
# bf16 compute, whose rounding would swamp the comparison).
F32_LM = """
import torch
from moolib_tpu_torch.models import transformer as _t
_init = _t.TransformerLM.__init__
def _f32(self, *a, dtype=torch.float32, **k):
    _init(self, *a, dtype=dtype, **k)
_t.TransformerLM.__init__ = _f32
"""


def _one_process(argv):
    """One process taking the cohort's steps: host 0 applies its first
    batch alone; then each step is the mean of host 0's next batch and host
    1's (both draw from the same seeded stream after their warm-up's batch,
    host 1 one batch behind: it joined after host 0's first step).
    Returns the model and its parameters after each step."""
    from moolib_tpu_torch.examples import lm

    flags = lm.make_flags(argv + ["--mesh", "", "--attention", "dense"])
    model = lm.make_model(flags, "cpu")
    named = dict(model.named_parameters())
    opt = lm.make_optimizer(model.parameters(), flags.learning_rate)
    rng = np.random.default_rng(flags.seed)
    lm.make_batch(rng, flags)  # the warm-up's batch
    batches = [torch.from_numpy(lm.make_batch(rng, flags)) for _ in range(HOST_STEPS)]
    half = flags.seq_len // 2

    def grads(tokens):
        model.zero_grad(set_to_none=True)
        lm.copy_task_loss(model(tokens), tokens, half)[0].backward()
        return {k: p.grad.clone() for k, p in named.items()}

    after = [{k: p.detach().clone() for k, p in named.items()}]
    for k in range(HOST_STEPS):
        gs = [grads(batches[0])] if k == 0 else [grads(batches[k]), grads(batches[k - 1])]
        for name, p in named.items():
            p.grad = sum(g[name] for g in gs) / len(gs)
        opt.step()
        after.append({k: p.detach().clone() for k, p in named.items()})
    return model, flags, after


@pytest.mark.parametrize("overlap", [False, True], ids=["barrier", "overlap"])
def test_two_sp_hosts_train_as_one_process(tmp_path, monkeypatch, overlap):
    """``examples.lm --mesh sp=2 --attention ring --shard_grads`` on two
    elastic hosts: host 0 steps alone, host 1 joins and takes the model;
    every rank of both hosts ends with one set of parameters, and the
    cohort's last committed distributed checkpoint holds the one process's
    parameters at its step within 1e-4, and its logits on a probe batch.
    The key third of each ``qkv.bias`` is left out of the parameters: its
    gradient is zero (softmax is shift-invariant), so AdamW moves it by the
    sign of rounding noise, which differs between any two reduction orders
    (the logits cannot see it)."""
    port = grab_port()
    env = subprocess_env(ROOT)
    env["OMP_NUM_THREADS"] = "1"
    (tmp_path / "sitecustomize.py").write_text(F32_LM)
    env["PYTHONPATH"] = os.pathsep.join([str(tmp_path), env["PYTHONPATH"]])
    ckpt = tmp_path / "ckpt"
    common = [sys.executable, "-m", "moolib_tpu_torch.examples.lm", *HOST_ARGS,
              "--mesh", "sp=2", "--attention", "ring", "--shard_grads", "--min_cohort", "2",
              "--checkpoint_dir", str(ckpt), "--checkpoint_interval", "0.001"]
    common += ["--overlap_grads"] if overlap else []
    logs = [tmp_path / f"h{r}.log" for r in range(2)]
    procs = []
    try:
        with open(logs[0], "w") as f:
            procs.append(subprocess.Popen(
                common + ["--address", f"127.0.0.1:{port}", "--local_name", "h0"],
                stdout=f, stderr=subprocess.STDOUT, env=env, cwd=ROOT))
        deadline = time.time() + 120
        while not re.search(r"^step=1 ", logs[0].read_text(), re.M):
            assert procs[0].poll() is None and time.time() < deadline, logs[0].read_text()[-3000:]
            time.sleep(0.2)
        with open(logs[1], "w") as f:
            procs.append(subprocess.Popen(
                common + ["--connect", f"127.0.0.1:{port}", "--local_name", "h1"],
                stdout=f, stderr=subprocess.STDOUT, env=env, cwd=ROOT))
        for p in procs:
            p.wait(timeout=max(1.0, deadline + 60 - time.time()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    finals = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        out = log.read_text()
        assert p.returncode == 0, f"host {r} failed:\n{out[-3000:]}"
        final = ast.literal_eval([ln for ln in out.splitlines() if ln.startswith("{'steps'")][-1])
        assert final["steps"] == HOST_STEPS and final["accumulator"]["sharded"], final
        assert [x["coords"] for x in final["ranks"]] == [{"sp": 0}, {"sp": 1}]
        finals.append(final)
    assert finals[1]["recovery"]["model_sync_bytes_rx"] > 0
    shas = {f["params_sha256"] for f in finals} | {x["params_sha256"] for f in finals
                                                   for x in f["ranks"]}
    assert len(shas) == 1, shas
    from moolib_tpu_torch.checkpoint import DistributedCheckpointer
    from moolib_tpu_torch.examples import lm
    from moolib_tpu_torch.models import transformer

    step, (params, _, _) = DistributedCheckpointer(str(ckpt)).restore()
    assert 2 <= step <= HOST_STEPS  # a step of the two-host cohort
    init = transformer.TransformerLM.__init__
    monkeypatch.setattr(transformer.TransformerLM, "__init__",
                        lambda self, *a, dtype=torch.float32, **k: init(self, *a, dtype=dtype, **k))
    model, flags, after = _one_process(list(HOST_ARGS))
    want = after[step]
    assert set(params) == set(want)
    d = flags.d_model
    for k in want:
        got, ref = torch.as_tensor(np.asarray(params[k])), want[k]
        if k.endswith("qkv.bias"):
            got, ref = torch.cat([got[:d], got[2 * d:]]), torch.cat([ref[:d], ref[2 * d:]])
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4, rtol=0, err_msg=k)
    probe = torch.from_numpy(lm.make_batch(np.random.default_rng(99), flags))
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(torch.as_tensor(np.asarray(params[k])))
        cohort = model(probe)
        for k, p in model.named_parameters():
            p.copy_(want[k])
        np.testing.assert_allclose(cohort.numpy(), model(probe).numpy(), atol=1e-4, rtol=0)


# The vtrace learner's sp axis: (--mesh, ranks, LSTM).
LEARNERS = {"sp2": ("sp=2", 2, False), "sp2_lstm": ("sp=2", 2, True),
            "dp2sp2_lstm": ("dp=2,sp=2", 4, True)}
RL = dict(T1=6, B=4, OBS=(12, 12, 2), A=3, HIDDEN=32)
RL_FLAGS = dict(discounting=0.99, baseline_cost=0.5, entropy_cost=0.01)

LEARNER_CHILD = r'''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from moolib_tpu_torch import parallel as par
from moolib_tpu_torch.examples.vtrace import experiment
from moolib_tpu_torch.models.impala import ImpalaNet

rank, dport, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
par.initialize_distributed(f"127.0.0.1:{dport}", 4, rank, device="cpu")
cfg = json.load(open(os.path.join(work, "cfg.json")))
rl = cfg["RL"]
meshes = {name: par.make_mesh(par.mesh.parse_axes(spec), ranks=range(n), device_type="cpu")
          for name, (spec, n, _) in cfg["learners"].items()}
data = np.load(os.path.join(work, "batch.npz"))
batch = {k: torch.from_numpy(data[k]) for k in ("state", "reward", "done", "prev_action",
                                                 "action", "policy_logits")}
out = {}
for name, (spec, n, lstm) in cfg["learners"].items():
    if rank >= n:
        continue
    mesh = meshes[name]
    flags = experiment.make_flags(["--mesh", spec, "--unroll_length", str(rl["T1"] - 1),
                                   "--batch_size", str(rl["B"]), "--device", "cpu"]
                                  + (["--use_lstm"] if lstm else []))
    for k, v in cfg["FLAGS"].items():
        flags[k] = v
    model = ImpalaNet(rl["A"], obs_shape=rl["OBS"], channels=(16, 32), use_lstm=lstm,
                      hidden_size=rl["HIDDEN"], dtype=torch.float32, device="cpu")
    model.load_state_dict(torch.load(os.path.join(work, f"impala_{int(lstm)}.pt")))
    named = dict(model.named_parameters())
    host = experiment._MeshLearner(flags, mesh, model, experiment.make_optimizer(
        model.parameters(), flags), named, torch.device("cpu"))
    core = tuple(torch.from_numpy(data[f"core{i}"]) for i in range(2)) if lstm else ()
    loss, aux, grads = host.learn(batch if rank == 0 else None, core if rank == 0 else None)
    full = par.gather_full(grads, dst=0)
    out[name] = {"loss": float(loss), "sp_block": int(host.learner.sp is not None)}
    if full is not None:
        np.savez(os.path.join(work, f"{name}_grads.npz"),
                 **{k: v.detach().numpy() for k, v in full.items()})
json.dump(out, open(os.path.join(work, f"learner_out{rank}.json"), "w"))
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def learners(tmp_path_factory):
    from moolib_tpu.models import ImpalaNet as JNet
    from moolib_tpu_torch.models.convert import impala_from_flax

    work = str(tmp_path_factory.mktemp("cohort_mp_rl"))
    rng = np.random.default_rng(21)
    T1, Bn, A = RL["T1"], RL["B"], RL["A"]
    batch = {"state": rng.integers(0, 256, (T1, Bn, *RL["OBS"])).astype(np.uint8),
             "reward": rng.normal(size=(T1, Bn)).astype(np.float32),
             "done": rng.random((T1, Bn)) < 0.2,
             "prev_action": rng.integers(0, A, (T1, Bn)).astype(np.int32),
             "action": rng.integers(0, A, (T1, Bn)).astype(np.int32),
             "policy_logits": rng.normal(size=(T1, Bn, A)).astype(np.float32),
             "core0": rng.normal(size=(Bn, RL["HIDDEN"])).astype(np.float32),
             "core1": rng.normal(size=(Bn, RL["HIDDEN"])).astype(np.float32)}
    np.savez(os.path.join(work, "batch.npz"), **batch)
    nets = {}
    for lstm in (False, True):
        jm = JNet(num_actions=A, channels=(16, 32), use_lstm=lstm, hidden_size=RL["HIDDEN"],
                  dtype=jnp.float32)
        x = {k: jnp.asarray(batch[k][:1]) for k in ("state", "reward", "done", "prev_action")}
        params = jax.device_get(jm.init(jax.random.key(1 + lstm), x, jm.initial_state(Bn)))
        torch.save(impala_from_flax(params), os.path.join(work, f"impala_{int(lstm)}.pt"))
        nets[lstm] = (jm, params)
    json.dump(dict(RL=RL, FLAGS=RL_FLAGS, learners=LEARNERS),
              open(os.path.join(work, "cfg.json"), "w"))
    _run_ranks(LEARNER_CHILD, 4, [work], work, timeout=240)
    outs = [json.load(open(os.path.join(work, f"learner_out{r}.json"))) for r in range(4)]
    return work, outs, nets, batch


@pytest.mark.parametrize("name", list(LEARNERS))
def test_vtrace_sp_learner_matches_jax_raw_grad(learners, name):
    """One learn step of the mesh learner (each sp rank's encoder on its
    block of the T+1 steps, the core, heads and V-trace on the whole
    unroll), gathered on rank 0: within 1e-5 of the JAX example's
    ``raw_grad`` on the whole batch; every rank reports the global loss."""
    import types

    from moolib_tpu.examples.vtrace import experiment as jexp
    from moolib_tpu_torch.models.convert import impala_from_flax

    work, outs, nets, batch = learners
    spec, n, lstm = LEARNERS[name]
    jm, params = nets[lstm]
    jb = {k: jnp.asarray(batch[k]) for k in ("state", "reward", "done", "prev_action",
                                              "action", "policy_logits")}
    core = (jnp.asarray(batch["core0"]), jnp.asarray(batch["core1"])) if lstm else ()
    flags = types.SimpleNamespace(**RL_FLAGS)
    (jloss, _), grads = jax.value_and_grad(
        lambda p: jexp.compute_loss(p, jb, core, jm, flags), has_aux=True)(params)
    want = impala_from_flax(jax.device_get(grads))
    got = np.load(os.path.join(work, f"{name}_grads.npz"))
    assert set(got.files) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v.numpy(), atol=1e-5, rtol=1e-5, err_msg=f"{name} {k}")
    for r in range(n):
        assert abs(outs[r][name]["loss"] - float(jloss)) < 1e-5, (r, outs[r][name])
        assert outs[r][name]["sp_block"]


@pytest.mark.parametrize("unroll,mesh", [(20, "sp=2"), (5, "dp=2,sp=4")])
def test_vtrace_sp_must_divide_the_unroll(unroll, mesh):
    """The JAX example's rule and message: ``sp`` cuts the T+1 steps."""
    from moolib_tpu_torch.examples.vtrace import experiment

    with pytest.raises(ValueError, match=re.escape(
            "the sp mesh axis size must divide unroll_length+1")):
        experiment.train(experiment.make_flags(["--mesh", mesh, "--unroll_length", str(unroll),
                                                "--device", "cpu", "--batch_size", "8"]))
