"""Tensor parallelism over ``tp`` in the port, against the JAX package.

- ``parallel.auto_shardings`` gives JAX's spec tree, leaf for leaf, for the
  LM at ``tp`` 2 and 4, ``dp2 x tp2`` and, composed with
  ``moe_shardings(base=)``, ``dp2 x tp2 x ep2``; and for ImpalaNet, whose
  conv kernels the port holds in torch's layout: their specs and
  ``buckets.sharding_signature`` read as the flax leaves' (JAX runs on the
  conftest's forced CPU devices).
- Four gloo ranks (subprocesses, one spawn for the module), f32, d_model
  64, 2 layers, weights converted from the flax tree:
  - the sharded ``forward`` within 2e-4 of ``model.apply`` (the JAX tests'
    tolerance) and ``generate_sharded`` emitting exactly the tokens of the
    JAX package's ``generate``, at ``tp=2`` and ``tp=4``, including 2
    heads over ``tp=4`` (every rank attends every head) and GQA (H 4, Hk
    2) over ``tp`` 2 and 4, with each rank holding its blocks only;
  - ``examples.lm_serve.serve(mesh=)`` over Rpc answering the JAX
    ``generate`` tokens, ranks 1-3 in ``lm_serve.follow``;
  - ``make_train_step`` over ``dp2 x tp2`` on the tensor-parallel LM
    (``params_sharding=auto_shardings``, and ``grad_spec=`` into the
    two-axis layout): the loss and every gathered gradient within 1e-4 of
    ``jax.value_and_grad``;
  - ``examples/lm.py``'s static mesh at ``--mesh dp=2,tp=2`` (parameters
    replicated over ``tp``, the JAX example's placement): the same loss and
    gradients.
- The vtrace learner at ``--mesh dp=2,tp=2`` keeps its ranks' replicated
  parameters equal and each ``tp`` block equal across ``dp``, and (marked
  slow) meets the JAX test's bar on Catch (mean return > -0.45).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from moolib_tpu import buckets as jbuckets
from moolib_tpu import parallel as jpar
from moolib_tpu.models import ImpalaNet as JNet
from moolib_tpu.models import transformer as jtf
from moolib_tpu_torch import buckets as tbuckets
from moolib_tpu_torch import parallel as tpar
from moolib_tpu_torch.models.convert import from_flax, impala_from_flax

from conftest import grab_port, subprocess_env

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM = dict(vocab_size=64, d_model=64, num_layers=2, max_len=64)
PROMPT, NEW = (2, 16), 8
TRAIN_B, TRAIN_T = 4, 16

# name -> (mesh axes, heads, kv heads, positions)
GEN_CASES = {
    "tp2_h4": ({"tp": 2}, 4, 4, "learned"),
    "tp2_gqa": ({"tp": 2}, 4, 2, "rotary"),
    "tp4_h4": ({"tp": 4}, 4, 4, "rotary"),
    "tp4_h2": ({"tp": 4}, 2, 2, "learned"),
    "tp4_gqa": ({"tp": 4}, 4, 2, "learned"),
}
SERVE = dict(heads=4, prompts=3)


def _flax_lm(heads, kv_heads=None, pos="learned", seed=1, moe=0):
    jm = jtf.TransformerLM(num_heads=heads, num_kv_heads=kv_heads, attention="dense",
                           dtype=jnp.float32, pos_embedding=pos, moe_num_experts=moe, **LM)
    toks = jnp.zeros((1, 8), jnp.int32)
    return jm, jm.init(jax.random.key(seed), toks)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _by_name(flax_specs, params, convert=from_flax):
    """Port names -> JAX specs, through the converter on a tree whose leaves
    carry their leaf index."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    idx = jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(l), i, np.int64) for i, l in enumerate(leaves)])
    specs = jax.tree_util.tree_leaves(flax_specs, is_leaf=lambda x: isinstance(x, jax.sharding.Sharding))
    flat = jax.tree_util.tree_leaves(params)
    out = {}
    for k, v in convert(idx).items():
        i = int(np.asarray(v).reshape(-1)[0])
        out[k] = (specs[i], np.shape(flat[i]))
    return out


@pytest.mark.parametrize("axes", [{"tp": 2}, {"tp": 4}, {"dp": 2, "tp": 2}])
def test_auto_shardings_match_jax_on_the_lm(axes):
    _, params = _flax_lm(4)
    n = int(np.prod(list(axes.values())))
    jmesh = jpar.make_mesh(axes, devices=jax.devices()[:n])
    want = _by_name(jpar.auto_shardings(params, jmesh), params)
    got = tpar.auto_shardings(from_flax(_np(params)), axes)
    assert set(got) == set(want)
    for k, (sh, _) in want.items():
        assert tuple(got[k].spec) == tuple(sh.spec), k
    assert sum("tp" in tuple(s.spec) for s in got.values()) >= 5  # the kernels shard


def test_auto_shardings_compose_with_moe_shardings_over_dp_tp_ep():
    axes = {"dp": 2, "tp": 2, "ep": 2}
    _, params = _flax_lm(4, moe=4)
    jmesh = jpar.make_mesh(axes, devices=jax.devices()[:8])
    want = _by_name(jpar.moe_shardings(params, jmesh, "ep",
                                       base=jpar.auto_shardings(params, jmesh)), params)
    sd = from_flax(_np(params))
    got = tpar.moe_shardings(sd, axes, "ep", base=tpar.auto_shardings(sd, axes))
    assert set(got) == set(want)
    for k, (sh, _) in want.items():
        assert tuple(got[k].spec) == tuple(sh.spec), k
    assert tuple(got["blocks.1.moe.w_in"].spec) == ("ep", None, None)
    assert tuple(got["blocks.0.qkv.kernel"].spec)[-1] == "tp"


@pytest.mark.parametrize("axes", [{"tp": 2}, {"dp": 2, "tp": 2}])
def test_auto_shardings_match_jax_on_impalanet(axes):
    """The conv kernels are [out, in, kh, kw] in the port and [kh, kw, in,
    out] in flax: the port's spec and sharding signature read as flax's,
    while the placements shard the torch dims."""
    jm = JNet(num_actions=3, channels=(16, 32), use_lstm=False, hidden_size=256,
              dtype=jnp.float32)
    T, B = 2, 2
    batch = {"state": jnp.zeros((T, B, 24, 24, 1), jnp.uint8),
             "reward": jnp.zeros((T, B)), "done": jnp.zeros((T, B), bool),
             "prev_action": jnp.zeros((T, B), jnp.int32)}
    params = jm.init(jax.random.key(0), batch, jm.initial_state(B))
    n = int(np.prod(list(axes.values())))
    jmesh = jpar.make_mesh(axes, devices=jax.devices()[:n])
    want = _by_name(jpar.auto_shardings(params, jmesh), params, impala_from_flax)
    sd = impala_from_flax(_np(params))
    got = tpar.auto_shardings(sd, axes)
    assert set(got) == set(want)
    convs = 0
    for k, (sh, flax_shape) in want.items():
        assert tuple(got[k].spec) == tuple(sh.spec), k
        assert tbuckets.sharding_signature(tuple(sd[k].shape), got[k]) == \
            jbuckets.sharding_signature(flax_shape, sh), k
        if sd[k].ndim == 4:
            convs += 1
            assert tuple(got[k].spec)[-1] == "tp", k
            block = got[k].shard_shape(tuple(sd[k].shape))
            assert block[0] == sd[k].shape[0] // axes["tp"], k  # torch's out channels
    assert convs >= 6


CHILD = r'''
import asyncio, json, os, sys, threading, time
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from moolib_tpu_torch import parallel as par
from moolib_tpu_torch.examples import lm, lm_serve
from moolib_tpu_torch.models.transformer import TransformerLM, generate_sharded
from moolib_tpu_torch.parallel import tensor_parallel as tpm

rank, dport, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
par.initialize_distributed(f"127.0.0.1:{dport}", 4, rank, device="cpu")
cfg = json.load(open(os.path.join(work, "cfg.json")))
meshes = {"tp2": par.make_mesh({"tp": 2}, ranks=[0, 1], device_type="cpu"),
          "tp4": par.make_mesh({"tp": 4}, device_type="cpu"),
          "dp2tp2": par.make_mesh({"dp": 2, "tp": 2}, device_type="cpu")}
out = {}

def model_of(name, heads, kv, pos, attention="flash"):
    m = TransformerLM(num_heads=heads, num_kv_heads=kv, pos_embedding=pos, attention=attention,
                      dtype=torch.float32, device="cpu", **cfg["lm"])
    m.load_state_dict(torch.load(os.path.join(work, f"{name}.pt")))
    return m

prompt = torch.from_numpy(np.load(os.path.join(work, "prompt.npy")))
for name, (axes, heads, kv, pos) in cfg["gen"].items():
    key = "tp2" if axes == {"tp": 2} else "tp4"
    if key == "tp2" and rank > 1:
        continue
    mesh = meshes[key]
    m = model_of(name, heads, kv, pos)
    whole = {k: v.clone() for k, v in m.state_dict().items()}
    tpm.shard_model(m, mesh)
    # The blocks, as DTensors of the whole shapes, gather back to the weights.
    named = tpm.tp_named(m)
    back = par.gather_full(named)
    if rank == 0:
        out[f"{name}_gathered_err"] = max((back[k] - whole[k]).abs().max().item() for k in whole)
        out[f"{name}_qkv_shapes"] = [list(named["blocks.0.qkv.kernel"].shape),
                                     list(named["blocks.0.qkv.kernel"].to_local().shape)]
    logits = m(prompt)
    toks = generate_sharded(m, prompt, cfg["new"], mesh)
    sampled = generate_sharded(m, prompt, 4, mesh, temperature=1.0,
                               generator=torch.Generator().manual_seed(3))
    out[name] = {"tokens": toks.tolist(), "sampled": sampled.tolist(),
                 "bytes": tpm.param_bytes(m),
                 "cache_kv_heads": m.cache_kv_heads()}
    if rank == 0:
        np.save(os.path.join(work, f"{name}_logits.npy"), logits.detach().numpy())

# serve(mesh=) over Rpc: rank 0 owns the queue, the others follow.
mesh = meshes["tp4"]
sm = model_of("serve", cfg["serve"]["heads"], None, "rotary", attention="dense")
prompts = np.load(os.path.join(work, "serve_prompts.npy"))
if rank == 0:
    from moolib_tpu_torch.rpc import Rpc
    server, client = Rpc(), Rpc()
    server.set_name("tp_server")
    server.listen(f"127.0.0.1:{cfg['rpc_port']}")
    client.set_name("tp_client")
    client.set_timeout(120)
    client.connect(f"127.0.0.1:{cfg['rpc_port']}")
    coro = lm_serve.serve(server, sm, cfg["new"], mesh=mesh, batch_size=4, total=len(prompts))
    futs = [client.async_("tp_server", "generate", p) for p in prompts]
    while client.sync("tp_server", "generate_stats")["depth_max"] < len(prompts):
        time.sleep(0.01)
    res = {}
    th = threading.Thread(target=lambda: res.setdefault("it", asyncio.run(coro)))
    th.start()
    replies = [np.asarray(f.result(120)).tolist() for f in futs]
    th.join(120)
    out["serve"] = {"replies": replies, "iterations": res.get("it")}
    client.close()
    server.close()
else:
    out["serve"] = {"followed": lm_serve.follow(sm, cfg["new"], mesh)}

# make_train_step over dp2 x tp2 on the tensor-parallel LM.
mesh = meshes["dp2tp2"]
tokens = torch.from_numpy(np.load(os.path.join(work, "train_tokens.npy")))
half = tokens.shape[1] // 2
tm = model_of("train", 4, None, "learned")
layout = par.auto_shardings(dict(tm.named_parameters()), mesh)
tpm.shard_model(tm, mesh, layout)
named = dict(tm.named_parameters())
loss_fn = lambda p, b, r: lm.copy_task_loss(tm(b), b, half)
step = par.make_train_step(loss_fn, torch.optim.SGD(named.values(), lr=0.0), mesh=mesh,
                           params_sharding=layout, batch_spec=par.PartitionSpec("dp", None))
loss, acc = step.grads(named, tokens, None)
out["train_loss"] = float(loss)
full = par.gather_full(tpm.as_dtensors(tm, {k: p.grad for k, p in named.items()}))
gstep = par.make_train_step(loss_fn, mesh=mesh, grad_spec=layout,
                            batch_spec=par.PartitionSpec("dp", None))
_, _, dgrads = gstep(named, tokens, None)
out["placements"] = {k: [[type(p).__name__, getattr(p, "dim", None)] for p in v.placements]
                     for k, v in dgrads.items()}
full_spec = par.gather_full(dgrads)
out["held_fraction"] = tpm.param_bytes(tm)
if rank == 0:
    np.savez(os.path.join(work, "train_grads.npz"), **{k: v.numpy() for k, v in full.items()})
    np.savez(os.path.join(work, "spec_grads.npz"), **{k: v.numpy() for k, v in full_spec.items()})

# The collectives on a leaf sharded over two axes, and a conv kernel's
# sharding read back from its DTensor in flax's order.
from moolib_tpu_torch import buckets
from moolib_tpu_torch.parallel.mesh import NamedSharding, PartitionSpec as P
whole = torch.arange(48.0).reshape(6, 8)
two = NamedSharding(mesh, P("dp", "tp"))
dt = par.redistribute({"a": whole}, two)["a"]
out["redist2_local"] = dt.to_local().tolist()
out["redist2_back"] = par.redistribute({"a": dt}, par.replicated(mesh))["a"].to_local().tolist()
out["scatter2"] = par.scatter_shards({"a": whole} if rank == 0 else None, {"a": whole},
                                     [two], mesh)[0].tolist()
kernel = torch.zeros(32, 16, 3, 3)
conv = par.redistribute({"k": kernel}, par.auto_shardings({"k": kernel}, mesh)["k"])["k"]
out["conv_local_shape"] = list(conv.to_local().shape)
out["conv_spec"] = list(par.sharding_of(conv).spec)
out["conv_signature"] = buckets.sharding_signature(tuple(kernel.shape), conv)

# examples/lm.py's static mesh at dp=2,tp=2: replicated over tp.
flags = lm.make_flags(["--mesh", "dp=2,tp=2", "--attention", "dense", "--device", "cpu",
                       "--seq_len", str(tokens.shape[1]), "--batch_size", str(tokens.shape[0]),
                       "--vocab", str(cfg["lm"]["vocab_size"]),
                       "--d_model", str(cfg["lm"]["d_model"]),
                       "--layers", str(cfg["lm"]["num_layers"]), "--heads", "4"])
lm._check_flags(flags)
rm = model_of("train", 4, None, "learned", attention="dense")
mp = lm._StaticMesh(flags, mesh, rm)
mp.make_step(lm.make_optimizer(rm.parameters(), 1e-3))
loss, acc = mp.mstep.grads(mp.named, mp.batch(tokens), None)
out["static_loss"] = float(loss)
if rank == 0:
    np.savez(os.path.join(work, "static_grads.npz"),
             **{k: p.grad.numpy() for k, p in mp.named.items()})
json.dump(out, open(os.path.join(work, f"out{rank}.json"), "w"))
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def tp_ranks(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("tp"))
    rng = np.random.default_rng(0)
    prompt = rng.integers(2, LM["vocab_size"], PROMPT).astype(np.int32)
    np.save(os.path.join(work, "prompt.npy"), prompt)
    refs = {}
    for name, (axes, heads, kv, pos) in GEN_CASES.items():
        jm, params = _flax_lm(heads, kv, pos)
        torch.save(from_flax(_np(params)), os.path.join(work, f"{name}.pt"))
        refs[name] = (jm, params)
    jm, params = _flax_lm(SERVE["heads"], pos="rotary", seed=2)
    torch.save(from_flax(_np(params)), os.path.join(work, "serve.pt"))
    refs["serve"] = (jm, params)
    serve_prompts = rng.integers(2, LM["vocab_size"], (SERVE["prompts"], PROMPT[1])).astype(np.int32)
    np.save(os.path.join(work, "serve_prompts.npy"), serve_prompts)
    jm, params = _flax_lm(4, seed=3)
    torch.save(from_flax(_np(params)), os.path.join(work, "train.pt"))
    refs["train"] = (jm, params)
    pre = rng.integers(2, LM["vocab_size"], (TRAIN_B, TRAIN_T // 2))
    tokens = np.concatenate([pre, pre], 1).astype(np.int32)
    np.save(os.path.join(work, "train_tokens.npy"), tokens)
    json.dump({"lm": LM, "new": NEW, "gen": GEN_CASES, "serve": SERVE, "rpc_port": grab_port()},
              open(os.path.join(work, "cfg.json"), "w"))
    dport = grab_port()
    env = subprocess_env(ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(r), str(dport), work],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(4)]
    try:
        for p in procs:
            o, _ = p.communicate(timeout=300)
            assert p.returncode == 0, o.decode()[-3000:]
    finally:
        for p in procs:
            p.kill()
    outs = [json.load(open(os.path.join(work, f"out{r}.json"))) for r in range(4)]
    return work, outs, refs, prompt, serve_prompts, tokens


@pytest.mark.parametrize("name", list(GEN_CASES))
def test_sharded_forward_matches_flax_apply(tp_ranks, name):
    work, _, refs, prompt, _, _ = tp_ranks
    jm, params = refs[name]
    want = np.asarray(jm.apply(params, jnp.asarray(prompt)))
    got = np.load(os.path.join(work, f"{name}_logits.npy"))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", list(GEN_CASES))
def test_generate_sharded_emits_the_jax_tokens(tp_ranks, name):
    _, outs, refs, prompt, _, _ = tp_ranks
    axes, heads, kv, _ = GEN_CASES[name]
    jm, params = refs[name]
    want = np.asarray(jtf.generate(jm, params, jnp.asarray(prompt), NEW))
    n = axes["tp"]
    for r in range(n):
        got = outs[r][name]
        np.testing.assert_array_equal(np.asarray(got["tokens"]), want, err_msg=f"rank {r}")
        assert got["sampled"] == outs[0][name]["sampled"]  # one draw on every rank
        assert np.asarray(got["sampled"]).shape == (PROMPT[0], PROMPT[1] + 4)
        # The rank holds its blocks: every big kernel cut n ways.
        b = got["bytes"]
        assert b["total"] < b["whole"] and abs(b["sharded"] * n + b["replicated"] - b["whole"]) == 0
        split = heads % n == 0 and (kv or heads) % n == 0
        assert got["cache_kv_heads"] == ((kv or heads) // n if split else (kv or heads))
    # Each rank holds its block of a kernel as a DTensor of the whole shape.
    assert outs[0][f"{name}_gathered_err"] == 0.0
    cols = (heads + 2 * (kv or heads)) * (LM["d_model"] // heads)
    assert outs[0][f"{name}_qkv_shapes"] == [[LM["d_model"], cols], [LM["d_model"], cols // n]]


def test_serve_over_a_tp_mesh_answers_the_jax_tokens(tp_ranks):
    _, outs, refs, _, serve_prompts, _ = tp_ranks
    jm, params = refs["serve"]
    want = np.asarray(jtf.generate(jm, params, jnp.asarray(serve_prompts), NEW))
    got = np.asarray(outs[0]["serve"]["replies"])
    np.testing.assert_array_equal(got, want)
    assert outs[0]["serve"]["iterations"] == 1  # one stacked batch
    assert all(o["serve"]["followed"] == 1 for o in outs[1:])  # the one batch


def _copy_loss(jm, tokens):
    half = tokens.shape[1] // 2

    def loss_fn(p):
        logits = jm.apply(p, jnp.asarray(tokens))
        pred, tgt = logits[:, half - 1: -1], jnp.asarray(tokens)[:, half:]
        logp = jax.nn.log_softmax(pred.astype(jnp.float32), axis=-1)
        return -jnp.take_along_axis(logp, tgt[..., None], axis=-1)[..., 0].mean()

    return loss_fn


@pytest.mark.parametrize("which", ["train_grads", "spec_grads", "static_grads"])
def test_dp2_tp2_train_step_matches_value_and_grad(tp_ranks, which):
    work, outs, refs, _, _, tokens = tp_ranks
    jm, params = refs["train"]
    jloss, jgrads = jax.jit(jax.value_and_grad(_copy_loss(jm, tokens)))(params)
    want = from_flax(_np(jgrads))
    got = dict(np.load(os.path.join(work, f"{which}.npz")))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k].numpy(), atol=1e-4, rtol=0, err_msg=k)
    key = "static_loss" if which == "static_grads" else "train_loss"
    for o in outs:
        assert abs(o[key] - float(jloss)) < 1e-4


def test_grad_spec_leaves_take_two_axis_placements(tp_ranks):
    _, outs, _, _, _, _ = tp_ranks
    pl = outs[0]["placements"]
    assert pl["blocks.0.qkv.kernel"] == [["Shard", 0], ["Shard", 1]]  # P("dp", "tp")
    assert pl["blocks.0.LayerNorm_0.scale"] == [["Replicate", None], ["Replicate", None]]
    b = outs[0]["held_fraction"]
    assert b["sharded"] * 2 + b["replicated"] == b["whole"]


def _vtrace_mesh(port: int, steps: int, monkeypatch) -> dict:
    from moolib_tpu_torch.examples.vtrace.experiment import make_flags, train

    # The spawned ranks inherit it: four rank processes with a thread pool
    # each would fight over the cores.
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    return train(make_flags([
        "--env", "catch", "--total_steps", str(steps), "--actor_batch_size", "16",
        "--batch_size", "4", "--virtual_batch_size", "4", "--num_env_processes", "2",
        "--address", f"127.0.0.1:{port}", "--entropy_cost", "0.005",
        "--mesh", "dp=2,tp=2", "--device", "cpu", "--quiet"]))


def _check_ranks(ranks: list) -> None:
    """Replicated leaves equal on every rank; each tp block equal across dp
    (rank 0's blocks, cut from its whole network, included)."""
    assert len(ranks) == 4
    assert len({r["replicated_sha256"] for r in ranks}) == 1
    for t in (0, 1):
        assert len({r["params_sha256"] for r in ranks if r["coords"]["tp"] == t}) == 1
    assert ranks[0]["params_sha256"] != ranks[1]["params_sha256"]  # different tp blocks


def test_collectives_take_a_leaf_sharded_over_two_axes(tp_ranks):
    """``redistribute`` onto and off ``P("dp", "tp")``, ``scatter_shards``
    of it, and a conv kernel's DTensor read back as flax's spec
    (``P(None, None, "dp", "tp")`` on [kh, kw, in, out]) while it holds
    torch's [out/2, in/2, kh, kw] block."""
    _, outs, _, _, _, _ = tp_ranks
    whole = np.arange(48.0).reshape(6, 8)
    jmesh = jpar.make_mesh({"dp": 2, "tp": 2}, devices=jax.devices()[:4])
    want_sig = jbuckets.sharding_signature(
        (3, 3, 16, 32), jax.sharding.NamedSharding(jmesh, jax.sharding.PartitionSpec(
            None, None, "dp", "tp")))
    for r, o in enumerate(outs):
        dp, tp = divmod(r, 2)
        block = whole[dp * 3:(dp + 1) * 3, tp * 4:(tp + 1) * 4]
        np.testing.assert_array_equal(np.asarray(o["redist2_local"]), block)
        np.testing.assert_array_equal(np.asarray(o["scatter2"]), block)
        np.testing.assert_array_equal(np.asarray(o["redist2_back"]), whole)
        assert o["conv_local_shape"] == [16, 8, 3, 3]
        assert o["conv_spec"] == [None, None, "dp", "tp"]
        assert tuple(o["conv_signature"][0:1]) == (want_sig[0],)
        assert tuple(o["conv_signature"][1]) == tuple(want_sig[1])


def test_impala_dp2_tp2_mesh_learner_keeps_its_blocks_in_step(free_port, monkeypatch):
    """``--mesh dp=2,tp=2``: this process is rank 0 and spawns ranks 1-3;
    after every apply the ranks' replicated leaves are one and each tp
    block is one across dp."""
    out = _vtrace_mesh(free_port, 2000, monkeypatch)
    assert out["sgd_steps"] > 0
    _check_ranks(out["ranks"])


@pytest.mark.slow
def test_impala_learns_under_dp_tp_mesh(free_port, monkeypatch):
    """The JAX package's ``test_impala_learns_under_dp_tp_mesh`` flags and
    bar on four rank processes (this one is rank 0).  Slow: ~94 s alone on
    the CPU (744 SGD steps, each a broadcast, a gather and an apply over the
    four gloo ranks)."""
    out = _vtrace_mesh(free_port, 60000, monkeypatch)
    assert out["steps"] >= 60000
    assert out["sgd_steps"] > 100
    assert out["mean_episode_return"] is not None
    assert out["mean_episode_return"] > -0.45, f"no learning: {out}"
    _check_ranks(out["ranks"])
