"""Switch MoE over ``ep`` against the JAX package's ``SwitchMoE``.

Four gloo ranks (subprocesses, one spawn for the module); JAX runs its
global forms on the same numpy inputs and weights (f32):

- ``SwitchMoE`` alone on ``dp=2 x ep=2`` (each rank its ``dp`` block of the
  tokens and its ``ep`` block of the experts): output, aux loss and every
  gradient within 1e-5.  The input overflows the capacity, and routing
  each ``dp`` block on its own (its own count and capacity) would drop
  other tokens, so the match proves the routing is global;
- a MoE ``TransformerLM`` (every second block) on ``ep=2`` and on
  ``dp=2 x ep=2`` through the example's model-parallel step: the global
  loss (task loss plus the aux losses) and every reduced gradient within
  1e-4 of the flax model's, the experts' gathered from their ``ep`` blocks;
- ``moe_shardings`` shards the expert leaves over ``ep`` as JAX's does, and
  ``generate()`` refuses a MoE model as JAX's does.
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

from moolib_tpu import parallel as jpar
from moolib_tpu.models import transformer as jtf
from moolib_tpu_torch import parallel as tpar
from moolib_tpu_torch.models import transformer as ttf
from moolib_tpu_torch.models.convert import from_flax

from conftest import grab_port, subprocess_env

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E, F, D, CAP = 4, 16, 8, 1.0
LM = dict(vocab_size=64, d_model=16, num_heads=2, num_layers=2, max_len=16)
LM_B, LM_T, AUX_W = 4, 16, 0.01


def _moe_input():
    """[4, 16, D] tokens and a flax SwitchMoE whose router sends most
    tokens of the first two rows to expert 0: the global capacity (16)
    overflows there, while each dp block alone (capacity 8) would keep a
    different set."""
    jm = jpar.SwitchMoE(num_experts=E, ffn_dim=F, dtype=jnp.float32, capacity_factor=CAP)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 16, D)).astype(np.float32)
    x[:2, :, 0] += 3.0  # rows 0-1 lean to one expert
    params = jax.tree_util.tree_map(np.array, jm.init(jax.random.key(2), jnp.asarray(x)))
    params["params"]["router"]["kernel"][0] = np.array([2.0, -1.0, -1.0, -1.0], np.float32)
    coef = rng.normal(size=x.shape).astype(np.float32)
    return jm, params, x, coef


CHILD = r'''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from moolib_tpu_torch import parallel as par
from moolib_tpu_torch.examples import lm
from moolib_tpu_torch.models.transformer import TransformerLM
from moolib_tpu_torch.parallel.moe import SwitchMoE, shard_experts

rank, dport, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
par.initialize_distributed(f"127.0.0.1:{dport}", 4, rank, device="cpu")
dpep = par.make_mesh({"dp": 2, "ep": 2}, device_type="cpu")
ep2 = par.make_mesh({"ep": 2}, ranks=[0, 1], device_type="cpu")
cfg = json.load(open(os.path.join(work, "cfg.json")))
data = np.load(os.path.join(work, "moe.npz"))
out = {}

# SwitchMoE alone on dp=2 x ep=2.
E, F, D = cfg["E"], cfg["F"], cfg["D"]
m = SwitchMoE(D, E, F, capacity_factor=cfg["CAP"], dtype=torch.float32, device="cpu")
with torch.no_grad():
    for k in ("router.kernel", "router.bias", "w_in", "w_out"):
        m.get_parameter(k).copy_(torch.from_numpy(data[k]))
shard_experts(m, dpep)
dp, ep = dpep.get_local_rank("dp"), dpep.get_local_rank("ep")
x = torch.from_numpy(data["x"][2 * dp: 2 * dp + 2]).requires_grad_()
coef = torch.from_numpy(data["coef"][2 * dp: 2 * dp + 2])
y, aux = m(x, dpep)
# The convention: this rank's share of sum(y * coef) + aux, counted once
# over the ep ranks that hold the same tokens.
((y * coef).sum() / 2 + aux / 4).backward()
np.savez(os.path.join(work, f"moe_r{rank}.npz"), y=y.detach().numpy(), aux=aux.detach().numpy(),
         dx=x.grad.numpy(), **{k: p.grad.numpy() for k, p in m.named_parameters()})
out["dropped"] = int(m.last_dropped)

# The MoE LM through the example's step, on ep=2 (ranks 0-1) and dp=2 x ep=2.
sd = torch.load(os.path.join(work, "lm_sd.pt"))
tokens = torch.from_numpy(np.load(os.path.join(work, "lm_tokens.npy")))
for name, spec, mesh in (("ep2", "ep=2", ep2), ("dp2ep2", "dp=2,ep=2", dpep)):
    if rank >= 2 and name == "ep2":
        continue
    flags = lm.make_flags(["--mesh", spec, "--attention", "dense", "--device", "cpu",
                           "--moe_experts", str(cfg["E"]), "--moe_aux_weight", str(cfg["AUX_W"]),
                           "--seq_len", str(cfg["T"]), "--batch_size", str(cfg["B"]),
                           "--vocab", str(cfg["vocab_size"]), "--d_model", str(cfg["d_model"]),
                           "--layers", str(cfg["num_layers"]), "--heads", str(cfg["num_heads"])])
    model = TransformerLM(dtype=torch.float32, device="cpu", moe_num_experts=cfg["E"],
                          **{k: cfg[k] for k in ("vocab_size", "d_model", "num_heads",
                                                 "num_layers", "max_len")})
    model.load_state_dict(sd)
    mp = lm._StaticMesh(flags, mesh, model)
    mp.make_step(lm.make_optimizer(model.parameters(), 1e-3))
    loss, acc = mp.mstep.grads(mp.named, mp.batch(tokens), None)
    out[f"{name}_loss"] = float(loss)
    out[f"{name}_experts"] = mp.experts
    np.savez(os.path.join(work, f"{name}_r{rank}.npz"),
             **{k: p.grad.numpy() for k, p in mp.named.items()})
json.dump(out, open(os.path.join(work, f"out{rank}.json"), "w"))
dist.destroy_process_group()
'''


def _lm_flax():
    jm = jtf.TransformerLM(attention="dense", dtype=jnp.float32, moe_num_experts=E, **LM)
    half = LM_T // 2
    prefix = np.random.default_rng(5).integers(2, LM["vocab_size"], (LM_B, half))
    tokens = np.concatenate([prefix, prefix], 1).astype(np.int32)
    params = {"params": jm.init(jax.random.key(4), jnp.asarray(tokens))["params"]}
    return jm, params, tokens


@pytest.fixture(scope="module")
def moe_ranks(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("moe"))
    jm, params, x, coef = _moe_input()
    p = params["params"]
    np.savez(os.path.join(work, "moe.npz"), x=x, coef=coef, **{
        "router.kernel": p["router"]["kernel"], "router.bias": p["router"]["bias"],
        "w_in": p["w_in"], "w_out": p["w_out"]})
    ljm, lparams, tokens = _lm_flax()
    torch.save(from_flax(jax.tree_util.tree_map(np.asarray, lparams)),
               os.path.join(work, "lm_sd.pt"))
    np.save(os.path.join(work, "lm_tokens.npy"), tokens)
    json.dump(dict(LM, E=E, F=F, D=D, CAP=CAP, B=LM_B, T=LM_T, AUX_W=AUX_W),
              open(os.path.join(work, "cfg.json"), "w"))
    dport = grab_port()
    env = subprocess_env(ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(r), str(dport), work],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(4)]
    try:
        for proc in procs:
            o, _ = proc.communicate(timeout=240)
            assert proc.returncode == 0, o.decode()[-3000:]
    finally:
        for proc in procs:
            proc.kill()
    outs = [json.load(open(os.path.join(work, f"out{r}.json"))) for r in range(4)]
    return work, (jm, params, x, coef), (ljm, lparams, tokens), outs


def test_switch_moe_on_dp_ep_matches_jax(moe_ranks):
    work, (jm, params, x, coef), _, outs = moe_ranks

    def loss(p, x):
        y, aux = jm.apply(p, x)
        return jnp.sum(y * coef) + aux, (y, aux)

    (_, (jy, jaux)), (jg, jdx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    jg = jax.tree_util.tree_map(np.asarray, jg["params"])
    got = [np.load(os.path.join(work, f"moe_r{r}.npz")) for r in range(4)]
    for r, g in enumerate(got):  # rank = dp * 2 + ep
        dp = r // 2
        np.testing.assert_allclose(g["y"], np.asarray(jy)[2 * dp: 2 * dp + 2], atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(g["aux"], np.asarray(jaux), atol=1e-6, rtol=0)
    # Gradients: each leaf summed over the ranks that hold a replica of it.
    router = sum(g["router.kernel"] for g in got)
    np.testing.assert_allclose(router, jg["router"]["kernel"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(sum(g["router.bias"] for g in got), jg["router"]["bias"],
                               atol=1e-5, rtol=0)
    for leaf in ("w_in", "w_out"):
        per_ep = [got[e][leaf] + got[2 + e][leaf] for e in range(2)]  # summed over dp
        np.testing.assert_allclose(np.concatenate(per_ep), jg[leaf], atol=1e-5, rtol=0)
    dx = [got[2 * d]["dx"] + got[2 * d + 1]["dx"] for d in range(2)]  # summed over ep
    np.testing.assert_allclose(np.concatenate(dx), np.asarray(jdx), atol=1e-5, rtol=0)
    # Capacity overflowed, and routing each dp block alone would not drop
    # the same tokens: the global routing is what matched.
    assert outs[0]["dropped"] > 0
    local = [np.asarray(jm.apply(params, jnp.asarray(x[2 * d: 2 * d + 2]))[0]) for d in range(2)]
    assert not np.allclose(np.concatenate(local), np.asarray(jy), atol=1e-5)


def _jax_lm_grads(jm, params, tokens):
    half = LM_T // 2

    def loss_fn(p):
        logits, col = jm.apply(p, jnp.asarray(tokens), mutable=["losses"])
        aux = sum(jnp.sum(jnp.asarray(v)) for v in jax.tree_util.tree_leaves(col["losses"]))
        pred, tgt = logits[:, half - 1: -1], jnp.asarray(tokens)[:, half:]
        logp = jax.nn.log_softmax(pred.astype(jnp.float32), axis=-1)
        ll = jnp.take_along_axis(logp, tgt[..., None], axis=-1)[..., 0]
        return -ll.mean() + AUX_W * aux

    loss, g = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), from_flax(jax.tree_util.tree_map(np.asarray, g))


@pytest.mark.parametrize("name,ranks", [("ep2", [[0, 1]]), ("dp2ep2", [[0, 1], [2, 3]])])
def test_moe_lm_matches_flax(moe_ranks, name, ranks):
    """``ranks``: the ep groups (one per dp rank); a leaf's gradient is the
    same on every rank after the step's reduction, the experts' per ep
    block."""
    work, _, (ljm, lparams, tokens), outs = moe_ranks
    jloss, want = _jax_lm_grads(ljm, lparams, tokens)
    experts = set(outs[0][f"{name}_experts"])
    assert experts == {k for k in want if k.endswith((".w_in", ".w_out"))}
    for group in ranks:
        got = [dict(np.load(os.path.join(work, f"{name}_r{r}.npz"))) for r in group]
        for k in want:
            g = np.concatenate([x[k] for x in got]) if k in experts else got[0][k]
            np.testing.assert_allclose(g, want[k].numpy(), atol=1e-4, rtol=0,
                                       err_msg=f"{name} {k}")
            if k not in experts:
                np.testing.assert_array_equal(got[1][k], got[0][k])
        for r in group:
            assert abs(outs[r][f"{name}_loss"] - jloss) < 1e-4


def test_moe_shardings_shard_the_experts_as_jax():
    jm, params, tokens = _lm_flax()
    jmesh = jpar.make_mesh({"dp": 2, "ep": 2}, devices=jax.devices()[:4])
    jsh = jpar.moe_shardings(params, jmesh, "ep")
    flat = jax.tree_util.tree_flatten_with_path(jsh)[0]
    want = {}
    for path, sh in flat:
        keys = [str(getattr(p, "key", "")) for p in path][1:]
        if keys[0].startswith("block"):
            keys = ["blocks", keys[0][5:]] + keys[1:]
        want[".".join(keys)] = tuple(sh.spec)
    model = ttf.TransformerLM(dtype=torch.float32, device="cpu", moe_num_experts=E, **LM)
    got = tpar.moe_shardings(dict(model.named_parameters()), {"dp": 2, "ep": 2}, "ep")
    assert set(got) == set(want)
    for k, sh in got.items():
        assert tuple(sh.spec) == want[k], k
    assert tpar.moe_param_spec("ep")["w_in"] == tpar.PartitionSpec("ep", None, None)
    with pytest.raises(ValueError, match="does not support MoE"):
        ttf.generate(model, torch.zeros((1, 2), dtype=torch.int64), 2)
