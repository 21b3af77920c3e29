"""The GPipe/circular pipeline over ``pp`` against the JAX package's
``pipeline_apply`` and ``pipeline_lm_apply`` (mirroring
``tests/test_parallel_extras.py``'s pipeline tests).

Four gloo ranks (subprocesses, one spawn for the module); JAX runs its
global forms on the conftest's forced CPU devices, same inputs (f32):

- GPipe on ``pp=2`` and the circular schedule on ``pp=2`` with ``v=2``
  and ``v=3``, the batch sharded over ``dp`` (``data_axis="dp"``), with and
  without ``remat`` (and the "dots" policy): outputs and the gradient of
  the stage weights within 1e-5 of ``jax.grad`` through JAX's pipeline;
- ``pipeline_lm_apply`` on ``dp=2 x pp=2`` (4 blocks, ``v=2``, 4
  microbatches) through the example's model-parallel step: the global loss
  and every reduced gradient within 1e-4 of ``jax.value_and_grad`` through
  JAX's ``pipeline_lm_apply``;
- the shape errors, word for word, without a process group.
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
from moolib_tpu_torch.models.convert import from_flax
from moolib_tpu_torch.parallel.pipeline import pipeline_apply

from conftest import grab_port, subprocess_env

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM = 8
# name -> (mesh, v, M, B, data_axis, remat, policy)
CASES = {
    "gpipe_pp2": ("pp2", 1, 3, 2, None, False, None),
    "circular_v2_dp": ("dp2pp2", 2, 4, 4, "dp", False, None),
    "circular_v3_dp_remat": ("dp2pp2", 3, 4, 4, "dp", True, None),
    "circular_v3_dp_remat_dots": ("dp2pp2", 3, 4, 4, "dp", True, "dots"),
}
LM = dict(vocab_size=64, d_model=16, num_heads=2, num_layers=4, max_len=16)
LM_B, LM_T, LM_V, LM_M = 8, 16, 2, 4


def _arrays(name):
    _, v, m, b, _, _, _ = CASES[name]
    rng = np.random.default_rng(len(name))
    ws = (rng.normal(size=(2 * v, DIM, DIM)) * 0.4).astype(np.float32)
    xs = rng.normal(size=(m, b, DIM)).astype(np.float32)
    tgt = rng.normal(size=(m, b, DIM)).astype(np.float32)
    return ws, xs, tgt


CHILD = r'''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from moolib_tpu_torch import parallel as par
from moolib_tpu_torch.examples import lm
from moolib_tpu_torch.models.transformer import TransformerLM
from moolib_tpu_torch.parallel.pipeline import pipeline_apply

rank, dport, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
par.initialize_distributed(f"127.0.0.1:{dport}", 4, rank, device="cpu")
meshes = {"dp2pp2": par.make_mesh({"dp": 2, "pp": 2}, device_type="cpu"),
          "pp2": par.make_mesh({"pp": 2}, ranks=[0, 1], device_type="cpu")}
cases = json.load(open(os.path.join(work, "cases.json")))
data = np.load(os.path.join(work, "cases.npz"))
for name, (mesh_name, v, m, b, data_axis, remat, policy) in cases.items():
    if mesh_name == "pp2" and rank >= 2:
        continue
    mesh = meshes[mesh_name]
    ws = torch.from_numpy(data[f"{name}/ws"]).requires_grad_()
    xs, tgt = (torch.from_numpy(data[f"{name}/{k}"]) for k in ("xs", "tgt"))
    n = tgt.numel()
    if data_axis:
        d, nd = mesh.get_local_rank("dp"), 2
        xs, tgt = xs.chunk(nd, 1)[d], tgt.chunk(nd, 1)[d]
    out = pipeline_apply(lambda w, x: torch.tanh(x @ w), ws, xs, mesh, "pp", data_axis, v,
                         remat, policy)
    # This rank's share of mean((out - tgt)^2), counted once over pp.
    (((out - tgt) ** 2).sum() / n / 2).backward()
    np.savez(os.path.join(work, f"{name}_r{rank}.npz"), out=out.detach().numpy(),
             g=ws.grad.numpy())

cfg = json.load(open(os.path.join(work, "lm.json")))
flags = lm.make_flags(["--mesh", "dp=2,pp=2", "--attention", "dense", "--device", "cpu",
                       "--seq_len", str(cfg["T"]), "--batch_size", str(cfg["B"]),
                       "--vocab", str(cfg["vocab_size"]), "--d_model", str(cfg["d_model"]),
                       "--layers", str(cfg["num_layers"]), "--heads", str(cfg["num_heads"]),
                       "--pp_repeats", str(cfg["V"]), "--microbatches", str(cfg["M"])])
model = TransformerLM(dtype=torch.float32, device="cpu", attention="dense",
                      **{k: cfg[k] for k in ("vocab_size", "d_model", "num_heads",
                                             "num_layers", "max_len")})
model.load_state_dict(torch.load(os.path.join(work, "lm_sd.pt")))
mp = lm._StaticMesh(flags, meshes["dp2pp2"], model)
mp.make_step(lm.make_optimizer(model.parameters(), 1e-3))
tokens = torch.from_numpy(np.load(os.path.join(work, "lm_tokens.npy")))
loss, acc = mp.mstep.grads(mp.named, mp.batch(tokens), None)
np.savez(os.path.join(work, f"lm_r{rank}.npz"), **{k: p.grad.numpy() for k, p in mp.named.items()})
json.dump({"loss": float(loss)}, open(os.path.join(work, f"out{rank}.json"), "w"))
dist.destroy_process_group()
'''


def _lm_flax():
    jm = jtf.TransformerLM(attention="dense", dtype=jnp.float32, **LM)
    half = LM_T // 2
    prefix = np.random.default_rng(6).integers(2, LM["vocab_size"], (LM_B, half))
    tokens = np.concatenate([prefix, prefix], 1).astype(np.int32)
    params = jm.init(jax.random.key(3), jnp.asarray(tokens))
    return jm, params, tokens


@pytest.fixture(scope="module")
def pipe_ranks(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("pipe"))
    json.dump(CASES, open(os.path.join(work, "cases.json"), "w"))
    np.savez(os.path.join(work, "cases.npz"), **{
        f"{n}/{k}": a for n in CASES for k, a in zip(("ws", "xs", "tgt"), _arrays(n))})
    jm, params, tokens = _lm_flax()
    torch.save(from_flax(jax.tree_util.tree_map(np.asarray, params)),
               os.path.join(work, "lm_sd.pt"))
    np.save(os.path.join(work, "lm_tokens.npy"), tokens)
    json.dump(dict(LM, B=LM_B, T=LM_T, V=LM_V, M=LM_M), open(os.path.join(work, "lm.json"), "w"))
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
    return work, (jm, params, tokens), outs


@pytest.mark.parametrize("name", list(CASES))
def test_pipeline_apply_matches_jax(pipe_ranks, name):
    work, _, _ = pipe_ranks
    mesh_name, v, _, _, data_axis, remat, policy = CASES[name]
    ws, xs, tgt = _arrays(name)
    axes = {"pp": 2, "dp": 2} if mesh_name == "dp2pp2" else {"pp": 2}
    jmesh = jpar.make_mesh(axes, devices=jax.devices()[:int(np.prod(list(axes.values())))])
    jpol = jax.checkpoint_policies.checkpoint_dots if policy == "dots" else None

    def loss(w):
        out = jpar.pipeline_apply(lambda w, x: jnp.tanh(x @ w), w, jnp.asarray(xs), jmesh,
                                  axis_name="pp", data_axis=data_axis, circular_repeats=v,
                                  remat=remat, remat_policy=jpol)
        return jnp.mean((out - tgt) ** 2), out

    (_, jout), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(jnp.asarray(ws))
    ranks = range(4) if mesh_name == "dp2pp2" else range(2)
    got = {r: np.load(os.path.join(work, f"{name}_r{r}.npz")) for r in ranks}
    for r, g in got.items():  # dp2pp2: rank = dp * 2 + pp
        want = np.asarray(jout)
        if data_axis:
            want = np.split(want, 2, axis=1)[r // 2]
        np.testing.assert_allclose(g["out"], want, atol=1e-5, rtol=0, err_msg=f"{name} r{r}")
    np.testing.assert_allclose(sum(g["g"] for g in got.values()), np.asarray(jg), atol=1e-5,
                               rtol=0, err_msg=name)


def test_pipeline_lm_apply_matches_jax(pipe_ranks):
    work, (jm, params, tokens), outs = pipe_ranks
    jmesh = jpar.make_mesh({"dp": 2, "pp": 2}, devices=jax.devices()[:4])
    half = LM_T // 2

    def loss_fn(p):
        logits = jtf.pipeline_lm_apply(jm, p, jnp.asarray(tokens), jmesh, LM_M,
                                       data_axis="dp", circular_repeats=LM_V)
        pred, tgt = logits[:, half - 1: -1], jnp.asarray(tokens)[:, half:]
        logp = jax.nn.log_softmax(pred.astype(jnp.float32), axis=-1)
        return -jnp.take_along_axis(logp, tgt[..., None], axis=-1)[..., 0].mean()

    jloss, jg = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = from_flax(jax.tree_util.tree_map(np.asarray, jg))
    for r in range(4):
        got = dict(np.load(os.path.join(work, f"lm_r{r}.npz")))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k].numpy(), atol=1e-4, rtol=0,
                                       err_msg=f"rank {r} {k}")
        assert abs(outs[r]["loss"] - float(jloss)) < 1e-4


def test_pipeline_rejects_bad_shapes():
    """JAX's messages, checked before any collective (an axis-size dict
    stands in for the mesh)."""
    ws = torch.zeros(8, 4, 4)
    with pytest.raises(ValueError, match="microbatches % pp"):
        pipeline_apply(lambda w, x: x, ws, torch.zeros(6, 2, 4), {"pp": 4}, circular_repeats=2)
    with pytest.raises(ValueError, match="leading axis"):
        pipeline_apply(lambda w, x: x, ws, torch.zeros(8, 2, 4), {"pp": 4}, circular_repeats=3)
    with pytest.raises(ValueError, match="leading axis"):
        pipeline_apply(lambda w, x: x, [ws[0]] * 3, torch.zeros(8, 2, 4), {"pp": 4})
