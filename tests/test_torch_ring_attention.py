"""Ring attention over ``sp`` and the ring LM, against the JAX package.

Four gloo ranks (subprocesses, one spawn for the module) run the port's
per-rank forms; JAX runs its global forms on the conftest's forced CPU
devices, on the same numpy inputs:

- ``ring_attention_sharded`` over ``sp=4`` (T/sp = 128, so each JAX hop
  takes its Pallas chunk path in interpret mode; and a small GQA case) and
  over ``sp=2`` on a ``dp=2 x sp=2`` mesh (the batch over ``dp``), causal
  and not: outputs and dq/dk/dv within 1e-5 of ``jax.vjp`` of
  ``moolib_tpu.parallel.ring_attention``;
- the global entry point ``ring_attention`` returns the whole output on
  every rank;
- ``TransformerLM(attention="ring")`` on ``dp=2 x sp=2`` through the
  example's model-parallel step: the global copy-task loss and every
  reduced gradient within 1e-4 of ``jax.value_and_grad`` of the flax model
  applied with ``mesh=`` (f32, weights converted from the flax tree);
- the ranks' ring hops counted in ``ring_hop_seconds``, and the causal
  ring skipping future chunks (rank r runs r + 1 chunk forwards).
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

from conftest import grab_port, subprocess_env

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM = dict(vocab_size=64, d_model=32, num_heads=2, num_layers=2, max_len=32)
LM_B, LM_T = 4, 32


def _cases():
    """name -> (mesh axes, q, k, v, cotangent, causal, kv group)."""
    rng = np.random.default_rng(7)

    def draw(B, T, H, D, Hk=None):
        Hk = Hk or H
        return [rng.normal(size=s).astype(np.float32)
                for s in ((B, T, H, D), (B, T, Hk, D), (B, T, Hk, D), (B, T, H, D))]

    big = draw(1, 512, 2, 64)
    gqa = draw(2, 32, 4, 16, Hk=2)
    dp = draw(2, 32, 2, 16)
    return {
        "sp4_pallas_causal": ({"sp": 4}, *big, True, 1),
        "sp4_gqa_causal": ({"sp": 4}, *gqa, True, 2),
        "sp4_gqa_full": ({"sp": 4}, *gqa, False, 2),
        "dp2sp2_causal": ({"dp": 2, "sp": 2}, *dp, True, 1),
        "dp2sp2_full": ({"dp": 2, "sp": 2}, *dp, False, 1),
    }


CHILD = r'''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from moolib_tpu_torch import parallel as par, telemetry
from moolib_tpu_torch.examples import lm
from moolib_tpu_torch.models.transformer import TransformerLM
from moolib_tpu_torch.parallel.ring_attention import ring_attention, ring_attention_sharded

rank, dport, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
par.initialize_distributed(f"127.0.0.1:{dport}", 4, rank, device="cpu")
meshes = {"sp4": par.make_mesh({"sp": 4}, device_type="cpu"),
          "dp2sp2": par.make_mesh({"dp": 2, "sp": 2}, device_type="cpu")}
cases = json.load(open(os.path.join(work, "cases.json")))
data = np.load(os.path.join(work, "cases.npz"))
out = {}
for name, (axes, causal, group) in cases.items():
    mesh = meshes["sp4" if axes == {"sp": 4} else "dp2sp2"]
    q, k, v, g = (torch.from_numpy(data[f"{name}/{x}"]) for x in "qkvg")
    sizes = par.mesh.axis_sizes(mesh)
    def block(x):
        x = x.chunk(sizes["sp"], 1)[mesh.get_local_rank("sp")]
        if "dp" in sizes:
            x = x.chunk(sizes["dp"], 0)[mesh.get_local_rank("dp")]
        return x.contiguous().requires_grad_()
    ql, kl, vl, gl = (block(x) for x in (q, k, v, g))
    kr = torch.repeat_interleave(kl, group, dim=2)
    vr = torch.repeat_interleave(vl, group, dim=2)
    o = ring_attention_sharded(ql, kr, vr, mesh, "sp", causal)
    o.backward(gl.detach())
    np.savez(os.path.join(work, f"{name}_r{rank}.npz"), o=o.detach().numpy(),
             dq=ql.grad.numpy(), dk=kl.grad.numpy(), dv=vl.grad.numpy())
    if name == "dp2sp2_full":
        whole = ring_attention(q, k, v, mesh, "sp", causal)
        np.save(os.path.join(work, f"global_r{rank}.npy"), whole.detach().numpy())
out["hops"] = telemetry.get_registry().snapshot()["ring_hop_seconds"]["series"][0]["value"]["count"]

# The ring LM through the example's model-parallel step.
from moolib_tpu_torch.parallel import ring_attention as ra
calls = []
orig = ra._chunk_forward
ra._chunk_forward = lambda *a: (calls.append(a[3]), orig(*a))[1]
cfg = json.load(open(os.path.join(work, "lm.json")))
flags = lm.make_flags(["--mesh", "dp=2,sp=2", "--attention", "ring", "--device", "cpu",
                       "--seq_len", str(cfg["T"]), "--batch_size", str(cfg["B"]),
                       "--vocab", str(cfg["vocab_size"]), "--d_model", str(cfg["d_model"]),
                       "--layers", str(cfg["num_layers"]), "--heads", str(cfg["num_heads"])])
mesh = meshes["dp2sp2"]
model = TransformerLM(dtype=torch.float32, device="cpu", attention="ring",
                      **{k: cfg[k] for k in ("vocab_size", "d_model", "num_heads",
                                             "num_layers", "max_len")})
model.load_state_dict(torch.load(os.path.join(work, "lm_sd.pt")))
mp = lm._StaticMesh(flags, mesh, model)
mp.make_step(lm.make_optimizer(model.parameters(), 1e-3))
tokens = torch.from_numpy(np.load(os.path.join(work, "lm_tokens.npy")))
loss, acc = mp.mstep.grads(mp.named, mp.batch(tokens), None)
out["lm_loss"], out["lm_acc"] = float(loss), float(acc)
out["lm_chunks"] = calls
if rank == 0:
    np.savez(os.path.join(work, "lm_grads.npz"),
             **{k: p.grad.numpy() for k, p in mp.named.items()})
out["sp_rank"] = mesh.get_local_rank("sp")
json.dump(out, open(os.path.join(work, f"out{rank}.json"), "w"))
dist.destroy_process_group()
'''


def _lm_flax():
    jm = jtf.TransformerLM(attention="ring", dtype=jnp.float32, **LM)
    half = LM_T // 2
    prefix = np.random.default_rng(1).integers(2, LM["vocab_size"], (LM_B, half))
    tokens = np.concatenate([prefix, prefix], 1).astype(np.int32)
    jmesh = jpar.make_mesh({"dp": 2, "sp": 2}, devices=jax.devices()[:4])
    params = jm.init(jax.random.key(0), jnp.asarray(tokens), mesh=jmesh)
    return jm, jmesh, params, tokens


@pytest.fixture(scope="module")
def ring_ranks(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("ring"))
    cases = _cases()
    json.dump({k: (c[0], c[5], c[6]) for k, c in cases.items()},
              open(os.path.join(work, "cases.json"), "w"))
    np.savez(os.path.join(work, "cases.npz"),
             **{f"{k}/{x}": a for k, c in cases.items() for x, a in zip("qkvg", c[1:5])})
    jm, jmesh, params, tokens = _lm_flax()
    torch.save(from_flax(jax.tree_util.tree_map(np.asarray, params)),
               os.path.join(work, "lm_sd.pt"))
    np.save(os.path.join(work, "lm_tokens.npy"), tokens)
    json.dump(dict(LM, B=LM_B, T=LM_T), open(os.path.join(work, "lm.json"), "w"))
    dport = grab_port()
    env = subprocess_env(ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(r), str(dport), work],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(4)]
    try:
        for p in procs:
            o, _ = p.communicate(timeout=240)
            assert p.returncode == 0, o.decode()[-3000:]
    finally:
        for p in procs:
            p.kill()
    outs = [json.load(open(os.path.join(work, f"out{r}.json"))) for r in range(4)]
    return work, cases, outs, (jm, jmesh, params, tokens)


def _jax_ring(axes, q, k, v, g, causal, group):
    n = int(np.prod(list(axes.values())))
    jmesh = jpar.make_mesh(axes, devices=jax.devices()[:n])

    def f(q, k, v):
        k, v = jnp.repeat(k, group, axis=2), jnp.repeat(v, group, axis=2)
        return jpar.ring_attention(q, k, v, jmesh, causal=causal)

    out, vjp = jax.vjp(jax.jit(f), *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(x) for x in (out, *vjp(jnp.asarray(g)))]


def _rank_block(x, axes, rank):
    """Rank ``rank``'s block of a global [B, T, ...] array on a mesh laid
    out as ``make_mesh(axes)`` (row-major over the axes' order)."""
    names, sizes = list(axes), list(axes.values())
    coords = np.unravel_index(rank, sizes)
    c = dict(zip(names, coords))
    x = np.split(x, axes["sp"], axis=1)[c["sp"]]
    if "dp" in axes:
        x = np.split(x, axes["dp"], axis=0)[c["dp"]]
    return x


@pytest.mark.parametrize("name", list(_cases()))
def test_ring_attention_matches_jax(ring_ranks, name):
    work, cases, _, _ = ring_ranks
    axes, q, k, v, g, causal, group = cases[name]
    want = _jax_ring(axes, q, k, v, g, causal, group)
    for r in range(4):
        got = np.load(os.path.join(work, f"{name}_r{r}.npz"))
        for key, w in zip(("o", "dq", "dk", "dv"), want):
            np.testing.assert_allclose(got[key], _rank_block(w, axes, r), atol=1e-5, rtol=0,
                                       err_msg=f"{name} rank {r} {key}")


def test_global_ring_attention_gathers_the_whole_output(ring_ranks):
    work, cases, _, _ = ring_ranks
    axes, q, k, v, g, causal, group = cases["dp2sp2_full"]
    want = _jax_ring(axes, q, k, v, g, causal, group)[0]
    for r in range(4):
        np.testing.assert_allclose(np.load(os.path.join(work, f"global_r{r}.npy")), want,
                                   atol=1e-5, rtol=0)


def test_ring_lm_dp2_sp2_matches_flax(ring_ranks):
    work, _, outs, (jm, jmesh, params, tokens) = ring_ranks
    half = LM_T // 2

    def loss_fn(p):
        logits = jm.apply(p, jnp.asarray(tokens), mesh=jmesh)
        pred, tgt = logits[:, half - 1: -1], jnp.asarray(tokens)[:, half:]
        logp = jax.nn.log_softmax(pred.astype(jnp.float32), axis=-1)
        ll = jnp.take_along_axis(logp, tgt[..., None], axis=-1)[..., 0]
        return -ll.mean(), (pred.argmax(-1) == tgt).mean()

    (jloss, jacc), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    want = from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    got = dict(np.load(os.path.join(work, "lm_grads.npz")))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k].numpy(), atol=1e-4, rtol=0, err_msg=k)
    for o in outs:  # the step reports the global loss and accuracy on every rank
        assert abs(o["lm_loss"] - float(jloss)) < 1e-4
        assert abs(o["lm_acc"] - float(jacc)) < 1e-6


def test_causal_ring_skips_future_chunks(ring_ranks):
    """Rank r of a causal sp group runs r + 1 chunk forwards a layer (the
    diagonal causal, the past ones full), so the group runs n(n+1)/2."""
    _, _, outs, _ = ring_ranks
    layers = LM["num_layers"]
    for o in outs:
        r = o["sp_rank"]
        assert len(o["lm_chunks"]) == layers * (r + 1), o["lm_chunks"]
        assert o["lm_chunks"].count(True) == layers  # one diagonal chunk a layer
        assert o["hops"] > 0
