"""``moolib_tpu_torch.parallel`` against the JAX package's ``parallel``.

- ``mesh_axes`` (the rule behind ``make_mesh``/``parse_mesh_spec``) sizes
  every spec as JAX's ``make_mesh`` does over 8 devices, with the same
  error text;
- ``fsdp_spec`` / ``param_shardings`` / ``auto_shardings`` pick JAX's dims
  on the LM tree converted by ``models.convert.from_flax``;
- the collectives (and ``redistribute``, ``gather_full``,
  ``scatter_shards``, ``broadcast_tree``) over two gloo ranks
  (subprocesses) equal numpy;
- ``make_train_step(mesh dp=2, grad_spec="params")`` on the small LM
  gives JAX's ``make_train_step(mesh=make_mesh({"dp": 2}),
  params_sharding="fsdp", grad_spec="params")`` gradients within 1e-5
  (f32; JAX runs on 2 of the 8 forced CPU devices, same weights, same
  batch), and its overlap form streams the same gradients bit for bit.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

from moolib_tpu import parallel as jpar
from moolib_tpu.models import transformer as jtf
from moolib_tpu_torch import parallel as tpar
from moolib_tpu_torch.models.convert import from_flax
from moolib_tpu_torch.parallel.mesh import mesh_axes

from conftest import grab_port, subprocess_env

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, D, H, L, T, B = 2048, 64, 2, 2, 16, 4


@pytest.mark.parametrize("axes", [None, {"dp": 8}, {"dp": -1}, {"dp": 2, "tp": -1},
                                  {"dp": 2, "tp": 4}, {"tp": 2, "dp": 2, "sp": 2}])
def test_mesh_axes_match_jax(axes):
    jmesh = jpar.make_mesh(axes, devices=jax.devices()[:8])
    assert mesh_axes(axes, 8) == dict(zip(jmesh.axis_names, jmesh.devices.shape))


@pytest.mark.parametrize("axes", [{"dp": -1, "tp": -1}, {"dp": 3, "tp": -1}, {"dp": 3}])
def test_mesh_errors_match_jax(axes):
    with pytest.raises(ValueError) as jerr:
        jpar.make_mesh(axes, devices=jax.devices()[:8])
    with pytest.raises(ValueError) as terr:
        mesh_axes(axes, 8)
    assert str(terr.value) == str(jerr.value)


def test_partition_spec_prints_as_jax():
    for parts in [(), ("dp",), (None, "dp"), ("dp", None, None)]:
        assert str(tpar.PartitionSpec(*parts)) == str(JP(*parts))


def test_unported_mesh_paths_say_so():
    # split_mesh is ported: over axis sizes it gives JAX's layouts and
    # JAX's error for a count that leaves the learner nothing.
    with pytest.raises(ValueError, match=re.escape("actor_devices must be in (0, 4)")):
        tpar.split_mesh({"dp": 2, "tp": 2}, 4)
    assert tpar.split_mesh({"dp": 2, "tp": 2}, 2) == ({"dp": 2}, {"dp": 1, "tp": 2})
    # auto_shardings over tp is ported: JAX's spec (tp on a kernel's last
    # axis from tp_min up, FSDP over dp on the largest other axis).
    got = tpar.auto_shardings({"w": torch.zeros(4, 4), "k": torch.zeros(256, 32),
                               "b": torch.zeros(32)}, {"dp": 2, "tp": 2})
    jmesh = jpar.make_mesh({"dp": 2, "tp": 2}, devices=jax.devices()[:4])
    want = jpar.auto_shardings({"w": np.zeros((4, 4)), "k": np.zeros((256, 32)),
                                "b": np.zeros(32)}, jmesh)
    assert {k: tuple(v.spec) for k, v in got.items()} == {k: tuple(v.spec) for k, v in want.items()}


def _lm_tree():
    jm = jtf.TransformerLM(vocab_size=V, d_model=D, num_heads=H, num_layers=L, max_len=T,
                           attention="dense", dtype=jnp.float32)
    tokens = np.random.default_rng(0).integers(2, V, (B, T)).astype(np.int32)
    params = jm.init(jax.random.key(0), jnp.asarray(tokens))
    return jm, params, tokens


def _by_name(flax_tree_of_specs, params):
    """Port names -> JAX spec tuples, through from_flax on a tree whose
    leaves carry the leaf index (the spec tree has the params' structure)."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    idx = jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(l), i, np.int64) for i, l in enumerate(leaves)])
    specs = jax.tree_util.tree_leaves(flax_tree_of_specs,
                                      is_leaf=lambda x: isinstance(x, (JP, jax.sharding.Sharding)))
    return {k: specs[int(np.asarray(v).flat[0])] for k, v in from_flax(idx).items()}


def test_fsdp_and_param_shardings_pick_jax_dims():
    _, params, _ = _lm_tree()
    sd = from_flax(jax.tree_util.tree_map(np.asarray, params))
    jmesh = jpar.make_mesh({"dp": 2}, devices=jax.devices()[:2])
    want_fsdp = _by_name(jax.tree_util.tree_map(lambda x: jpar.fsdp_spec(x), params), params)
    want_ps = _by_name(jpar.param_shardings(params, jmesh, "fsdp"), params)
    want_auto = _by_name(jpar.auto_shardings(params, jmesh), params)
    got_ps = tpar.param_shardings(sd, {"dp": 2}, "fsdp")
    got_auto = tpar.auto_shardings(sd, {"dp": 2})
    sharded = 0
    for k, t in sd.items():
        assert tuple(tpar.fsdp_spec(t)) == tuple(want_fsdp[k]), k
        assert tuple(got_ps[k].spec) == tuple(want_ps[k].spec), k
        assert tuple(got_auto[k].spec) == tuple(want_auto[k].spec), k
        sharded += any(s is not None for s in got_ps[k].spec)
    assert sharded >= 2  # the embedding and the head are big enough
    rep = tpar.param_shardings(sd, {"dp": 2}, "replicated")
    assert all(tuple(s.spec) == () for s in rep.values())


CHILD = r'''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from moolib_tpu_torch import parallel as par
from moolib_tpu_torch.examples.lm import copy_task_loss
from moolib_tpu_torch.models.transformer import TransformerLM
from moolib_tpu_torch.parallel.mesh import NamedSharding, PartitionSpec as P

rank, dport, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
par.initialize_distributed(f"127.0.0.1:{dport}", 2, rank, device="cpu")
mesh = par.parse_mesh_spec("dp=2", device_type="cpu")
assert par.make_mesh({"dp": -1}, device_type="cpu").mesh.tolist() == [0, 1]
out = {"axis_size": par.axis_size("dp", mesh)}
x = torch.arange(12.0).reshape(4, 3) + 100 * rank
out["psum"] = par.tree_psum({"x": x}, "dp", mesh)["x"].tolist()
out["pmean"] = par.tree_pmean({"x": x}, "dp", mesh)["x"].tolist()
out["gather0"] = par.all_gather_axis(x, "dp", mesh, axis=0).tolist()
out["gather1"] = par.all_gather_axis(x, "dp", mesh, axis=1).tolist()
out["rs0"] = par.reduce_scatter_axis(x, "dp", mesh, axis=0).tolist()
out["rs1"] = par.reduce_scatter_axis(torch.arange(8.0).reshape(2, 4) + rank, "dp", mesh,
                                     axis=1).tolist()
out["ring"] = par.ring_permute(x, "dp", mesh).tolist()
full = torch.arange(24.0).reshape(4, 6)
sh = NamedSharding(mesh, P(None, "dp"))
dt = par.redistribute({"a": full}, sh)["a"]
out["redist_local"] = dt.to_local().tolist()
back = par.redistribute({"a": dt}, par.replicated(mesh))["a"]
out["redist_back"] = back.to_local().tolist()
g = par.gather_full({"a": dt, "b": torch.ones(2)}, dst=0)
out["gather_full"] = None if g is None else g["a"].tolist()
blocks = par.scatter_shards({"a": full * 2, "b": torch.full((2,), 5.0)} if rank == 0 else None,
                            {"a": full, "b": torch.ones(2)}, [sh, None], mesh)
out["scatter"] = [b.tolist() for b in blocks]
got = par.broadcast_tree({"t": (full + 1, torch.arange(3))} if rank == 0 else None, mesh, "cpu")
out["bcast"] = [got["t"][0].tolist(), got["t"][1].tolist()]

# make_train_step on the small LM: this rank's dp block of the batch.
sd = torch.load(os.path.join(work, "sd.pt"))
tokens = torch.from_numpy(np.load(os.path.join(work, "tokens.npy")))
cfg = json.load(open(os.path.join(work, "cfg.json")))
model = TransformerLM(dtype=torch.float32, device="cpu", **cfg)
model.load_state_dict(sd)
params = dict(model.named_parameters())
half = tokens.shape[1] // 2
loss_fn = lambda p, b, r: copy_task_loss(model(b), b, half)
step = par.make_train_step(loss_fn, mesh=mesh, params_sharding="fsdp", grad_spec="params",
                           batch_spec=P("dp", None))
loss, acc, grads = step(params, tokens, None)
out["grad_placements"] = {k: str(v.placements) for k, v in grads.items()}
full_grads = par.gather_full(grads, dst=0)
from moolib_tpu_torch import buckets
buckets.set_bucket_bytes(1 << 16)  # several runs of leaves at this width
ostep = par.make_train_step(loss_fn, mesh=mesh, params_sharding="fsdp", grad_spec="params",
                            batch_spec=P("dp", None), overlap_grads=True)
_, _, stream = ostep(params, tokens, None)
out["overlap_log"] = [list(e[:3]) for e in ostep.inner.log]
if rank == 0:
    got = {}
    while True:
        c = stream.next_chunk(10)
        if c is None:
            break
        lo, leaves = c
        for i, l in enumerate(leaves, start=lo):
            got[i] = np.asarray(l)
    names = sorted(params)
    np.savez(os.path.join(work, "grads.npz"), **{k: v.numpy() for k, v in full_grads.items()})
    np.savez(os.path.join(work, "stream.npz"), **{names[i]: v for i, v in got.items()})
    out["loss"] = float(loss)
else:
    assert stream is None and full_grads is None
json.dump(out, open(os.path.join(work, f"out{rank}.json"), "w"))
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("par"))
    jm, params, tokens = _lm_tree()
    torch.save(from_flax(jax.tree_util.tree_map(np.asarray, params)), os.path.join(work, "sd.pt"))
    tokens = np.concatenate([tokens[:, : T // 2], tokens[:, : T // 2]], 1)
    np.save(os.path.join(work, "tokens.npy"), tokens)
    json.dump(dict(vocab_size=V, d_model=D, num_heads=H, num_layers=L, max_len=T,
                   attention="dense"), open(os.path.join(work, "cfg.json"), "w"))
    dport = grab_port()
    env = subprocess_env(ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(r), str(dport), work],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    for p in procs:
        o, _ = p.communicate(timeout=120)
        assert p.returncode == 0, o.decode()[-3000:]
    outs = [json.load(open(os.path.join(work, f"out{r}.json"))) for r in range(2)]
    return work, jm, params, tokens, outs


def test_collectives_over_two_gloo_ranks_equal_numpy(two_ranks):
    _, _, _, _, outs = two_ranks
    xs = [np.arange(12.0).reshape(4, 3) + 100 * r for r in range(2)]
    full = np.arange(24.0).reshape(4, 6)
    for r, o in enumerate(outs):
        assert o["axis_size"] == 2
        np.testing.assert_array_equal(o["psum"], xs[0] + xs[1])
        np.testing.assert_array_equal(o["pmean"], (xs[0] + xs[1]) / 2)
        np.testing.assert_array_equal(o["gather0"], np.concatenate(xs, 0))
        np.testing.assert_array_equal(o["gather1"], np.concatenate(xs, 1))
        np.testing.assert_array_equal(o["rs0"], (xs[0] + xs[1])[2 * r: 2 * r + 2])
        ys = [np.arange(8.0).reshape(2, 4) + q for q in range(2)]
        np.testing.assert_array_equal(o["rs1"], (ys[0] + ys[1])[:, 2 * r: 2 * r + 2])
        np.testing.assert_array_equal(o["ring"], xs[1 - r])
        np.testing.assert_array_equal(o["redist_local"], full[:, 3 * r: 3 * r + 3])
        np.testing.assert_array_equal(o["redist_back"], full)
        np.testing.assert_array_equal(o["scatter"][0], 2 * full[:, 3 * r: 3 * r + 3])
        np.testing.assert_array_equal(o["scatter"][1], [5.0, 5.0])
        np.testing.assert_array_equal(o["bcast"][0], full + 1)
        np.testing.assert_array_equal(o["bcast"][1], [0, 1, 2])
    np.testing.assert_array_equal(outs[0]["gather_full"], full)
    assert outs[1]["gather_full"] is None


def _jax_grads(jm, params, tokens):
    half = T // 2

    def loss_fn(p, b, r):
        logits = jm.apply(p, b)
        pred = logits[:, half - 1: -1]
        tgt = b[:, half:]
        logp = jax.nn.log_softmax(pred.astype(jnp.float32), axis=-1)
        ll = jnp.take_along_axis(logp, tgt[..., None], axis=-1)[..., 0]
        return -ll.mean(), (pred.argmax(-1) == tgt).mean()

    mesh = jpar.make_mesh({"dp": 2}, devices=jax.devices()[:2])
    step = jpar.make_train_step(loss_fn, mesh=mesh, params_sharding="fsdp", grad_spec="params",
                                batch_spec=JP("dp", None))
    loss, _, grads = step(params, jnp.asarray(tokens), jax.random.key(0))
    return float(loss), from_flax(jax.tree_util.tree_map(np.asarray, grads))


def test_make_train_step_dp2_matches_jax(two_ranks):
    work, jm, params, tokens, outs = two_ranks
    jloss, want = _jax_grads(jm, params, tokens)
    got = dict(np.load(os.path.join(work, "grads.npz")))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k].numpy(), atol=1e-5, rtol=0, err_msg=k)
    # Rank 0's local loss is the mean over its block; JAX's over the batch.
    assert np.isfinite(outs[0]["loss"]) and abs(outs[0]["loss"] - jloss) < 0.5
    # The fsdp-sharded leaves come back as Shard placements.
    assert any("Shard" in p for p in outs[0]["grad_placements"].values())
    assert any("Replicate" in p for p in outs[0]["grad_placements"].values())


def test_overlap_step_streams_the_barrier_gradients_bitwise(two_ranks):
    work, _, _, _, outs = two_ranks
    barrier = dict(np.load(os.path.join(work, "grads.npz")))
    streamed = dict(np.load(os.path.join(work, "stream.npz")))
    assert set(streamed) == set(barrier)
    for k in barrier:
        assert streamed[k].tobytes() == barrier[k].tobytes(), k
    # Every run went out from inside the backward, in the same order on
    # both ranks (the reductions are collectives).
    log0, log1 = outs[0]["overlap_log"], outs[1]["overlap_log"]
    assert log0 == log1 and len(log0) >= 2
    assert all(in_bwd for _, _, in_bwd in log0)
