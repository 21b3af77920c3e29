"""The Sebulba split in the port, against the JAX package, on the CPU.

- ``parallel.split_mesh``'s layouts (axis sizes and the bad counts) equal
  JAX's ``split_mesh`` on the conftest's forced CPU devices, case for case;
- four gloo ranks (subprocesses, one spawn for the module) split a
  ``dp=4`` mesh 2 + 2: the halves are process groups whose ranks partition
  the world, ``check_disjoint`` names both flags and the shared ranks on an
  overlap; the actor ranks run ``AnakinRollout(mesh=actor)``, whose env
  states and observations, united over the ranks and stepped under one
  action stream, are bitwise the JAX ``AnakinRollout(mesh=actor_mesh)``'s;
  two unrolls go through ``UnrollHandoff`` (6 envs over 2 actor ranks,
  learner batches of 4 over ``dp=2``: blocks that span two actor ranks and
  two unrolls, with the LSTM's initial core states), and each learner
  rank's blocks are bitwise its columns,
  with every byte counted once, as staged, and none as d2d; the learner
  mesh's reduced V-trace gradients on the first handed batch are within
  1e-5 of ``jax.grad`` of the JAX example's loss on the same batch and
  converted weights;
- ``experiment.train(--mesh dp=3 --actor_mesh 1)`` ends, its learner ranks
  hold one set of parameters, every unroll byte arrives as sent, and
  ``actor_param_sync_bytes_total`` counts one replica per refresh.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from moolib_tpu import parallel as jpar
from moolib_tpu import rollout as jrollout
from moolib_tpu.envs import jax_envs as jenvs
from moolib_tpu.examples.vtrace import experiment as jexp
from moolib_tpu.models import ActorCriticNet as JAC
from moolib_tpu_torch import parallel as par
from moolib_tpu_torch.models.convert import actor_critic_from_flax

from conftest import grab_port, subprocess_env

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 6 envs over 2 actor ranks (3 each), unrolls of T=3, learner batches of 4
# over dp=2 (2 columns a rank): two unrolls are three learner batches.
B, T, BS, UNROLLS, STEPS = 6, 3, 4, 2, 12
FLAGS = dict(discounting=0.99, baseline_cost=0.5, entropy_cost=0.01)

LAYOUTS = [
    ({"dp": 8}, 3), ({"dp": 8}, 2), ({"dp": 4, "tp": 2}, 2), ({"dp": 4, "tp": 2}, 4),
    ({"dp": 4, "tp": 2}, 3), ({"dp": 4, "tp": 2}, 5), ({"dp": 8}, 0), ({"dp": 8}, 8),
    ({"dp": 8}, 9),
]


@pytest.mark.parametrize("axes,n", LAYOUTS, ids=[f"{a}-{n}" for a, n in LAYOUTS])
def test_split_mesh_layouts_match_jax(axes, n):
    """The port's layout form (axis sizes, no process group) gives JAX's
    axis sizes, and refuses the counts JAX refuses, naming actor_devices."""
    jmesh = jpar.make_mesh(axes, devices=jax.devices()[:8])
    if not 0 < n < 8:
        with pytest.raises(ValueError, match="actor_devices"):
            jpar.split_mesh(jmesh, n)
        with pytest.raises(ValueError, match="actor_devices"):
            par.split_mesh(dict(axes), n)
        return
    ja, jl = jpar.split_mesh(jmesh, n)
    pa, pl = par.split_mesh(dict(axes), n)
    assert pa == dict(ja.shape) and pl == dict(jl.shape)
    assert list(pl) == list(jl.axis_names)


CHILD = r'''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from moolib_tpu_torch import parallel as par, rollout, telemetry
from moolib_tpu_torch.envs import jax_envs, _threefry
from moolib_tpu_torch.examples.vtrace import experiment
from moolib_tpu_torch.models.actor_critic import ActorCriticNet
from moolib_tpu_torch.parallel.collectives import UnrollHandoff, gather_full
from moolib_tpu_torch.utils import nest
rank, port, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
cfg = json.load(open(os.path.join(work, "cfg.json")))
B, T, BS, U, S = cfg["B"], cfg["T"], cfg["BS"], cfg["UNROLLS"], cfg["STEPS"]
par.initialize_distributed(f"127.0.0.1:{port}", 4, rank, device="cpu")
mesh = par.make_mesh({"dp": 4}, device_type="cpu")
actor, learner = par.split_mesh(mesh, 2)
mine = actor if rank in par.mesh.mesh_ranks(actor) else learner
g = mine.get_group("dp")
out = {"actor_ranks": par.mesh.mesh_ranks(actor), "learner_ranks": par.mesh.mesh_ranks(learner),
       "group": [dist.get_global_rank(g, i) for i in range(dist.get_world_size(g))]}
par.check_disjoint(learner, actor)
overlap = par.make_mesh({"dp": 2}, ranks=[1, 2], device_type="cpu")
try:
    par.check_disjoint(actor, overlap, what_a="--mesh", what_b="--actor_mesh")
except ValueError as e:
    out["overlap_error"] = str(e)
env = jax_envs.make_jax_env("catch_flat")
model = ActorCriticNet(env.num_actions, obs_size=50, use_lstm=True, device="cpu")
model.load_state_dict(torch.load(os.path.join(work, "ac.pt")))
uh = UnrollHandoff(actor, learner, B // 2, BS, rollout.anakin_column_specs(env, model, T), "cpu")
names = ("batcher_d2d_bytes_total", "batcher_staged_bytes_total")
before = experiment.counters(names)
if mine is actor:
    roll = rollout.AnakinRollout(model, env, B, T, env_key=_threefry.seed(3), act_seed=5,
                                 mesh=actor)
    b, r = B // 2, actor.get_local_rank("dp")
    state, obs = roll._carry["env"], roll._carry["obs"]
    acts = np.load(os.path.join(work, "actions.npy"))[:, r * b:(r + 1) * b]
    rec = {f"init/{k}": v.numpy() for k, v in state.items()}
    rec["obs0"] = obs.numpy()
    for t in range(S):
        state, ts = jax_envs.batch_step(env, state, torch.from_numpy(acts[t]))
        for k in ("state", "reward", "done"):
            rec[f"{t}/{k}"] = ts[k].numpy()
    for u in range(U):
        unroll = roll.unroll()
        uh.send(u, unroll, roll.completed_initial_core)
        for i, x in enumerate(nest.tree_flatten(unroll)[0]):
            rec[f"unroll{u}/{i}"] = x.numpy()
        for i, x in enumerate(nest.tree_flatten(roll.completed_initial_core)[0]):
            rec[f"core{u}/{i}"] = x.numpy()
    np.savez(os.path.join(work, f"actor{r}.npz"), **rec)
    snap = roll.stats()
    out["stats"] = {"episodes": snap["episodes"], "envs": int(snap["ep_return"].shape[0]),
                    "frames": roll.frames_done, "local": roll.local_batch_size}
    uh.wait_sent()
else:
    blocks = [uh.take() for _ in range(U * B // BS)]
    np.savez(os.path.join(work, f"learner{learner.get_local_rank('dp')}.npz"),
             **{f"{k}/{i}": x.numpy() for k, (unroll, _) in enumerate(blocks)
                for i, x in enumerate(nest.tree_flatten(unroll)[0])},
             **{f"{k}/core{i}": x.numpy() for k, (_, core) in enumerate(blocks)
                for i, x in enumerate(nest.tree_flatten(core)[0])})
    flags = type("F", (), dict(cfg["FLAGS"]))
    named = dict(model.named_parameters())
    step = par.make_train_step(
        lambda p, b, rr: experiment.compute_loss(b[0], b[1], model, flags), mesh=learner,
        grad_spec=par.auto_shardings(named, learner), batch_spec=par.PartitionSpec())
    loss, _, grads = step(named, blocks[0], None)
    full = gather_full(grads, dst=0)
    if full is not None:
        np.savez(os.path.join(work, "grads.npz"), **{k: v.numpy() for k, v in full.items()})
after = experiment.counters(names)
out["bytes"] = {k: after[k] - before[k] for k in names}
out["digests"] = uh.handoff.digests()
uh.handoff.close()
json.dump(out, open(os.path.join(work, f"out{rank}.json"), "w"))
dist.destroy_process_group()
'''


def _jax_model():
    jm = JAC(num_actions=3, use_lstm=True)
    x = {"state": jnp.zeros((1, 2, 50)), "reward": jnp.zeros((1, 2)),
         "done": jnp.zeros((1, 2), bool), "prev_action": jnp.zeros((1, 2), jnp.int32)}
    return jm, jax.device_get(jm.init(jax.random.key(0), x, jm.initial_state(2)))


@pytest.fixture(scope="module")
def sebulba_ranks(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("sebulba"))
    jm, params = _jax_model()
    torch.save(actor_critic_from_flax(params), os.path.join(work, "ac.pt"))
    actions = np.random.default_rng(0).integers(0, 3, (STEPS, B))
    np.save(os.path.join(work, "actions.npy"), actions)
    json.dump(dict(B=B, T=T, BS=BS, UNROLLS=UNROLLS, STEPS=STEPS, FLAGS=FLAGS),
              open(os.path.join(work, "cfg.json"), "w"))
    port = grab_port()
    env = subprocess_env(ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(r), str(port), work], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(4)]
    try:
        for p in procs:
            o, _ = p.communicate(timeout=180)
            assert p.returncode == 0, o.decode()[-3000:]
    finally:
        for p in procs:
            p.kill()
    outs = [json.load(open(os.path.join(work, f"out{r}.json"))) for r in range(4)]
    actors = [dict(np.load(os.path.join(work, f"actor{r}.npz"))) for r in range(2)]
    learners = [dict(np.load(os.path.join(work, f"learner{r}.npz"))) for r in range(2)]
    return work, outs, actors, learners, (jm, params, actions)


def test_split_halves_are_disjoint_process_groups(sebulba_ranks):
    _, outs, _, _, _ = sebulba_ranks
    for r, o in enumerate(outs):
        assert o["actor_ranks"] == [0, 1] and o["learner_ranks"] == [2, 3]
        assert o["group"] == ([0, 1] if r < 2 else [2, 3])
        msg = o["overlap_error"]
        assert "--mesh" in msg and "--actor_mesh" in msg and "[1]" in msg, msg
    # The mesh's stats() sum over the actor ranks and cover every env.
    for o in outs[:2]:
        assert o["stats"]["envs"] == B and o["stats"]["local"] == B // 2
        assert o["stats"]["frames"] == B * (T + 1 + (UNROLLS - 1) * T)
    assert outs[0]["stats"]["episodes"] == outs[1]["stats"]["episodes"]


def test_actor_env_shards_are_the_jax_mesh_rollouts(sebulba_ranks):
    """Env ``i`` of the batch is seeded ``fold_in(key, i)`` on whichever
    rank holds it: the ranks' states and observations, united, are the
    JAX mesh rollout's, bitwise, at the start and over every step."""
    _, _, actors, _, (jm, _, actions) = sebulba_ranks
    jmesh = jpar.make_mesh({"dp": 4}, devices=jax.devices()[:4])
    jactor, _ = jpar.split_mesh(jmesh, 2)
    env = jenvs.make_jax_env("catch_flat")
    jroll = jrollout.AnakinRollout(jm, env, B, T, env_key=jax.random.key(3),
                                   act_rng=jax.random.key(5), mesh=jactor)
    state = jroll._carry["env"]

    def united(key):
        return np.concatenate([a[key] for a in actors])

    for k, v in state.items():
        want = np.asarray(jax.random.key_data(v) if k == "key" else v).astype(np.int64)
        np.testing.assert_array_equal(united(f"init/{k}"), want, err_msg=k)
    np.testing.assert_array_equal(united("obs0"), np.asarray(jroll._carry["obs"]))
    for t in range(STEPS):
        state, ts = jenvs.batch_step(env, state, jnp.asarray(actions[t], jnp.int32))
        for k in ("state", "reward", "done"):
            np.testing.assert_array_equal(united(f"{t}/{k}"), np.asarray(ts[k]),
                                          err_msg=f"step {t} {k}")


def _stream(actors, leaf: int, part: str = "unroll") -> np.ndarray:
    """The actor ranks' unrolls (``part="core"``: their initial core
    states) as one stream of columns: unroll by unroll, actor rank by actor
    rank."""
    return np.concatenate([a[f"{part}{u}/{leaf}"] for u in range(UNROLLS) for a in actors],
                          axis=1 if part == "unroll" else 0)


def test_learner_ranks_receive_their_columns_bitwise(sebulba_ranks):
    _, outs, actors, learners, _ = sebulba_ranks
    n_leaves = sum(1 for k in actors[0] if k.startswith("unroll0/"))
    n_core = sum(1 for k in actors[0] if k.startswith("core0/"))
    assert n_core == 2  # the LSTM's (h, c)
    c = BS // 2
    for k in range(UNROLLS * B // BS):
        cols = slice(k * BS, k * BS + c), slice(k * BS + c, (k + 1) * BS)
        for dp, got in enumerate(learners):
            for i in range(n_leaves):
                np.testing.assert_array_equal(got[f"{k}/{i}"], _stream(actors, i)[:, cols[dp]],
                                              err_msg=f"batch {k} dp {dp} leaf {i}")
            for i in range(n_core):
                np.testing.assert_array_equal(got[f"{k}/core{i}"],
                                              _stream(actors, i, "core")[cols[dp]],
                                              err_msg=f"batch {k} dp {dp} core {i}")
    # Every unroll byte counted once, by its receiver, through host memory.
    unroll_bytes = (sum(_stream(actors, i).nbytes for i in range(n_leaves))
                    + sum(_stream(actors, i, "core").nbytes for i in range(n_core)))
    assert sum(o["bytes"]["batcher_staged_bytes_total"] for o in outs) == unroll_bytes
    assert all(o["bytes"]["batcher_d2d_bytes_total"] == 0 for o in outs)
    # The byte streams' digests agree pair by pair.
    for a in (0, 1):
        for l in (2, 3):
            assert outs[a]["digests"][f"tx:{l}"] == outs[l]["digests"][f"rx:{a}"]


def test_learner_gradients_on_a_handed_batch_match_jax(sebulba_ranks):
    """The learner mesh's step (``_MeshLearner``'s: ``make_train_step`` over
    ``dp=2``, ``auto_shardings``) on the first handed batch: the reduced
    gradients within 1e-5 of ``jax.grad`` of the JAX loss on the batch."""
    work, _, actors, _, (jm, params, _) = sebulba_ranks
    keys = ("action", "done", "policy_logits", "prev_action", "reward", "state")
    batch = {k: jnp.asarray(_stream(actors, i)[:, :BS]) for i, k in enumerate(keys)}
    batch["prev_action"] = batch["prev_action"].astype(jnp.int32)
    batch["action"] = batch["action"].astype(jnp.int32)
    flags = types.SimpleNamespace(**FLAGS)
    core = tuple(jnp.asarray(_stream(actors, i, "core")[:BS]) for i in range(2))
    grads = jax.grad(lambda p: jexp.compute_loss(p, batch, core, jm, flags)[0])(params)
    want = actor_critic_from_flax(jax.device_get(grads))
    got = np.load(os.path.join(work, "grads.npz"))
    assert set(got.files) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v.numpy(), atol=1e-5, rtol=1e-5, err_msg=k)


def test_sebulba_learner_trains_with_its_ranks_equal(free_port, monkeypatch):
    """``--mesh dp=3 --actor_mesh 1``: rank 0 acts, ranks 1 (this process,
    the loop's owner) and 2 learn over ``dp=2``."""
    from moolib_tpu_torch.examples.vtrace import experiment

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    sync0 = experiment.counters(["actor_param_sync_bytes_total"])
    out = experiment.train(experiment.make_flags([
        "--env", "catch_flat", "--env_backend", "jax", "--device", "cpu", "--quiet",
        "--total_steps", "1200", "--actor_batch_size", "4", "--num_actor_batches", "2",
        "--batch_size", "4", "--virtual_batch_size", "4", "--unroll_length", "5",
        "--mesh", "dp=3", "--actor_mesh", "1", "--address", f"127.0.0.1:{free_port}"]))
    seb = out["sebulba"]
    assert out["steps"] >= 1200 and out["sgd_steps"] > 0
    assert [a["role"] for a in seb["actors"]] == ["actor"]
    assert len({rk["params_sha256"] for rk in seb["learners"]}) == 1
    assert seb["learners"][0]["params_sha256"] == out["params_sha256"]
    # Every unroll the owner ticketed was made, and every byte arrived.
    actor = seb["actors"][0]
    assert actor["unrolls"] == seb["unrolls"]
    for l, rk in enumerate(seb["learners"], start=1):
        assert actor["digests"][f"tx:{l}"] == rk["digests"]["rx:0"]
    got = sum(rk["handoff_bytes"]["batcher_staged_bytes_total"] for rk in seb["learners"])
    assert got == seb["unrolls"] * seb["unroll_bytes"]
    assert actor["boundary_bytes"] == {k: 0 for k in experiment.BOUNDARY}
    # One replica per refresh, a refresh per version change the actors saw.
    synced = experiment.counters(["actor_param_sync_bytes_total"])
    moved = synced["actor_param_sync_bytes_total"] - sync0["actor_param_sync_bytes_total"]
    assert seb["param_refreshes"] == actor["param_refreshes"] >= 1
    assert moved == seb["param_refreshes"] * seb["param_bytes"]
    assert seb["param_refreshes"] <= out["model_version"] + 1
