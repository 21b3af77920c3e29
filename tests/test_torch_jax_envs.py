"""The port's on-device env family and Anakin rollout
(``moolib_tpu_torch/envs/{_threefry,jax_envs}.py``,
``moolib_tpu_torch/rollout.py::AnakinRollout``) against the JAX package's.

The first nine tests mirror ``tests/test_jax_envs.py`` on the port:

1. **Bit-exactness across backends**: under the shared counter-based
   seeding contract (episode e of key k draws from fold_in(k, e)), the
   batched JaxCatch produces obs/reward/done streams bit-identical to the
   host FlatCatchEnv of ``host_catch``, across auto-reset boundaries.
2. **Batching**: env i of a batch seeded with key k behaves exactly like a
   batch of one seeded with fold_in(k, i).
3. **Whole unroll == per step**: ``AnakinRollout.unroll()`` is bitwise
   equal to the per-step mode over the same seeds.
4. **Zero crossings**: neither mode moves a byte across the host boundary
   per frame; episode stats leave only through ``stats()``
   (``actor_stats_d2h_bytes_total``).

The rest hold the port to the JAX package itself, on the same inputs:
``_threefry`` against ``jax.random`` bit for bit, both envs against the
JAX envs over 1,000 steps on the same key and actions, the ActorCriticNet
on converted weights, and ``--env_backend jax`` learning Catch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moolib_tpu.envs import jax_envs as jax_ref
from moolib_tpu.models import ActorCriticNet as JaxActorCriticNet
from moolib_tpu_torch import rollout, telemetry
from moolib_tpu_torch.envs import _threefry, jax_envs
from moolib_tpu_torch.envs.catch import CatchEnv, FlatCatchEnv
from moolib_tpu_torch.models.actor_critic import ActorCriticNet
from moolib_tpu_torch.models.convert import actor_critic_from_flax

torch.set_num_threads(1)

BOUNDARY = (
    "actor_h2d_bytes_total",
    "actor_d2h_bytes_total",
    "batcher_h2d_bytes_total",
    "batcher_d2h_bytes_total",
)


def _counters():
    return dict(telemetry.get_registry().counter_values())


def _raw(key) -> torch.Tensor:
    """A jax key's raw uint32 words as the port's int64 key."""
    return torch.from_numpy(np.asarray(jax.random.key_data(key)).astype(np.int64))


def _run(env, state, actions):
    """Step the batched port env over ``actions`` [S, B]; returns the
    stacked (obs, reward, done) streams."""
    out = []
    for a in actions:
        state, ts = jax_envs.batch_step(env, state, torch.from_numpy(a))
        out.append((ts["state"].numpy(), ts["reward"].numpy(), ts["done"].numpy()))
    return [np.stack(x) for x in zip(*out)]


# --------------------------------------------------------------------------
# The seeding contract: _threefry against jax.random
# --------------------------------------------------------------------------

N_KEYS = 1024


@pytest.fixture(scope="module")
def keys():
    """1,024 jax keys, env i of key(7) (fold_in(key(7), i)), and the port's
    raw words of the same keys."""
    jk = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(7), i))(jnp.arange(N_KEYS))
    return jk, _raw(jk)


def test_threefry_seed_and_fold_in_bitwise(keys):
    jk, pk = keys
    np.testing.assert_array_equal(_threefry.seed(7).numpy(), _raw(jax.random.key(7)).numpy())
    # The per-env fold of one key reproduces the 1,024 keys...
    np.testing.assert_array_equal(_threefry.fold_in(_threefry.seed(7), torch.arange(N_KEYS)).numpy(),
                                  pk.numpy())
    # ...and a per-key fold of per-key data (beyond int16) matches jax's.
    data = (np.arange(N_KEYS) * 7919) % 100_003
    want = jax.vmap(jax.random.fold_in)(jk, jnp.asarray(data, jnp.int32))
    np.testing.assert_array_equal(_threefry.fold_in(pk, torch.from_numpy(data)).numpy(),
                                  _raw(want).numpy())


def test_threefry_split_and_bits_bitwise(keys):
    jk, pk = keys
    want = jax.vmap(lambda k: jax.random.split(k, 3))(jk)
    np.testing.assert_array_equal(_threefry.split(pk, 3).numpy(), _raw(want).numpy())
    # One key splits to [num, 2] as in jax.
    np.testing.assert_array_equal(_threefry.split(_threefry.seed(7), 4).numpy(),
                                  _raw(jax.random.split(jax.random.key(7), 4)).numpy())
    bits = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (), jnp.uint32))(jk))
    np.testing.assert_array_equal(_threefry.random_bits(pk).numpy(), bits.astype(np.int64))


@pytest.mark.parametrize("lo,hi", [(0, 5), (-1, 2), (-3, 4), (0, 1), (5, 5), (-1000, 123456789)])
def test_threefry_randint_bitwise(keys, lo, hi):
    """Both draws, the span fold and the multiplier, for a negative minval
    too (the drift's range) and for spans past 2**16 (the multiplier's
    uint32 wrap)."""
    jk, pk = keys
    want = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (), lo, hi, jnp.int32))(jk))
    np.testing.assert_array_equal(_threefry.randint(pk, lo, hi).numpy(), want.astype(np.int64))


# --------------------------------------------------------------------------
# Env family (mirrors of tests/test_jax_envs.py)
# --------------------------------------------------------------------------


def test_jax_catch_bit_exact_vs_host():
    """Same key -> bit-identical obs/reward/done streams on the batched env
    and the host env, across several auto-reset boundaries."""
    key = _threefry.seed(7)
    env = jax_envs.JaxCatch()
    host = jax_envs.host_catch(key)

    state = env.init(key[None])
    np.testing.assert_array_equal(env.observe(state)[0].numpy(), host.reset())
    for t in range(40):  # 10-row catch: > 4 full episodes
        action = t % 3
        state, ts = env.step(state, torch.tensor([action]))
        h_obs, h_rew, h_done, _ = host.step(action)
        if h_done:
            # EnvPool worker-loop semantics the device env bakes in: the
            # done step carries the terminal reward and the NEXT episode's
            # reset observation.
            h_obs = host.reset()
        assert bool(ts["done"][0]) == h_done, f"done diverged at t={t}"
        assert float(ts["reward"][0]) == h_rew, f"reward diverged at t={t}"
        np.testing.assert_array_equal(ts["state"][0].numpy(), h_obs, err_msg=f"obs diverged at t={t}")


def test_host_catch_columns_match_jax_host_catch():
    """The host halves of both packages draw the same ball columns."""
    port, ref = jax_envs.host_catch(_threefry.seed(11)), jax_ref.host_catch(jax.random.key(11))
    assert [port._sample_column() for _ in range(50)] == [ref._sample_column() for _ in range(50)]


def test_obs_spec_parity_with_host_envs():
    """One construction surface across backends: the host envs expose the
    same (shape, dtype) obs_spec + num_actions as the JaxEnv protocol."""
    jenv = jax_envs.JaxCatch()
    henv = FlatCatchEnv()
    assert isinstance(jenv, jax_envs.JaxEnv)
    assert jenv.num_actions == henv.num_actions
    j_shape, j_dtype = jenv.obs_spec
    h_shape, h_dtype = henv.obs_spec
    assert tuple(j_shape) == tuple(h_shape)
    assert np.dtype(j_dtype) == np.dtype(h_dtype) == np.uint8
    assert jenv.obs_spec[0] == tuple(jax_ref.JaxCatch().obs_spec[0])

    for env in (CatchEnv(), FlatCatchEnv(), jax_envs.JaxProcCatch()):
        shape, dtype = env.obs_spec
        assert all(int(d) > 0 for d in shape)
        assert np.dtype(dtype) == np.uint8
        assert env.num_actions == 3


def test_batch_step_matches_single():
    """Batching is fold_in(key, i) per env: env i of a batch equals a batch
    of one seeded with that fold."""
    key = _threefry.seed(3)
    env = jax_envs.JaxCatch()
    B = 5
    bstate = jax_envs.batch_init(env, key, B)
    singles = [env.init(_threefry.fold_in(key, i)[None]) for i in range(B)]
    np.testing.assert_array_equal(
        jax_envs.batch_observe(env, bstate).numpy(),
        np.concatenate([env.observe(s).numpy() for s in singles]),
    )
    for _ in range(12):
        actions = torch.arange(B) % 3
        bstate, bts = jax_envs.batch_step(env, bstate, actions)
        for i in range(B):
            singles[i], ts = env.step(singles[i], actions[i:i + 1])
            for k in ("state", "reward", "done"):
                assert torch.equal(bts[k][i:i + 1], ts[k]), (i, k)


def test_auto_reset_on_device():
    """Episode boundary: done fires on the bottom row with +/-1 reward, the
    returned obs is already the NEXT episode's reset frame, and the episode
    counter advances — all in tensor ops, no host branch."""
    env = jax_envs.JaxCatch()
    state = env.init(_threefry.seed(11)[None])
    for t in range(1, 19):  # two full 9-step episodes
        state, ts = env.step(state, torch.tensor([1]))
        if t % (env.rows - 1) == 0:
            assert bool(ts["done"][0])
            assert float(ts["reward"][0]) in (1.0, -1.0)
            board = ts["state"][0].numpy().reshape(env.rows, env.columns)
            assert board[0].max() == 255
            assert int(state["episode"][0]) == t // (env.rows - 1)
        else:
            assert not bool(ts["done"][0])
            assert float(ts["reward"][0]) == 0.0


def test_proc_catch_scenarios():
    """Procedural variant: per-episode scenario draws (column, drift,
    distractor) vary across episodes, the drifting ball stays on the board,
    and the distractor pixel renders at half intensity."""
    env = jax_envs.JaxProcCatch()
    state = env.init(_threefry.seed(5)[None])
    scenarios = []
    for _ in range(5):  # five episodes
        scenarios.append(tuple(int(state[k][0]) for k in ("ball_col", "drift", "distractor_col")))
        for _ in range(env.rows - 1):
            state, ts = env.step(state, torch.tensor([1]))
            assert 0 <= int(state["ball_col"][0]) < env.columns
        assert bool(ts["done"][0])
    assert len(set(scenarios)) > 1, "every episode drew the same scenario"

    obs = env.observe(env.init(_threefry.seed(6)[None])).numpy()
    assert 128 in obs  # distractor pixel
    assert obs.dtype == np.uint8


def test_make_jax_env_factory():
    assert isinstance(jax_envs.make_jax_env("catch_flat"), jax_envs.JaxCatch)
    assert isinstance(jax_envs.make_jax_env("catch_proc"), jax_envs.JaxProcCatch)
    with pytest.raises(ValueError, match="env_backend"):
        jax_envs.make_jax_env("synthetic")


@pytest.mark.parametrize("name", ["catch_flat", "catch_proc"])
def test_envs_bitwise_equal_to_jax_envs(name):
    """1,000 steps of 16 envs on one key and one seeded action stream:
    the port's obs, reward and done equal the JAX envs' bit for bit, across
    every auto-reset (111 episodes per env)."""
    B, S = 16, 1000
    key = jax.random.key(3)
    actions = np.random.default_rng(0).integers(0, 3, (S, B))
    ref, env = jax_ref.make_jax_env(name), jax_envs.make_jax_env(name)
    jstate = jax_ref.batch_init(ref, key, B)
    state = jax_envs.batch_init(env, _raw(key), B)
    np.testing.assert_array_equal(jax_envs.batch_observe(env, state).numpy(),
                                  np.asarray(jax_ref.batch_observe(ref, jstate)))

    def scan(s, a):
        return jax.lax.scan(lambda c, x: jax_ref.batch_step(ref, c, x), s, a)

    _, want = jax.jit(scan)(jstate, jnp.asarray(actions, jnp.int32))
    got = _run(env, state, actions)
    for k, g in zip(("state", "reward", "done"), got):
        np.testing.assert_array_equal(g, np.asarray(want[k]), err_msg=f"{name} {k}")
    assert got[2].sum() == B * (S // (env.rows - 1))  # every episode is 9 steps


# --------------------------------------------------------------------------
# The actor on converted weights
# --------------------------------------------------------------------------


def test_actor_critic_logits_match_jax_on_env_frames():
    """The Anakin actor's forward on the env's own frames (uint8 cast to
    f32): the port's ActorCriticNet on weights converted from the flax tree
    gives the JAX model's logits and baseline within 1e-5."""
    B = 8
    env = jax_envs.JaxProcCatch()
    obs = env.observe(jax_envs.batch_init(env, _threefry.seed(9), B))
    inputs = {
        "state": obs.to(torch.float32)[None],
        "reward": torch.zeros((1, B)),
        "done": torch.zeros((1, B), dtype=torch.bool),
        "prev_action": torch.zeros((1, B), dtype=torch.int64),
    }
    jm = JaxActorCriticNet(num_actions=env.num_actions, use_lstm=False)
    jin = {k: jnp.asarray(v.numpy()) for k, v in inputs.items()}
    params = jax.device_get(jm.init(jax.random.key(0), jin, jm.initial_state(B)))
    want, _ = jm.apply(params, jin, jm.initial_state(B))
    tm = ActorCriticNet(env.num_actions, obs_size=50, use_lstm=False, device="cpu")
    tm.load_state_dict(actor_critic_from_flax(params))
    with torch.no_grad():
        got, _ = tm(inputs, ())
    for k in ("policy_logits", "baseline"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, rtol=0)


# --------------------------------------------------------------------------
# Anakin rollout
# --------------------------------------------------------------------------


def _make_rollout(B, T, seed=0, use_lstm=False, **kwargs):
    env = jax_envs.JaxCatch()
    model = ActorCriticNet(env.num_actions, obs_size=50, use_lstm=use_lstm, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    return rollout.AnakinRollout(model, env, B, T, env_key=_threefry.seed(100 + seed),
                                 act_seed=200 + seed, **kwargs)


@pytest.mark.parametrize("use_lstm", [False, True])
def test_anakin_unroll_equals_per_step(use_lstm):
    """The whole-unroll mode is bitwise equal to the per-step mode over two
    consecutive unrolls (bootstrap + carried last row), initial cores
    included."""
    B, T = 4, 6
    unroll_roll = _make_rollout(B, T, seed=1, use_lstm=use_lstm)
    step_roll = _make_rollout(B, T, seed=1, use_lstm=use_lstm)

    unrolls, cores = [], []
    for _ in range(2):
        unrolls.append(unroll_roll.unroll())
        cores.append(unroll_roll.completed_initial_core)

    steps = []
    for i, n_steps in enumerate((T + 1, T)):  # bootstrap unroll, then steady state
        for _ in range(n_steps):
            step_roll.step()
        steps.append(step_roll.take_unroll())
        for a, b in zip(cores[i], step_roll.completed_initial_core):
            assert torch.equal(a, b), f"unroll {i}: initial core diverged"

    for i in range(2):
        for k in unrolls[i]:
            assert torch.equal(unrolls[i][k], steps[i][k]), f"unroll {i} key {k} diverged"
    assert unroll_roll.frames_done == step_roll.frames_done == B * (2 * T + 1)


def test_anakin_zero_crossing_and_stats():
    """Whole unrolls advance no host-boundary counter; the device episode
    aggregates leave only via stats() on their own counter, and the
    arithmetic matches catch's fixed 9-step episodes."""
    B, T = 4, 40
    roll = _make_rollout(B, T, seed=2)

    before = _counters()
    for _ in range(2):
        roll.unroll()
    after = _counters()

    for name in BOUNDARY:
        assert after.get(name, 0.0) == before.get(name, 0.0), (
            f"{name} advanced during an Anakin unroll — a host staging path "
            "leaked back into the zero-crossing plane"
        )
    frames = B * (2 * T + 1)
    assert after["actor_frames_total"] - before["actor_frames_total"] == frames
    assert after["actor_unrolls_total"] - before["actor_unrolls_total"] == 2

    snap = roll.stats()
    ep_len = jax_envs.JaxCatch().rows - 1
    assert snap["episodes"] == B * ((2 * T + 1) // ep_len)
    assert snap["len_sum"] == snap["episodes"] * ep_len
    assert abs(snap["return_sum"]) <= snap["episodes"]  # rewards are +/-1
    mid = _counters()
    # One snapshot: [ep_return, ep_len] per env and three sums, as float64.
    assert (mid["actor_stats_d2h_bytes_total"]
            - after.get("actor_stats_d2h_bytes_total", 0.0)) == 8 * (2 * B + 3)
    for name in BOUNDARY:  # the snapshot itself stays off the frame counters
        assert mid.get(name, 0.0) == after.get(name, 0.0)


def test_anakin_mode_mixing_raises():
    roll = _make_rollout(2, 4, seed=3)
    roll.step()
    with pytest.raises(RuntimeError, match="mode"):
        roll.unroll()


# --------------------------------------------------------------------------
# --env_backend jax end to end
# --------------------------------------------------------------------------


def test_experiment_env_backend_jax_learns_catch(free_port):
    """``--env_backend jax`` trains IMPALA on the on-device Catch, on the
    CPU: 64 envs (32 × 2 actor batches folded into one rollout), unroll 20,
    learner batch 8, lr 3e-3, 150k frames.  The bar is a mean episode return
    (over the run's last log window) above 0.4; a random policy scores about
    -0.6.  The JAX package's own ``--env_backend jax`` run clears it with
    the same flags and budget: it read 0.83, 0.47, 0.70 and 0.68 at seeds
    0-3, the port 0.88, 0.90, 0.90 and 0.93."""
    from moolib_tpu_torch.examples.vtrace import experiment

    flags = experiment.make_flags([
        "--env", "catch_flat", "--env_backend", "jax", "--device", "cpu", "--quiet",
        "--total_steps", "150000", "--actor_batch_size", "32", "--num_actor_batches", "2",
        "--unroll_length", "20", "--batch_size", "8", "--virtual_batch_size", "8",
        "--learning_rate", "0.003", "--address", f"127.0.0.1:{free_port}",
    ])
    before = _counters()
    out = experiment.train(flags)
    after = _counters()
    assert out["steps"] >= 150_000 and out["sgd_steps"] > 0
    assert out["mean_episode_return"] > 0.4, out
    for name in BOUNDARY:  # the frames reach the learner with no crossing
        assert after.get(name, 0.0) == before.get(name, 0.0), name
