"""The port's DeviceRollout against the JAX package's, on the CPU: the same
converted ImpalaNet / ActorCriticNet weights and the same observation
stream through both rollouts.

- The rows that do not depend on the draw (``state``, ``reward``,
  ``done``) are bitwise equal; row 0's ``policy_logits`` (before any draw
  feeds back through ``prev_action``) agree within 1e-5.
- torch cannot reproduce ``jax.random``, so the action column is held to
  its contract instead: actions in range, ``prev_action[t+1] ==
  action[t]`` within and across unrolls, and the draw frequencies of a
  fixed logit row within a chi-square bound.
- The carry: row 0 of the next buffer is row T of the completed one, and
  ``completed_initial_core`` is the LSTM state entering the unroll.
- Stepping after ``take_unroll()`` leaves the handed-over unroll unchanged
  (each unroll gets a fresh buffer).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moolib_tpu import rollout as jax_rollout
from moolib_tpu.models import ActorCriticNet as JAC
from moolib_tpu.models import ImpalaNet as JNet
from moolib_tpu_torch import rollout
from moolib_tpu_torch.models.actor_critic import ActorCriticNet
from moolib_tpu_torch.models.convert import actor_critic_from_flax, impala_from_flax
from moolib_tpu_torch.models.impala import ImpalaNet

torch.set_num_threads(1)

A, B, T = 5, 3, 4


def _obs_stream(n, obs_shape, frames, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        state = (rng.integers(0, 256, (B, *obs_shape), dtype=np.uint8) if frames
                 else rng.normal(size=(B, *obs_shape)).astype(np.float32))
        out.append({"state": state, "reward": rng.normal(size=B).astype(np.float32),
                    "done": rng.random(B) < 0.3})
    return out


def _models(kind):
    if kind == "impala":
        obs, frames = (12, 12, 2), True
        jm = JNet(num_actions=A, channels=(16, 32), use_lstm=False, hidden_size=16,
                  dtype=jnp.float32)
        tm = ImpalaNet(A, obs, (16, 32), False, 16, torch.float32, device="cpu")
        convert = impala_from_flax
    else:
        obs, frames = (6,), False
        jm = JAC(num_actions=A, use_lstm=True)
        tm = ActorCriticNet(A, obs_size=6, use_lstm=True, device="cpu")
        convert = actor_critic_from_flax
    dummy = {
        "state": jnp.zeros((1, B, *obs), jnp.float32), "reward": jnp.zeros((1, B)),
        "done": jnp.zeros((1, B), bool), "prev_action": jnp.zeros((1, B), jnp.int32),
    }
    params = jax.device_get(jm.init(jax.random.key(0), dummy, jm.initial_state(B)))
    tm.load_state_dict(convert(params))
    dtype = np.uint8 if frames else np.float32
    return jm, params, tm, obs, frames, dtype


def _run_both(kind, steps):
    jm, params, tm, obs, frames, dtype = _models(kind)
    stream = _obs_stream(steps, obs, frames)
    jr = jax_rollout.DeviceRollout(jm, B, T, obs, dtype, A)
    pr = rollout.DeviceRollout(tm, B, T, obs, dtype, A, seed=0)
    key = jax.random.key(1)
    ju, pu, cores, pinit = [], [], [], []
    for o in stream:
        cores.append(pr.core_state)
        pending, key = jr.step(params, o, key)
        pending.realize()
        pp = pr.step(o)
        pp.realize()
        u = jr.take_unroll()
        if u is not None:
            ju.append(jax.device_get(u))
        u = pr.take_unroll()
        if u is not None:
            pu.append({k: v.clone() for k, v in u.items()})
            pinit.append(pr.completed_initial_core)
    return ju, pu, cores, pinit, pr


@pytest.mark.parametrize("kind", ["impala", "actor_critic_lstm"])
def test_rows_independent_of_the_draw_match_the_jax_rollout(kind):
    ju, pu, _, _, _ = _run_both(kind, 1 + 3 * T)
    assert len(ju) == len(pu) == 3
    for j, p in zip(ju, pu):
        for key in ("state", "reward", "done"):
            assert p[key].numpy().tobytes() == np.asarray(j[key]).astype(
                p[key].numpy().dtype).tobytes(), key
        assert p["state"].dtype == (torch.uint8 if kind == "impala" else torch.float32)
    np.testing.assert_allclose(pu[0]["policy_logits"][0].numpy(),
                               np.asarray(ju[0]["policy_logits"][0]), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", ["impala", "actor_critic_lstm"])
def test_action_column_and_carry(kind):
    _, pu, cores, pinit, pr = _run_both(kind, 1 + 3 * T)
    for u in pu:
        act, prev = u["action"].numpy(), u["prev_action"].numpy()
        assert act.min() >= 0 and act.max() < A
        np.testing.assert_array_equal(prev[1:], act[:-1])
    np.testing.assert_array_equal(pu[0]["prev_action"][0].numpy(), 0)
    for u, nxt in zip(pu, pu[1:]):
        for key in u:  # the carry: row 0 of the next unroll is row T of this one
            assert torch.equal(nxt[key][0], u[key][T]), key
    for key, v in pr._buf.items():  # and of the buffer being filled
        assert torch.equal(v[0], pu[-1][key][T]), key
    # The LSTM state entering each unroll: step 0 for the first, then the
    # state entering the carried step (index T, T + T, ...).
    for i, init in enumerate(pinit):
        want = cores[0] if i == 0 else cores[i * T]
        assert len(init) == len(want)
        for a, b in zip(init, want):
            assert torch.equal(a, b)


def test_handed_over_unroll_is_never_written_again():
    jm, params, tm, obs, frames, dtype = _models("impala")
    pr = rollout.DeviceRollout(tm, B, T, obs, dtype, A, seed=3)
    stream = _obs_stream(1 + 2 * T, obs, frames, seed=5)
    for o in stream[:T + 1]:
        pr.step(o).realize()
    handed = pr.take_unroll()
    assert handed is not None and pr.take_unroll() is None
    copy = {k: v.clone() for k, v in handed.items()}
    for o in stream[T + 1:]:
        pr.step(o).realize()
    assert pr.take_unroll() is not None
    for k in handed:
        assert torch.equal(handed[k], copy[k]), k


def test_draw_frequencies_of_a_fixed_logit_row():
    """A model whose logits are the same row at every step: the sampled
    actions' frequencies over 64 x 200 draws against softmax(row), with
    chi-square below 40 (4 degrees of freedom: p < 1e-7 for a fair
    sampler)."""
    tm = ActorCriticNet(A, obs_size=6, use_lstm=False, device="cpu")
    row = torch.tensor([0.5, -1.0, 0.0, 1.5, -0.3])
    with torch.no_grad():
        for p in tm.parameters():
            p.zero_()
        tm.policy.bias.copy_(row)
    n = 64
    pr = rollout.DeviceRollout(tm, n, T, (6,), np.float32, A, seed=11)
    rng = np.random.default_rng(0)
    counts = np.zeros(A)
    steps = 200
    for _ in range(steps):
        o = {"state": rng.normal(size=(n, 6)).astype(np.float32),
             "reward": np.zeros(n, np.float32), "done": np.zeros(n, bool)}
        counts += np.bincount(pr.step(o).realize(), minlength=A)
    p = torch.softmax(row, 0).numpy()
    expected = p * n * steps
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 40.0, (chi2, counts, expected)


def test_pending_action_and_boundary_counters():
    from moolib_tpu_torch import telemetry

    reg = telemetry.get_registry()
    vals = lambda: reg.counter_values()
    before = vals()
    jm, params, tm, obs, frames, dtype = _models("impala")
    pr = rollout.DeviceRollout(tm, B, T, obs, dtype, A, seed=0)
    o = _obs_stream(1, obs, frames)[0]
    pending = pr.step(o)
    got = pending.realize()
    assert got.dtype == np.int64 and got.shape == (B,)
    assert np.asarray(pending).tobytes() == got.tobytes()
    after = vals()
    h2d = o["state"].nbytes + o["reward"].nbytes + o["done"].nbytes
    assert after.get("actor_h2d_bytes_total", 0) - before.get("actor_h2d_bytes_total", 0) == h2d
    assert after.get("actor_frames_total", 0) - before.get("actor_frames_total", 0) == B
    assert after.get("actor_d2h_bytes_total", 0) - before.get("actor_d2h_bytes_total", 0) == got.nbytes
