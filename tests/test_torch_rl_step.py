"""One learner step of the port against the JAX package's.

The optimizers are held against optax on identical gradients (within
1e-6); then whole steps — loss, backward and the optax-form update — run
from the same weights and batch on both sides: the V-trace learner
(``clip_by_global_norm`` then ``rmsprop(lr, 0.99, 0.01)``) and A2C
(``clip_by_global_norm(100)`` then ``adam(b1=0, b2=0.99, eps=3e-7)``),
compared on the loss and every updated parameter.  Last, the bench's
learner step: the same batch draws as the root ``bench.py``, and a finite,
falling loss on the CPU.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from moolib_tpu.examples import a2c as ja2c
from moolib_tpu.examples.vtrace import experiment as jexp
from moolib_tpu.models import ActorCriticNet as JAC
from moolib_tpu.models import ImpalaNet as JNet
from moolib_tpu_torch import bench as tbench
from moolib_tpu_torch.examples import a2c as ta2c
from moolib_tpu_torch.examples import common
from moolib_tpu_torch.examples.vtrace import experiment as texp
from moolib_tpu_torch.models.actor_critic import ActorCriticNet
from moolib_tpu_torch.models.convert import actor_critic_from_flax, impala_from_flax
from moolib_tpu_torch.models.impala import ImpalaNet

torch.set_num_threads(1)

A = 4


def _shapes():
    return [(5, 3), (7,), (2, 3, 4)]


def _grads(seed, scale):
    rng = np.random.default_rng(seed)
    return [(scale * rng.normal(size=s)).astype(np.float32) for s in _shapes()]


CHAINS = {
    "rmsprop": (lambda: [optax.rmsprop(1e-2, decay=0.99, eps=0.01)],
                lambda: [common.rmsprop(1e-2, decay=0.99, eps=0.01)]),
    "clip_rmsprop": (lambda: [optax.clip_by_global_norm(1.0), optax.rmsprop(1e-3, 0.99, 0.01)],
                     lambda: [common.clip_by_global_norm(1.0), common.rmsprop(1e-3, 0.99, 0.01)]),
    "clip_adam": (lambda: [optax.clip_by_global_norm(2.0),
                           optax.adam(1e-3, b1=0.0, b2=0.99, eps=3e-7)],
                  lambda: [common.clip_by_global_norm(2.0),
                           common.adam(1e-3, b1=0.0, b2=0.99, eps=3e-7)]),
    "adam": (lambda: [optax.adam(1e-2)], lambda: [common.adam(1e-2)]),
}


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_optimizer_matches_optax(chain):
    """Three updates on identical gradients, the first above the clip norm
    and the later ones below it."""
    make_j, make_t = CHAINS[chain]
    init = _grads(0, 1.0)
    opt = optax.chain(*make_j())
    jp = [jnp.asarray(p) for p in init]
    state = opt.init(jp)
    tp = [torch.tensor(p, requires_grad=True) for p in init]
    topt = common.OptaxOptimizer(tp, *make_t())
    for i, scale in enumerate((3.0, 0.05, 0.2)):
        g = _grads(i + 1, scale)
        updates, state = opt.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for t, x in zip(tp, g):
            t.grad = torch.from_numpy(x)
        topt.step()
        for want, got in zip(jp, tp):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_clip_by_global_norm_is_optax_rule():
    """Scaled by max_norm / g only where g >= max_norm; left alone below."""
    clip = common.clip_by_global_norm(5.0)
    small = [torch.full((4,), 1.0)]  # norm 2
    assert torch.equal(clip.update([small[0].clone()], None)[0], small[0])
    big = [torch.full((4,), 10.0)]  # norm 20
    torch.testing.assert_close(clip.update(big, None)[0], torch.full((4,), 2.5))


def test_optimizer_step_needs_every_gradient():
    p = [torch.zeros(2, requires_grad=True), torch.zeros(3, requires_grad=True)]
    opt = common.OptaxOptimizer(p, common.rmsprop(1e-3))
    p[0].grad = torch.ones(2)
    with pytest.raises(RuntimeError, match="no gradient"):
        opt.step()


def _batch(T, B, obs, frames, seed=0):
    rng = np.random.default_rng(seed)
    done = rng.random((T, B)) < 0.25
    done[-1, 0] = True
    state = (rng.integers(0, 256, (T, B, *obs), dtype=np.uint8) if frames
             else rng.normal(size=(T, B, *obs)).astype(np.float32))
    return {
        "state": state,
        "reward": rng.normal(size=(T, B)).astype(np.float32),
        "done": done,
        "prev_action": rng.integers(0, A, (T, B)).astype(np.int32),
        "action": rng.integers(0, A, (T, B)).astype(np.int32),
        "policy_logits": rng.normal(size=(T, B, A)).astype(np.float32),
    }


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _optax_step(opt):
    def step(grads, opt_state, params):
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    return step


def _assert_params(want_params, model, convert, atol=2e-6):
    want = convert(jax.device_get(want_params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=atol, rtol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("use_lstm,clip", [(False, 40.0), (True, 0.05)],
                         ids=["ff-unclipped", "lstm-clipped"])
def test_vtrace_learner_steps_match_jax(use_lstm, clip):
    """Two learner steps, JAX ``value_and_grad`` + optax against the port's
    forward, backward and ``make_optimizer(...).step()``."""
    flags = types.SimpleNamespace(discounting=0.99, baseline_cost=0.5, entropy_cost=0.01,
                                  grad_norm_clipping=clip, learning_rate=1e-3)
    obs, channels, B = (12, 12, 2), (4, 8), 2
    jm = JNet(num_actions=A, channels=channels, use_lstm=use_lstm, hidden_size=16,
              dtype=jnp.float32)
    batch = _batch(3, B, obs, True)
    params = jax.jit(jm.init)(jax.random.key(0), _to_jax(batch), jm.initial_state(B))
    opt = optax.chain(optax.clip_by_global_norm(clip),
                      optax.rmsprop(flags.learning_rate, decay=0.99, eps=0.01))
    opt_state = opt.init(params)
    update = jax.jit(_optax_step(opt))
    tm = ImpalaNet(A, obs, channels, use_lstm, 16, torch.float32, device="cpu")
    tm.load_state_dict(impala_from_flax(jax.device_get(params)))
    topt = texp.make_optimizer(tm.parameters(), flags)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jexp.compute_loss(p, b, jm.initial_state(B), jm, flags), has_aux=True))
    for step in range(2):
        batch = _batch(3, B, obs, True, seed=step)
        (want_loss, _), grads = grad_fn(params, _to_jax(batch))
        params, opt_state = update(grads, opt_state, params)
        topt.zero_grad()
        loss, _ = texp.compute_loss(_to_torch(batch), tm.initial_state(B), tm, flags)
        loss.backward()
        topt.step()
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
        _assert_params(params, tm, impala_from_flax)


@pytest.mark.parametrize("use_lstm", [False, True], ids=["ff", "lstm"])
def test_a2c_learner_steps_match_jax(use_lstm):
    """Adam with b1 = 0 takes a sign-like step, -lr * g / (|g| + 3e-7):
    where |g| is near eps the step magnifies f32 rounding of the gradient,
    so parameters are held to 1% of the learning rate."""
    jm = JAC(num_actions=A, use_lstm=use_lstm)
    B = 3
    batch = _batch(5, B, (4,), False)
    params = jax.jit(jm.init)(jax.random.key(0), _to_jax(batch), jm.initial_state(B))
    opt = optax.chain(optax.clip_by_global_norm(100.0),
                      optax.adam(1e-3, b1=0.0, b2=0.99, eps=3e-7))
    opt_state = opt.init(params)
    update = jax.jit(_optax_step(opt))
    tm = ActorCriticNet(A, obs_size=4, use_lstm=use_lstm, device="cpu")
    tm.load_state_dict(actor_critic_from_flax(jax.device_get(params)))
    topt = ta2c.make_optimizer(tm.parameters(), 1e-3)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: ja2c.a2c_loss(p, jm, b, jm.initial_state(B), 0.99), has_aux=True))
    for step in range(2):
        batch = _batch(5, B, (4,), False, seed=step)
        (want_loss, _), grads = grad_fn(params, _to_jax(batch))
        params, opt_state = update(grads, opt_state, params)
        topt.zero_grad()
        loss, _ = ta2c.a2c_loss(tm, _to_torch(batch), tm.initial_state(B), 0.99)
        loss.backward()
        topt.step()
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
        _assert_params(params, tm, actor_critic_from_flax, atol=1e-5)


def test_bench_batch_draws_match_the_root_bench(monkeypatch):
    import bench as root_bench

    monkeypatch.setattr(root_bench, "T", 1)
    monkeypatch.setattr(root_bench, "B", 2)
    monkeypatch.setattr(root_bench, "CHANNELS", (2,))  # the batch does not depend on it
    _, _, _, want = root_bench.build_step()
    got = tbench.make_batch(1, 2, "cpu")
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(value), err_msg=key)


def test_bench_step_runs_on_the_cpu():
    step, model, _, batch = tbench.build_step("cpu", t=2, b=2)
    assert batch["state"].shape == (3, 2, 84, 84, 4) and batch["state"].dtype == torch.uint8
    assert model.dtype == torch.bfloat16 and not model.use_lstm
    before = model.Dense_0.kernel.detach().clone()
    losses = [step() for _ in range(3)]
    assert all(torch.isfinite(x) and x.ndim == 0 for x in losses)
    assert not torch.equal(before, model.Dense_0.kernel)  # updated in place


def test_bench_flops_and_names():
    assert tbench.analytic_forward_flops() == pytest.approx(72.878e9, rel=1e-4)
    assert tbench.metric_name(20, 32, (16, 32, 32)) == "impala_learner_sps"
    assert tbench.metric_name(2, 2, (16, 32, 32)) == "impala_learner_sps_smoke"
    assert tbench.metric_name(20, 32, (64, 128, 128)) == "impala_learner_sps_wide"
