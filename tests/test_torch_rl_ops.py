"""Parity of the port's RL ops with the JAX package's: V-trace, n-step
returns, GAE, the entropy loss and the per-step cross entropy, on the same
seeded numpy inputs, in f32.  Episodes end at the first and last step too,
where a reverse recurrence is easiest to get wrong."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from moolib_tpu.ops import returns as jret
from moolib_tpu.ops import vtrace as jvt
from moolib_tpu_torch.ops import returns as tret
from moolib_tpu_torch.ops import vtrace as tvt

torch.set_num_threads(1)

T, B, A = 7, 5, 4
TOL = dict(atol=1e-6, rtol=1e-6)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    done = rng.random((T, B)) < 0.3
    done[0, 0] = done[-1, 1] = True  # an episode ends at the first and the last step
    return {
        "behavior_logits": rng.normal(size=(T, B, A)).astype(np.float32),
        "target_logits": rng.normal(size=(T, B, A)).astype(np.float32),
        "actions": rng.integers(0, A, (T, B)).astype(np.int32),
        "discounts": ((~done) * 0.99).astype(np.float32),
        "rewards": rng.normal(size=(T, B)).astype(np.float32),
        "values": rng.normal(size=(T, B)).astype(np.float32),
        "bootstrap": rng.normal(size=(B,)).astype(np.float32),
        "log_rhos": (0.5 * rng.normal(size=(T, B))).astype(np.float32),
    }


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), **TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_from_logits_matches_jax(seed):
    x = _inputs(seed)
    args = ("behavior_logits", "target_logits", "actions", "discounts", "rewards", "values",
            "bootstrap")
    want = jvt.from_logits(*(_j(x[k]) for k in args))
    got = tvt.from_logits(*(_t(x[k]) for k in args))
    for field in jvt.VTraceFromLogitsReturns._fields:
        _close(getattr(got, field), getattr(want, field))


@pytest.mark.parametrize("lambda_,clip_rho,clip_pg", [(1.0, 1.0, 1.0), (0.9, 1.0, 1.0),
                                                      (0.5, 2.0, 0.5)])
def test_from_importance_weights_matches_jax(lambda_, clip_rho, clip_pg):
    x = _inputs(2)
    args = ("log_rhos", "discounts", "rewards", "values", "bootstrap")
    want = jvt.from_importance_weights(*(_j(x[k]) for k in args), clip_rho, clip_pg, lambda_)
    got = tvt.from_importance_weights(*(_t(x[k]) for k in args), clip_rho, clip_pg, lambda_)
    _close(got.vs, want.vs)
    _close(got.pg_advantages, want.pg_advantages)


def test_vtrace_targets_are_detached():
    x = _inputs(3)
    target = _t(x["target_logits"]).requires_grad_()
    values = _t(x["values"]).requires_grad_()
    got = tvt.from_logits(_t(x["behavior_logits"]), target, _t(x["actions"]),
                          _t(x["discounts"]), _t(x["rewards"]), values, _t(x["bootstrap"]))
    assert not got.vs.requires_grad and not got.pg_advantages.requires_grad
    assert got.target_action_log_probs.requires_grad and got.log_rhos.requires_grad


def test_discounted_returns_matches_jax():
    x = _inputs(4)
    want = jret.discounted_returns(_j(x["rewards"]), _j(x["discounts"]), _j(x["bootstrap"]))
    got = tret.discounted_returns(_t(x["rewards"]), _t(x["discounts"]), _t(x["bootstrap"]))
    _close(got, want)


@pytest.mark.parametrize("lambda_", [0.95, 1.0])
def test_gae_matches_jax(lambda_):
    x = _inputs(5)
    args = ("rewards", "values", "discounts", "bootstrap")
    want = jret.generalized_advantage_estimation(*(_j(x[k]) for k in args), lambda_)
    values = _t(x["values"]).requires_grad_()
    got = tret.generalized_advantage_estimation(
        _t(x["rewards"]), values, _t(x["discounts"]), _t(x["bootstrap"]), lambda_)
    for g, w in zip(got, want):
        assert not g.requires_grad
        _close(g, w)


def test_entropy_and_cross_entropy_match_jax():
    x = _inputs(6)
    _close(tret.entropy_loss(_t(x["target_logits"])), jret.entropy_loss(_j(x["target_logits"])))
    _close(tret.softmax_cross_entropy(_t(x["target_logits"]), _t(x["actions"])),
           jret.softmax_cross_entropy(_j(x["target_logits"]), _j(x["actions"])))
    _close(tvt.action_log_probs(_t(x["behavior_logits"]), _t(x["actions"])),
           jvt.action_log_probs(_j(x["behavior_logits"]), _j(x["actions"])))
