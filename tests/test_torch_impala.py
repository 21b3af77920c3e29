"""Parity of the port's ImpalaNet and ActorCriticNet with the JAX package's
flax models, and of the losses' gradients through them.

Both sides get the same weights (the flax init, converted by
``models.convert``) and the same seeded numpy inputs.  In f32 the outputs
agree within 1e-5 and every gradient within 1e-4 of its largest entry; the
bf16 ImpalaNet is compared loosely.  The last tests each pin one hazard of
the port (SAME pool padding, the done-masked LSTM reset, the converter's
layouts), so a regression names it.
"""

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flax.linen as nn
import jax
import jax.numpy as jnp

from moolib_tpu.examples import a2c as ja2c
from moolib_tpu.examples.vtrace import experiment as jexp
from moolib_tpu.models import ActorCriticNet as JAC
from moolib_tpu.models import ImpalaNet as JNet
from moolib_tpu_torch.examples import a2c as ta2c
from moolib_tpu_torch.examples.vtrace import experiment as texp
from moolib_tpu_torch.models.actor_critic import ActorCriticNet
from moolib_tpu_torch.models.convert import actor_critic_from_flax, impala_from_flax
from moolib_tpu_torch.models.impala import ImpalaNet, max_pool_same, same_pool_padding

torch.set_num_threads(1)

A = 5
LOSS_FLAGS = types.SimpleNamespace(discounting=0.99, baseline_cost=0.5, entropy_cost=0.01)


def _batch(T, B, obs, seed=0, frames=True):
    rng = np.random.default_rng(seed)
    done = rng.random((T, B)) < 0.3
    done[0, 0] = True
    state = (rng.integers(0, 256, (T, B, *obs), dtype=np.uint8) if frames
             else rng.normal(size=(T, B, *obs)).astype(np.float32))
    return {
        "state": state,
        "reward": (2 * rng.normal(size=(T, B))).astype(np.float32),
        "done": done,
        "prev_action": rng.integers(0, A, (T, B)).astype(np.int32),
        "action": rng.integers(0, A, (T, B)).astype(np.int32),
        "policy_logits": rng.normal(size=(T, B, A)).astype(np.float32),
    }


def _core_state(B, H, seed=1):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, H)).astype(np.float32) for _ in range(2))


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    return jax.tree_util.tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _impala(obs, channels, use_lstm, dtype=jnp.float32, T=3, B=2, hidden=16):
    jm = JNet(num_actions=A, channels=channels, use_lstm=use_lstm, hidden_size=hidden,
              dtype=dtype)
    batch = _batch(T, B, obs)
    params = jax.device_get(jax.jit(jm.init)(jax.random.key(0), _jax(batch),
                                            jm.initial_state(B)))
    tm = ImpalaNet(A, obs, channels, use_lstm, hidden,
                   torch.float32 if dtype == jnp.float32 else torch.bfloat16, device="cpu")
    tm.load_state_dict(impala_from_flax(params))
    state = _core_state(B, hidden) if use_lstm else ()
    return jm, params, tm, batch, state


def _actor_critic(use_lstm, T=4, B=3):
    jm = JAC(num_actions=A, use_lstm=use_lstm)
    batch = _batch(T, B, (6,), frames=False)
    params = jax.device_get(jax.jit(jm.init)(jax.random.key(0), _jax(batch),
                                            jm.initial_state(B)))
    tm = ActorCriticNet(A, obs_size=6, use_lstm=use_lstm, device="cpu")
    tm.load_state_dict(actor_critic_from_flax(params))
    state = _core_state(B, 32) if use_lstm else ()
    return jm, params, tm, batch, state


def _assert_outputs(jm, params, tm, batch, state, atol):
    want, want_state = jax.jit(jm.apply)(params, _jax(batch), _jax(state))
    with torch.no_grad():
        got, got_state = tm(_torch(batch), _torch(state))
    for key in ("policy_logits", "baseline"):
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=atol, rtol=0)
    assert len(got_state) == len(want_state)
    for g, w in zip(got_state, want_state):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=0)


@pytest.mark.parametrize("use_lstm", [False, True], ids=["ff", "lstm"])
@pytest.mark.parametrize("obs,channels", [((20, 20, 3), (4, 8)), ((21, 13, 2), (4,))])
def test_impala_matches_flax(obs, channels, use_lstm):
    _assert_outputs(*_impala(obs, channels, use_lstm), atol=1e-5)


@pytest.mark.parametrize("use_lstm", [False, True], ids=["ff", "lstm"])
def test_impala_84x84_matches_flax(use_lstm):
    """The reference frame size: 84 → 42 → 21 → 11 runs all three pool
    paddings ((0, 1), (0, 1), (1, 1)) at the full (16, 32, 32) widths."""
    _assert_outputs(*_impala((84, 84, 4), (16, 32, 32), use_lstm, T=2, B=2), atol=1e-5)


@pytest.mark.parametrize("use_lstm", [False, True], ids=["ff", "lstm"])
def test_actor_critic_matches_flax(use_lstm):
    _assert_outputs(*_actor_critic(use_lstm), atol=1e-5)


def test_impala_bf16_matches_flax_loosely():
    """bf16 convs and Dense_0 round differently in XLA and torch; the f32
    heads keep the outputs within a few hundredths."""
    _assert_outputs(*_impala((84, 84, 4), (16, 32, 32), False, jnp.bfloat16, T=2, B=2),
                    atol=3e-2)


def _assert_grads(want_loss, want_grads, got_loss, model, convert):
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    want = convert(jax.device_get(want_grads))
    got = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        err = (got[name] - w).abs().max().item()
        assert err <= 1e-4 * max(w.abs().max().item(), 1e-6), (name, err)


@pytest.mark.parametrize("model", ["impala_ff", "impala_lstm", "actor_critic_lstm"])
def test_compute_loss_gradients_match_jax(model):
    if model.startswith("impala"):
        jm, params, tm, batch, state = _impala((20, 20, 3), (4, 8), model.endswith("lstm"))
        convert = impala_from_flax
    else:
        jm, params, tm, batch, state = _actor_critic(True)
        convert = actor_critic_from_flax
    (want_loss, _), want_grads = jax.jit(jax.value_and_grad(
        lambda p, b, s: jexp.compute_loss(p, b, s, jm, LOSS_FLAGS), has_aux=True
    ))(_jax(params), _jax(batch), _jax(state))
    got_loss, parts = texp.compute_loss(_torch(batch), _torch(state), tm, LOSS_FLAGS)
    got_loss.backward()
    assert set(parts) == {"pg_loss", "baseline_loss", "entropy_loss"}
    _assert_grads(want_loss, want_grads["params"], got_loss, tm, convert)


@pytest.mark.parametrize("use_lstm", [False, True], ids=["ff", "lstm"])
def test_a2c_loss_gradients_match_jax(use_lstm):
    jm, params, tm, batch, state = _actor_critic(use_lstm)
    (want_loss, _), want_grads = jax.jit(jax.value_and_grad(
        lambda p: ja2c.a2c_loss(p, jm, _jax(batch), _jax(state), 0.99), has_aux=True
    ))(_jax(params))
    got_loss, _ = ta2c.a2c_loss(tm, _torch(batch), _torch(state), 0.99)
    got_loss.backward()
    _assert_grads(want_loss, want_grads["params"], got_loss, tm, actor_critic_from_flax)


@pytest.mark.parametrize("size,pad", [(84, (0, 1)), (42, (0, 1)), (21, (1, 1)), (11, (1, 1)),
                                      (10, (0, 1)), (3, (1, 1)), (1, (1, 1))])
def test_same_pool_padding_per_size(size, pad):
    assert same_pool_padding(size) == pad


@pytest.mark.parametrize("hw", [(84, 84), (42, 21), (11, 10), (5, 6)])
def test_max_pool_same_matches_flax(hw):
    x = np.random.default_rng(0).normal(size=(2, *hw, 3)).astype(np.float32)
    want = np.asarray(nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2), padding="SAME"))
    got = max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_symmetric_torch_padding_would_shift_the_windows_at_84():
    """The hazard the explicit padding avoids: MaxPool2d(padding=1) gives
    the same 42x42 shape at 84 but windows one pixel off."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 3, 84, 84)).astype(np.float32))
    symmetric = F.max_pool2d(x, 3, 2, padding=1)
    assert symmetric.shape == max_pool_same(x).shape
    assert not torch.equal(symmetric, max_pool_same(x))


def _port_model(net, use_lstm):
    """A port model with its own (seeded) init, for tests that need no flax."""
    if net == "impala":
        return (ImpalaNet(A, (20, 20, 3), (4, 8), use_lstm, 16, torch.float32, device="cpu"),
                _batch(3, 2, (20, 20, 3)))
    return ActorCriticNet(A, obs_size=6, use_lstm=use_lstm, device="cpu"), \
        _batch(4, 3, (6,), frames=False)


@pytest.mark.parametrize("net", ["impala", "actor_critic"])
def test_lstm_carry_is_zeroed_where_done(net):
    """A done step starts from a zero carry: with done at t=0 the outputs do
    not depend on the initial state."""
    tm, batch = _port_model(net, use_lstm=True)
    B = batch["done"].shape[1]
    state, zeros = _core_state(B, tm.core.hidden), tm.initial_state(B)
    batch["done"][0, :] = True
    with torch.no_grad():
        a, _ = tm(_torch(batch), _torch(state))
        b, _ = tm(_torch(batch), zeros)
        batch["done"][0, :] = False
        c, _ = tm(_torch(batch), _torch(state))
    torch.testing.assert_close(a["policy_logits"], b["policy_logits"], rtol=0, atol=0)
    assert not torch.equal(a["policy_logits"][0], c["policy_logits"][0])


def test_converter_layouts():
    _, params, tm, _, _ = _impala((20, 20, 3), (4, 8), True)
    sd = impala_from_flax(params)
    flax_conv = params["params"]["ImpalaEncoder_0"]["Conv_1"]["kernel"]  # [kh, kw, in, out]
    conv = sd["ImpalaEncoder_0.Conv_1.kernel"]  # [out, in, kh, kw]
    assert conv.shape == (8, 4, 3, 3)
    assert conv[5, 2, 0, 1].item() == flax_conv[0, 1, 2, 5]
    cell = params["params"]["Scan_Core_0"]["OptimizedLSTMCell_0"]
    for k, gate in enumerate("ifgo"):
        np.testing.assert_array_equal(sd["core.input_kernel"][:, 16 * k:16 * (k + 1)].numpy(),
                                      cell["i" + gate]["kernel"])
        np.testing.assert_array_equal(sd["core.bias"][16 * k:16 * (k + 1)].numpy(),
                                      cell["h" + gate]["bias"])
    assert sd["policy.kernel"].shape == (16, A) and sd["baseline.kernel"].shape == (16, 1)


@pytest.mark.parametrize("net", ["impala", "actor_critic"])
def test_sampling_follows_the_generator(net):
    tm, batch = _port_model(net, use_lstm=False)
    state = ()
    with torch.no_grad():
        a, _ = tm(_torch(batch), state, sample_generator=torch.Generator().manual_seed(3))
        b, _ = tm(_torch(batch), state, sample_generator=torch.Generator().manual_seed(3))
        plain, _ = tm(_torch(batch), state)
    assert "action" not in plain
    assert a["action"].shape == batch["action"].shape and a["action"].dtype == torch.int64
    assert torch.equal(a["action"], b["action"])
    assert ((a["action"] >= 0) & (a["action"] < A)).all()


def test_model_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the no-CUDA behaviour cannot show")
    from moolib_tpu_torch._device import NoCudaError

    with pytest.raises(NoCudaError):
        ImpalaNet(A)
    with pytest.raises(NoCudaError):
        ActorCriticNet(A)
