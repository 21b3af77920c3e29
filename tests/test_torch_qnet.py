"""The port's RecurrentQNet and the R2D2 ``td_loss`` against the JAX
package's, with the same weights (``models.convert.qnet_from_flax``) and the
same numpy inputs.

Tolerances: in f32, q and the final LSTM core within 1e-5, the loss and
the per-sequence priorities within 1e-5, and every gradient within 1e-4 of
its largest element (``jax.value_and_grad`` of the JAX ``td_loss``).  In
bf16 (the encoder and the two hidden Dense layers round to bf16 in both
packages, in a different accumulation order) q and the loss within
3e-2 x max(1, max|ref|)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from moolib_tpu.examples.r2d2 import td_loss as jax_td_loss
from moolib_tpu.models.qnet import RecurrentQNet as JaxQNet
from moolib_tpu_torch.examples.r2d2 import td_loss
from moolib_tpu_torch.models import RecurrentQNet
from moolib_tpu_torch.models.convert import qnet_from_flax

torch.set_num_threads(1)

T, B, A = 4, 3, 6
CASES = {"mlp": dict(encoder="mlp", obs=(5,)),
         "impala": dict(encoder="impala", obs=(12, 12, 4), channels=(4, 8))}


def _batch(obs, pixel: bool, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    done = rng.random((T + 1, B)) < 0.2
    done[1, 0] = True
    return {
        "state": (rng.integers(0, 256, size=(T + 1, B, *obs), dtype=np.uint8) if pixel
                  else rng.normal(size=(T + 1, B, *obs)).astype(np.float32)),
        "done": done,
        "action": rng.integers(0, A, size=(T + 1, B)).astype(np.int32),
        "reward": rng.normal(size=(T + 1, B)).astype(np.float32),
        "is_weight": (rng.random(B) + 0.5).astype(np.float32),
        "core": tuple(rng.normal(size=(B, 8)).astype(np.float32) for _ in range(2)),
    }


def _pair(name: str, dtype, seed: int = 0):
    """(flax model, flax params, port model with the same weights)."""
    case = CASES[name]
    kw = dict(num_actions=A, hidden_size=16, core_size=8, encoder=case["encoder"])
    if "channels" in case:
        kw["channels"] = case["channels"]
    jm = JaxQNet(dtype={torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype], **kw)
    batch = _batch(case["obs"], name == "impala")
    params = jm.init(jax.random.key(seed), {k: jnp.asarray(batch[k][:1]) for k in
                                            ("state", "done")}, jm.initial_state(B))
    params = jax.device_get(params)
    pm = RecurrentQNet(dtype=dtype, obs_shape=case["obs"], device="cpu", **kw)
    pm.load_state_dict(qnet_from_flax(params))
    return jm, params, pm, batch


def _torch(batch: dict) -> dict:
    out = {k: torch.from_numpy(v) for k, v in batch.items() if k != "core"}
    out["core"] = tuple(torch.from_numpy(c) for c in batch["core"])
    return out


def _jax(batch: dict) -> dict:
    out = {k: jnp.asarray(v) for k, v in batch.items() if k != "core"}
    out["core"] = tuple(jnp.asarray(c) for c in batch["core"])
    return out


def _err(got: torch.Tensor, want) -> float:
    return float(np.abs(got.detach().float().numpy() - np.asarray(want, np.float32)).max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_flax(name):
    jm, params, pm, batch = _pair(name, torch.float32)
    jb, tb = _jax(batch), _torch(batch)
    jout, jcore = jm.apply(params, jb, jb["core"])
    out, core = pm(tb, tb["core"])
    assert out["q"].shape == (T + 1, B, A)
    assert _err(out["q"], jout["q"]) <= 1e-5
    assert max(_err(c, jc) for c, jc in zip(core, jcore)) <= 1e-5


@pytest.mark.parametrize("name", sorted(CASES))
def test_td_loss_and_every_gradient_match_jax(name):
    """Online and target networks with different weights; the loss, the
    R2D2 priorities and the gradient of every parameter."""
    jm, params, pm, batch = _pair(name, torch.float32, seed=0)
    _, tparams, tm, _ = _pair(name, torch.float32, seed=1)
    jb = _jax(batch)
    (jloss, jprio), jgrads = jax.value_and_grad(
        lambda p: jax_td_loss(p, tparams, jm, jb, 0.99), has_aux=True)(params)
    loss, prio = td_loss(pm, tm, _torch(batch), 0.99)
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= 1e-5
    assert prio.shape == (B,) and not prio.requires_grad
    assert _err(prio, jprio) <= 1e-5
    want = qnet_from_flax(jax.device_get(jgrads))
    grads = {n: p.grad for n, p in pm.named_parameters()}
    assert set(grads) == set(want)
    for n, g in grads.items():
        scale = float(want[n].abs().max())
        assert scale > 0, f"no gradient reached {n}"
        assert float((g - want[n]).abs().max()) <= 1e-4 * scale, n
    assert all(p.grad is None for p in tm.parameters())  # the target takes none


@pytest.mark.parametrize("name", sorted(CASES))
def test_bf16_forward_and_loss_match_flax_loosely(name):
    jm, params, pm, batch = _pair(name, torch.bfloat16)
    jb, tb = _jax(batch), _torch(batch)
    jq = np.asarray(jm.apply(params, jb, jb["core"])[0]["q"], np.float32)
    q = pm(tb, tb["core"])[0]["q"]
    assert q.dtype == torch.float32  # the dueling heads run in f32
    assert _err(q, jq) <= 3e-2 * max(1.0, np.abs(jq).max())
    jloss, _ = jax_td_loss(params, params, jm, jb, 0.99)
    loss, _ = td_loss(pm, pm, tb, 0.99)
    assert abs(loss.item() - float(jloss)) <= 3e-2 * max(1.0, abs(float(jloss)))


def test_model_contract():
    model = RecurrentQNet(num_actions=3, obs_shape=(4,), device="cpu")
    c, h = model.initial_state(5)
    assert c.shape == h.shape == (5, 64) and c.dtype == torch.float32
    assert RecurrentQNet(num_actions=3, obs_shape=(4,), use_lstm=False,
                         device="cpu").initial_state(5) == ()
    x = {"state": torch.zeros(2, 5, 4), "done": torch.zeros(2, 5, dtype=torch.bool)}
    out, _ = model(x, (c, h))
    # Dueling: the advantages are centred, so q's mean over actions is V.
    assert torch.allclose(out["q"].mean(-1), model.Dense_2(model.core(
        torch.relu(model.Dense_1(torch.relu(model.Dense_0(x["state"].reshape(10, 4))))).reshape(
            2, 5, -1), torch.ones(2, 5), (c, h))[0].reshape(10, -1)).reshape(2, 5), atol=1e-6)
    with pytest.raises(ValueError, match="encoder"):
        RecurrentQNet(num_actions=2, encoder="resnet50", device="cpu")
    with pytest.raises(ValueError, match="obs_shape"):
        RecurrentQNet(num_actions=2, device="cpu")
