"""Parity of the port's TransformerLM with the JAX package's flax model.

Both get the same weights: the flax init, converted by
``models.convert.from_flax``.  Tokens come from numpy with a seed.  The JAX
flash path runs the Pallas kernel in interpret mode (T=128 tiles); the
port's runs its plain version on the CPU.  The last tests each pin one
numerical hazard of the port, so a regression names it.
"""

import importlib

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from moolib_tpu.models import transformer as jtf
from moolib_tpu_torch.models import transformer as ttf
from moolib_tpu_torch.models.convert import from_flax
from moolib_tpu_torch.ops.paged_attention import gathered_decode_attention

jax_paged = importlib.import_module("moolib_tpu.ops.paged_attention")

torch.set_num_threads(1)

V, D, H, L, T = 64, 64, 2, 2, 128


def _models(attention, pos, kv_heads, max_len=T + 16):
    cfg = dict(vocab_size=V, d_model=D, num_heads=H, num_kv_heads=kv_heads, num_layers=L,
               max_len=max_len, attention=attention, pos_embedding=pos)
    jm = jtf.TransformerLM(dtype=jnp.float32, **cfg)
    tokens = np.random.default_rng(0).integers(0, V, (2, T)).astype(np.int32)
    params = jm.init(jax.random.key(0), jnp.asarray(tokens))
    tm = ttf.TransformerLM(dtype=torch.float32, device="cpu", **cfg)
    tm.load_state_dict(from_flax(jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, tm, tokens


@pytest.mark.parametrize("kv_heads", [None, 1])
@pytest.mark.parametrize("pos", ["learned", "rotary"])
@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_logits_match_flax(attention, pos, kv_heads):
    jm, params, tm, tokens = _models(attention, pos, kv_heads)
    want = np.asarray(jm.apply(params, jnp.asarray(tokens)))
    with torch.inference_mode():
        got = tm(torch.from_numpy(tokens)).numpy()
    assert got.dtype == np.float32 and got.shape == (2, T, V)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize(
    "attention,pos,kv_heads", [("dense", "learned", None), ("flash", "rotary", 1)]
)
def test_greedy_generate_matches_jax(attention, pos, kv_heads):
    jm, params, tm, tokens = _models(attention, pos, kv_heads)
    want = np.asarray(jtf.generate(jm, params, jnp.asarray(tokens), 8))
    with torch.inference_mode():
        got = ttf.generate(tm, torch.from_numpy(tokens), 8).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_generate_refuses_what_jax_refuses():
    _, _, tm, tokens = _models("dense", "rotary", None, max_len=T + 4)
    with pytest.raises(ValueError, match="cache capacity"):
        ttf.generate(tm, torch.from_numpy(tokens), 8)
    with pytest.raises(ValueError, match="torch.Generator"):
        ttf.generate(tm, torch.from_numpy(tokens), 2, temperature=1.0)
    with pytest.raises(ValueError, match=r"\[0, 64\)"):
        ttf.generate(tm, torch.full((1, 4), V), 2)
    g = torch.Generator().manual_seed(0)
    out = ttf.generate(tm, torch.from_numpy(tokens), 2, temperature=1.0, generator=g)
    assert out.shape == (2, T + 2)


@pytest.mark.parametrize("per_row", [False, True])
def test_gathered_decode_attention_matches_jax(per_row):
    rng = np.random.default_rng(4)
    B, Hq, Hk, hd, Tc = 3, 4, 2, 8, 24
    q = rng.standard_normal((B, 1, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, Tc, Hk, hd)).astype(np.float32)
    v = rng.standard_normal((B, Tc, Hk, hd)).astype(np.float32)
    t = np.array([3, 10, 23], np.int32) if per_row else 13
    want = jax_paged.gathered_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(t))
    t_port = torch.from_numpy(t) if per_row else t
    got = gathered_decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), t_port)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_hazard_layernorm_epsilon_is_flax_1e_6():
    # Near-constant rows: the variance (~1e-6) is comparable to epsilon, so
    # torch's 1e-5 default would be off by tens of percent.
    x = (1e-3 * np.random.default_rng(1).standard_normal((4, 16))).astype(np.float32)
    ln = nn.LayerNorm(dtype=jnp.float32)
    p = ln.init(jax.random.key(0), jnp.asarray(x))
    want = np.asarray(ln.apply(p, jnp.asarray(x)))
    got = ttf.LayerNorm(16, device="cpu")(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert ttf.LN_EPS == 1e-6


def test_hazard_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    want = np.asarray(nn.gelu(jnp.asarray(x)))
    got = ttf.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4  # the test can tell the two apart


@pytest.mark.parametrize("offset", [0, 7, "per_row"])
def test_hazard_rotary_is_rotate_half_in_f32(offset):
    x = np.random.default_rng(2).standard_normal((2, 5, 3, 16)).astype(np.float32)
    off = np.array([2, 9], np.int32) if offset == "per_row" else offset
    want = np.asarray(jtf.apply_rotary(jnp.asarray(x), offset=jnp.asarray(off)))
    t_off = torch.from_numpy(off) if offset == "per_row" else off
    got = ttf.apply_rotary(torch.from_numpy(x), offset=t_off).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if offset == 7:
        # The interleaved-pair form rotates (x[2i], x[2i+1]); it must differ.
        half = 8
        ang = (7 + np.arange(5))[:, None] * 10000.0 ** (-np.arange(half) / half)
        c, s = np.cos(ang)[None, :, None], np.sin(ang)[None, :, None]
        ev, od = x[..., 0::2], x[..., 1::2]
        inter = np.stack([ev * c - od * s, ev * s + od * c], -1).reshape(x.shape)
        assert np.abs(inter - got).max() > 1e-2


def test_from_flax_keeps_qkv_head_major_columns():
    jm, params, tm, _ = _models("dense", "rotary", 1)
    sd = from_flax(jax.tree_util.tree_map(np.asarray, params))
    k = np.asarray(params["params"]["block0"]["qkv"]["kernel"])
    np.testing.assert_array_equal(sd["blocks.0.qkv.kernel"].numpy(), k)
    assert k.shape == (D, (H + 2 * 1) * (D // H))
    assert set(sd) == set(tm.state_dict())


def _copy_task_loss_jax(logits, tokens, half):
    # moolib_tpu/examples/lm.py's loss_fn, as written there.
    pred = logits[:, half - 1 : -1]
    tgt = tokens[:, half:]
    logp = jax.nn.log_softmax(pred.astype(jnp.float32), axis=-1)
    ll = jnp.take_along_axis(logp, tgt[..., None], axis=-1)[..., 0]
    return -ll.mean()


def _port_loss_and_grads(tm, tokens, half):
    from moolib_tpu_torch.examples.lm import copy_task_loss

    tm.zero_grad(set_to_none=True)
    t = torch.from_numpy(tokens)
    loss, _ = copy_task_loss(tm(t), t, half)
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in tm.named_parameters()}


@pytest.mark.parametrize("kv_heads", [None, 1])
@pytest.mark.parametrize("pos", ["learned", "rotary"])
@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_loss_and_every_gradient_match_jax(attention, pos, kv_heads):
    # lm.py's loss through both models from the same (converted) weights;
    # the JAX flash path runs its Pallas backward kernels in interpret mode.
    jm, params, tm, tokens = _models(attention, pos, kv_heads)
    half = T // 2
    want_loss, want_grads = jax.value_and_grad(
        lambda p: _copy_task_loss_jax(jm.apply(p, jnp.asarray(tokens)), jnp.asarray(tokens), half)
    )(params)
    want = from_flax(jax.tree_util.tree_map(np.asarray, want_grads))
    got_loss, got = _port_loss_and_grads(tm, tokens, half)
    np.testing.assert_allclose(got_loss, float(want_loss), rtol=1e-4, atol=1e-4)
    assert set(got) == set(want)
    for name, grad in got.items():
        np.testing.assert_allclose(grad.numpy(), want[name].numpy(), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


def _remat_model(remat, policy="full", attention="flash"):
    return ttf.TransformerLM(vocab_size=V, d_model=D, num_heads=H, num_layers=L, max_len=T,
                             attention=attention, dtype=torch.float32, remat=remat,
                             remat_policy=policy, device="cpu",
                             generator=torch.Generator().manual_seed(3))


@pytest.mark.parametrize("policy", ["full", "dots", "dots_no_batch"])
def test_remat_policies_match_no_remat(policy):
    tokens = np.random.default_rng(5).integers(0, V, (2, T)).astype(np.int32)
    l0, g0 = _port_loss_and_grads(_remat_model(False), tokens, T // 2)
    l1, g1 = _port_loss_and_grads(_remat_model(True, policy), tokens, T // 2)
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    for name in g0:
        np.testing.assert_allclose(g1[name].numpy(), g0[name].numpy(), rtol=2e-5, atol=2e-5,
                                   err_msg=name)


def test_remat_policies_save_what_they_name():
    # Count the matmuls the backward recomputes: "full" reruns every one,
    # "dots_no_batch" only the activation @ activation products (bmm),
    # "dots" none.  Then the policies really differ in what they save.
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountMatmuls(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {"mm": 0, "bmm": 0}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in ("mm", "addmm"):
                self.n["mm"] += 1
            elif name == "bmm":
                self.n["bmm"] += 1
            return func(*args, **(kwargs or {}))

    # Dense attention: its matmuls are visible to the policy.
    tokens = torch.from_numpy(np.random.default_rng(6).integers(0, V, (2, 32)))
    counts = {}
    for policy in ("none", "full", "dots", "dots_no_batch"):
        m = _remat_model(policy != "none", "full" if policy == "none" else policy, "dense")
        loss = m(tokens).sum()
        with CountMatmuls() as c:
            loss.backward()
        counts[policy] = c.n
    base = counts["none"]
    assert counts["dots"] == base
    assert counts["dots_no_batch"]["mm"] == base["mm"]
    assert counts["dots_no_batch"]["bmm"] > base["bmm"]
    assert counts["full"]["mm"] > base["mm"] and counts["full"]["bmm"] > base["bmm"]


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        _remat_model(False, "nope")
    assert ttf.REMAT_POLICIES == jtf.REMAT_POLICIES


def test_parameters_are_f32_and_bf16_logits_match_flax():
    cfg = dict(vocab_size=V, d_model=D, num_heads=H, num_layers=L, max_len=T,
               attention="dense", pos_embedding="learned")
    jm = jtf.TransformerLM(dtype=jnp.bfloat16, **cfg)
    tokens = np.random.default_rng(7).integers(0, V, (2, 64)).astype(np.int32)
    params = jm.init(jax.random.key(2), jnp.asarray(tokens))
    tm = ttf.TransformerLM(dtype=torch.bfloat16, device="cpu", **cfg)
    assert {p.dtype for p in tm.parameters()} == {torch.float32}
    sd = from_flax(jax.tree_util.tree_map(np.asarray, params))
    tm.load_state_dict(sd)
    # f32 parameters load without rounding.
    np.testing.assert_array_equal(tm.blocks[0].qkv.kernel.detach().numpy(),
                                  np.asarray(params["params"]["block0"]["qkv"]["kernel"]))
    want = np.asarray(jm.apply(params, jnp.asarray(tokens)))
    with torch.inference_mode():
        got = tm(torch.from_numpy(tokens)).numpy()
    assert got.dtype == np.float32
    # bf16 compute on both sides, rounded at the same points; the matmuls
    # sum in different orders, so logits of magnitude ~4 differ by up to a
    # few bf16 ulps (one ulp there is 1.6e-2; measured 2.0e-2).
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=0)


def test_features_path_is_ln_f_output():
    _, _, tm, tokens = _models("dense", "learned", None)
    with torch.inference_mode():
        t = torch.from_numpy(tokens)
        feats = tm(t, return_features=True)
        logits, head = tm(t), tm.lm_head(feats)
    assert feats.dtype == torch.float32 and feats.shape == (2, T, D)
    torch.testing.assert_close(head, logits, rtol=0, atol=0)


def test_cast_weights_once_gives_the_per_call_numbers():
    tm = ttf.TransformerLM(vocab_size=V, d_model=D, num_heads=H, num_layers=L, max_len=T,
                           attention="dense", dtype=torch.bfloat16, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(8).integers(0, V, (2, 16)))
    with torch.inference_mode():
        per_call = tm(tokens)
        with ttf.cast_weights_once(tm):
            assert tm.blocks[0].qkv.cast[0].dtype == torch.bfloat16
            once = tm(tokens)
    torch.testing.assert_close(once, per_call, rtol=0, atol=0)
    assert all(m.cast is None for m in tm.modules() if isinstance(m, (ttf.Dense, ttf.Embed)))
