"""Parity of the port's flash attention with the JAX package's.

Inputs come from numpy with a seed and go through both packages, forward
and backward.  On the CPU the port's autograd node runs its plain versions
(the CUDA kernels need the card; they are held against the same plain
versions by chip_smoke.py), and the JAX side runs the Pallas kernels in
interpret mode, as the JAX suite does.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from moolib_tpu.ops.flash_attention import flash_attention as jax_flash
from moolib_tpu_torch.ops import flash_attention as fa
from moolib_tpu_torch.parallel import ring_attention as ring

# moolib_tpu.parallel re-exports a *function* named ring_attention.
jax_ring = importlib.import_module("moolib_tpu.parallel.ring_attention")

torch.set_num_threads(1)

ATOL = 2e-5  # f32 on both sides; blockwise vs blockwise summation order


def _qkv(seed, B=2, T=128, H=2, D=32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H, D)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [128, 256])
def test_plain_version_matches_jax_flash_out_and_lse(T, causal):
    q, k, v = _qkv(T + causal, T=T)
    j_out, j_lse = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, return_lse=True)
    j_only = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    t_out, t_lse = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), causal=causal, return_lse=True)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=ATOL, rtol=0)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), atol=ATOL, rtol=0)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_only), atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_tail_shape_matches_jax_dense_path(causal):
    # T=200 has no 128-multiple divisor: JAX takes its dense path, the port
    # masks a short last tile.
    q, k, v = _qkv(7, T=200)
    j_out, j_lse = jax_ring.dense_attention_lse(jnp.asarray(q), jnp.asarray(k),
                                                jnp.asarray(v), causal=causal)
    t_out, t_lse = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), causal=causal, return_lse=True)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=ATOL, rtol=0)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_dense_attention_lse_matches_jax(causal):
    q, k, v = _qkv(3, T=40)
    j_out, j_lse = jax_ring.dense_attention_lse(jnp.asarray(q), jnp.asarray(k),
                                                jnp.asarray(v), causal=causal)
    t_out, t_lse = ring.dense_attention_lse(torch.from_numpy(q), torch.from_numpy(k),
                                            torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=1e-5, rtol=0)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), atol=1e-5, rtol=0)


def test_online_softmax_update_matches_jax():
    rng = np.random.default_rng(11)
    B, H, Q, K, D = 2, 2, 8, 16, 4
    s = rng.standard_normal((B, H, Q, K)).astype(np.float32)
    s[:, :, 0, :] = -1e30  # a fully-masked row stays at zero weight
    v = rng.standard_normal((B, K, H, D)).astype(np.float32)
    acc = rng.standard_normal((B, H, Q, D)).astype(np.float32)
    l = rng.random((B, H, Q)).astype(np.float32)
    m = rng.standard_normal((B, H, Q)).astype(np.float32)
    want = jax_ring.online_softmax_update(*map(jnp.asarray, (s, v, acc, l, m)),
                                          zero_masked_rows=True)
    got = ring.online_softmax_update(*map(torch.from_numpy, (s, v, acc, l, m)),
                                     zero_masked_rows=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6)


def test_cpu_path_launches_no_kernel():
    q, k, v = map(torch.from_numpy, _qkv(5, T=64))
    before = fa.flash_fwd_launches()
    fa.flash_attention(q, k, v)
    assert fa.flash_fwd_launches() == before


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    # The checks run before any build or launch, so they show without a card.
    q = torch.zeros(1, 4, 1, 32)
    with pytest.raises(ValueError, match="head dims"):
        fa._flash_fwd_cuda(q, q, q, True)
    h = torch.zeros(1, 4, 1, 64, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa._flash_fwd_cuda(h, h, h, True)
    with pytest.raises(ValueError, match="head dims"):
        fa._flash_bwd_cuda(q, q, q, q, q[..., 0], q, None, True)
    with pytest.raises(ValueError, match="shape mismatch"):
        fa.flash_attention(q, torch.zeros(1, 4, 2, 32), torch.zeros(1, 4, 2, 32))


def _jax_grads(q, k, v, g, g_lse, causal, fn):
    """jax.vjp of ``fn`` (the JAX package's flash_attention, or its dense
    path): (dq, dk, dv) as numpy."""
    args = [jnp.asarray(x) for x in (q, k, v)]
    if g_lse is None:
        _, vjp = jax.vjp(lambda q_, k_, v_: fn(q_, k_, v_, causal), *args)
        return [np.asarray(x) for x in vjp(jnp.asarray(g))]
    _, vjp = jax.vjp(lambda q_, k_, v_: fn(q_, k_, v_, causal, True), *args)
    return [np.asarray(x) for x in vjp((jnp.asarray(g), jnp.asarray(g_lse)))]


def _jax_flash(q, k, v, causal, return_lse=False):
    return jax_flash(q, k, v, causal=causal, return_lse=return_lse)


def _jax_dense(q, k, v, causal, return_lse=False):
    out, lse = jax_ring.dense_attention_lse(q, k, v, causal=causal)
    return (out, lse) if return_lse else out


def _cotangents(seed, q, with_lse):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(q.shape).astype(np.float32)
    g_lse = rng.standard_normal(q.shape[:3]).astype(np.float32) if with_lse else None
    return g, g_lse


def _port_grads(q, k, v, g, g_lse, causal):
    """Gradients through the port's autograd node (_Flash on the CPU)."""
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = fa.flash_attention(tq, tk, tv, causal=causal, return_lse=True)
    obj = (out * torch.from_numpy(g)).sum()
    if g_lse is not None:
        obj = obj + (lse * torch.from_numpy(g_lse)).sum()
    obj.backward()
    return [x.grad.numpy() for x in (tq, tk, tv)]


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [128, 256])
def test_flash_gradients_match_jax_vjp(T, causal, with_lse):
    # The JAX side runs its Pallas backward kernels in interpret mode.
    q, k, v = _qkv(20 + T + causal, T=T)
    g, g_lse = _cotangents(T + 2 * causal + with_lse, q, with_lse)
    want = _jax_grads(q, k, v, g, g_lse, causal, _jax_flash)
    got = _port_grads(q, k, v, g, g_lse, causal)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_tail_shape_gradients_match_jax_dense_path(causal, with_lse):
    # T=200: JAX takes its dense path; the port's backward masks a short
    # last K/V block.
    q, k, v = _qkv(30 + causal, T=200)
    g, g_lse = _cotangents(40 + causal + 2 * with_lse, q, with_lse)
    want = _jax_grads(q, k, v, g, g_lse, causal, _jax_dense)
    got = _port_grads(q, k, v, g, g_lse, causal)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [128, 200])
def test_plain_backward_called_directly_matches_jax(T, causal):
    q, k, v = _qkv(50 + T + causal, T=T)
    g, g_lse = _cotangents(60 + T + causal, q, True)
    fn = _jax_flash if T % 128 == 0 else _jax_dense
    want = _jax_grads(q, k, v, g, g_lse, causal, fn)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = fa._blockwise_attention_plain(tq, tk, tv, causal)
    got = fa._flash_backward_plain(tq, tk, tv, out, lse, torch.from_numpy(g),
                                   torch.from_numpy(g_lse), causal)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4, rtol=0, err_msg=f"d{name}")


def test_unused_lse_reaches_backward_as_none(monkeypatch):
    # set_materialize_grads(False): with the lse unused, the backward gets
    # None and builds no zero cotangent (the JAX split into _flash/_flash_lse).
    seen = []
    real = fa._flash_backward_plain

    def spy(q, k, v, out, lse, g, g_lse, causal):
        seen.append(g_lse)
        return real(q, k, v, out, lse, g, g_lse, causal)

    monkeypatch.setattr(fa, "_flash_backward_plain", spy)
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(9, T=64))
    fa.flash_attention(q, k, v).sum().backward()
    assert seen == [None] and q.grad is not None


def test_cpu_backward_launches_no_kernel():
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(8, T=64))
    fa.reset_launches()
    fa.flash_attention(q, k, v).sum().backward()
    assert (fa.flash_fwd_launches(), fa.flash_bwd_dq_launches(),
            fa.flash_bwd_dkv_launches()) == (0, 0, 0)
