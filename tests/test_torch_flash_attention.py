"""Parity of the port's flash attention with the JAX package's.

Inputs come from numpy with a seed and go through both packages.  On the
CPU the port runs its plain version (the CUDA kernel needs the card; it is
held against the same plain version by chip_smoke.py), and the JAX side runs
the Pallas kernel in interpret mode, as the JAX suite does.
"""

import importlib

import numpy as np
import pytest
import torch

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
    with pytest.raises(ValueError, match="shape mismatch"):
        fa.flash_attention(q, torch.zeros(1, 4, 2, 32), torch.zeros(1, 4, 2, 32))


def test_kernel_backward_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="slice 2"):
        fa._FlashFwd.backward(None, None, None)
